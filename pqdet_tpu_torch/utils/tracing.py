"""Spans and counters of the program, recorded only while a
``torch.profiler`` session runs in this process.

``span(name)`` is a context manager around one stage of the work;
``count(name, n)`` adds to a counter. With no profiler running a span is
a shared null context: a root span (one opened with no span open above
it) checks the profiler's own flag, an inner span or a counter one bool
of this module. So the stages can stay marked on the serving and
training paths at the cost of a bool check.

While a session runs, each span is stamped on the clock of the
profiler's host events (``CLOCK``: ``time.time_ns``, the wall clock that
the profiler converts its host and device events to), so a span lies
around the kernel launches it issued in the profiler's trace. Nothing of
this module reaches the profiler's device timeline: no
``record_function``, no NVTX. ``utils/profiling.py::trace`` merges the
spans into the Chrome trace it writes, on a row of their own.

The spans stay in memory, at most ``CAP`` of them (the rest are counted in
``tracing.dropped``). The first root span of a new session clears them,
as ``clear`` does; ``records`` reads them without clearing. The counters
count only while a recorded span is open. One thread records: the spans
of the serving and training paths open on the caller's thread.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Dict, List, Sequence

import torch.autograd.profiler as _profiler

CLOCK = time.time_ns
CAP = 1 << 20

_NULL = nullcontext()
_spans: List[list] = []             # [name, start_ns, end_ns, parent, root] in opening order
_counts: Dict[str, int] = defaultdict(int)
_open: List[int] = []               # indices of the open spans, the innermost last
_session = False                    # the last root span found a session running


class _Span:
    __slots__ = ('i',)

    def __init__(self, name: str):
        self.i = len(_spans)
        parent = _open[-1] if _open else None
        _spans.append([name, 0, None, parent, self.i if parent is None else _spans[parent][4]])

    def __enter__(self):
        _open.append(self.i)
        _spans[self.i][1] = CLOCK()

    def __exit__(self, *exc):
        _spans[self.i][2] = CLOCK()
        _open.pop()


def span(name: str):
    """A context manager that records ``name`` from entry to exit while a
    profiler session runs, and does nothing otherwise."""
    global _session
    if not _open:
        if not _profiler._is_profiler_enabled:
            _session = False
            return _NULL
        if not _session:            # a new session: its spans alone
            clear()
            _session = True
    if len(_spans) >= CAP:
        _counts['tracing.dropped'] += 1
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while a recorded span is open."""
    if _open:
        _counts[name] += n


def clear():
    """Forget the recorded spans and counters."""
    _spans.clear()
    _counts.clear()


def records() -> Dict:
    """``{'spans': [(name, start_ns, end_ns, parent, root)], 'counters':
    {name: n}}`` of the current or the last session. Spans are in opening
    order; ``parent`` is the index of the enclosing span (None for a root),
    ``root`` the index of the root span that every span of one request or
    one step shares; ``end_ns`` is None while a span is open."""
    return {'spans': [tuple(s) for s in _spans], 'counters': dict(_counts)}


def innermost(spans: Sequence[tuple], times: Sequence[int]) -> List[int]:
    """For each of ``times`` (ns, ascending), the index into ``spans`` (as
    ``records`` gives them) of the innermost closed span open at that time,
    or -1 where none is."""
    order = sorted((i for i, s in enumerate(spans) if s[2] is not None),
                   key=lambda i: spans[i][1])
    starts = [spans[i][1] for i in order]
    out, stack, k = [], [], 0
    for t in times:
        hi = bisect.bisect_right(starts, t)
        while k < hi:               # spans nest: an opened span closes the ones that ended
            i = order[k]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out
