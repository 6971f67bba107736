"""Spans around the program's layers, the profiler's device trace, and the
reduction of both to the record that the per-layer metrics read.

A span is a ``torch.profiler.record_function`` named ``bench.<what>``,
opened in the benchmark's own files around a call into one of the
program's layers. The record holds, in the profiler's nanoseconds:

- ``window``: (start, end) of the measured window;
- ``spans``: {name: [(start, end), ...]} of the host spans;
- ``device``: [(name, start, end, launch)] of every kernel, copy and memset
  on the card, ``launch`` the host time of the API call that issued it
  (None where the trace links none);
- ``launches``: host times of the kernel launch calls
  (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
  ``cuLaunchKernelEx``).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx')
PREFIX = 'bench.'


class Tracer:
    """Spans and the profiler, or nothing at all when ``enabled`` is False."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(PREFIX + name)

    def wrap(self, name: str, fn):
        """``fn`` inside a span ``name`` on every call: the same wrapper in
        every run, the span open only in a traced one."""
        def inner(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return inner

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def record(self) -> Dict:
        return reduce_events(self.prof.profiler.kineto_results.events())


def reduce_events(events) -> Dict:
    """The record (module docstring) of the profiler's raw events."""
    from torch.autograd import DeviceType
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    runtime_at: Dict[int, int] = {}
    op_at: Dict[int, int] = {}
    launches: List[int] = []
    device = []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX):     # the spans' own ranges on the device's timeline
                continue
            device.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans[name[len(PREFIX):]].append((start, end))
        elif name.startswith('cu'):
            runtime_at[e.correlation_id()] = start
            if name in LAUNCH_CALLS:
                launches.append(start)
        elif e.linked_correlation_id() == 0:
            op_at[e.correlation_id()] = start
    dev = []
    for name, s, t, corr, linked in device:
        at = runtime_at.get(corr)
        if at is None:
            at = op_at.get(linked)
        dev.append((name, s, t, at))
    dev.sort(key=lambda d: d[1])
    launches.sort()
    window = spans.pop('window', [(0, 0)])[0]
    return {'window': window, 'spans': dict(spans), 'device': dev, 'launches': launches}


def busy_intervals(rec: Dict) -> List[Tuple[int, int]]:
    """The union of the device's activity inside the window, merged."""
    w0, w1 = rec['window']
    out: List[List[int]] = []
    for _, s, t, _ in rec['device']:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(rec: Dict) -> float:
    return sum(t - s for s, t in busy_intervals(rec)) / 1e9


def window_s(rec: Dict) -> float:
    return (rec['window'][1] - rec['window'][0]) / 1e9


def launches_in_window(rec: Dict) -> int:
    w0, w1 = rec['window']
    return bisect.bisect_right(rec['launches'], w1) - bisect.bisect_left(rec['launches'], w0)


def in_spans(t: Optional[int], spans: List[Tuple[int, int]], starts: List[int]) -> int:
    """Index of the span of ``spans`` (sorted, disjoint) holding ``t``, or -1."""
    if t is None:
        return -1
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t <= spans[i][1] else -1


def host_span_at(spans: Dict, starts: Dict, t: int) -> str:
    """The innermost span open on the host at ``t`` (the latest to start)."""
    best, name = -1, 'window'
    for n, sp in spans.items():
        i = in_spans(t, sp, starts[n])
        if i >= 0 and sp[i][0] > best:
            best, name = sp[i][0], n
    return name


def breakdown(rec: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the device's idle time
    inside the window summed by the span the host was in when each gap
    began."""
    by_op: Dict[str, float] = defaultdict(float)
    w0, w1 = rec['window']
    for name, s, t, _ in rec['device']:
        if s < w1 and t > w0:
            by_op[name] += (min(t, w1) - max(s, w0)) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    spans = {n: sorted(sp) for n, sp in rec['spans'].items()}
    starts = {n: [s for s, _ in sp] for n, sp in spans.items()}
    prev = w0
    for s, t in busy_intervals(rec) + [(w1, w1)]:
        if s > prev:
            idle[host_span_at(spans, starts, prev)] += (s - prev) / 1e9
        prev = max(prev, t)
    def rank(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {'device_ops': rank(by_op), 'idle_gaps': rank(idle)}
