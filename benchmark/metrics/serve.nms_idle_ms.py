"""Device idle ms per request whose gap began while the program's
innermost open span was ``predict.nms`` (``ops/postprocess.py``: the device
drains at each of the fixed-point loop's host reads), over the
``predict.request`` spans of the traced window. None where the program
records no spans."""

from benchmark.trace import busy_intervals


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    spans = tracing.records()['spans']
    n = sum(1 for s in spans if s[0] == 'predict.request' and s[2] is not None
            and w0 <= s[1] <= w1)
    if not n:
        return None
    gaps, prev = [], w0
    for s, t in busy_intervals(rec) + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    at = tracing.innermost(spans, [g[0] for g in gaps])
    idle = sum(t - s for (s, t), i in zip(gaps, at) if i >= 0 and spans[i][0] == 'predict.nms')
    return idle / 1e6 / n
