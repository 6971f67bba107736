"""% of the traced window's device idle whose gap began with no program
span open, or only the root ``step``: the idle that the ``step.*`` spans of
``train/step.py`` leave unexplained. None where the program records no
spans."""

from benchmark.trace import busy_intervals


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.records()['spans']
    if not any(s[0] == 'step' for s in spans):
        return None
    w0, w1 = rec['window']
    gaps, prev = [], w0
    for s, t in busy_intervals(rec) + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    total = sum(t - s for s, t in gaps)
    if not total:
        return None
    at = tracing.innermost(spans, [g[0] for g in gaps])
    out = sum(t - s for (s, t), i in zip(gaps, at) if i < 0 or spans[i][3] is None)
    return 100.0 * out / total
