"""Device ms per request of the copies and kernels that the host launched
inside the program's ``predict.upload`` spans (the pageable copy of the
host batch and its shapes), over the ``predict.request`` spans of the
traced window. None where the program records no spans."""

from benchmark.trace import in_spans


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    spans = [s for s in tracing.records()['spans'] if s[2] is not None and w0 <= s[1] <= w1]
    ups = sorted((s, e) for n, s, e, _, _ in spans if n == 'predict.upload')
    n = sum(1 for s in spans if s[0] == 'predict.request')
    if not ups or not n:
        return None
    starts = [s for s, _ in ups]
    t = sum(e - s for _, s, e, at in rec['device'] if in_spans(at, ups, starts) >= 0)
    return t / 1e6 / n
