"""Device ms per request of the kernels that the host launched inside the
program's ``int8.sandwich`` spans (``compress/quantized.py``: the input's
quantisation, and each shortcut's, route's, pool's and scale's dequant, f32
op and requant, and each f32 conv output's requant), over the
``predict.request`` spans of the traced window. None where the program
records no such spans."""

from benchmark.trace import in_spans


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    spans = [s for s in tracing.records()['spans'] if s[2] is not None and w0 <= s[1] <= w1]
    inside = sorted((s, e) for n, s, e, _, _ in spans if n == 'int8.sandwich')
    n = sum(1 for s in spans if s[0] == 'predict.request')
    if not inside or not n:
        return None
    starts = [s for s, _ in inside]
    t = sum(e - s for _, s, e, at in rec['device'] if in_spans(at, inside, starts) >= 0)
    return t / 1e6 / n
