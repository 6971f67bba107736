"""GB of 3x3 im2col patches that the int8 walk writes per request: the
program's ``int8.im2col_bytes`` counter (``compress/quantized.py``) over
the ``predict.request`` spans of the traced window. None where the
program records no such counter."""


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    r = tracing.records()
    n = sum(1 for s in r['spans'] if s[0] == 'predict.request' and s[2] is not None
            and w0 <= s[1] <= w1)
    patch = r['counters'].get('int8.im2col_bytes')
    return patch / 1e9 / n if n and patch else None
