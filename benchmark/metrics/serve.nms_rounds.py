"""Host reads of NMS's fixed-point loop per request (the program's
``nms.rounds`` counter, ``ops/postprocess.py``): each one waits for the
device. Over the ``predict.request`` spans of the traced session. None
where the program records no spans."""


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    r = tracing.records()
    n = sum(1 for s in r['spans'] if s[0] == 'predict.request' and s[2] is not None)
    rounds = r['counters'].get('nms.rounds')
    return rounds / n if n and rounds else None
