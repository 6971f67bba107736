"""Host ms per train step inside the program's ``step.update`` spans
(``Adam.update``, ``train/step.py``), over the ``step`` spans of the traced
window: the host's time under the profiler, which slows it. None where the
program records no spans."""

NAME = 'step.update'


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    spans = [s for s in tracing.records()['spans'] if s[2] is not None and w0 <= s[1] <= w1]
    n = sum(1 for s in spans if s[0] == 'step')
    t = sum(e - s for name, s, e, _, _ in spans if name == NAME)
    return t / 1e6 / n if n and t else None
