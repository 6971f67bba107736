"""Device ms of the forward per request: the kernels that the host launched
inside the ``serve.forward`` spans, their durations summed, over the
requests of the traced window."""

from benchmark.trace import in_spans


def read(rec):
    spans = sorted(rec['spans'].get('serve.forward', []))
    if not spans or not rec['n']:
        return None
    starts = [s for s, _ in spans]
    t = sum(e - s for _, s, e, at in rec['device'] if in_spans(at, spans, starts) >= 0)
    return t / 1e6 / rec['n'] if t else None
