"""ms from the end of a request's forward on the device to its detections
on the host (recover, NMS with its host reads, the copy home), averaged over
the traced window's requests."""

from benchmark.trace import in_spans


def read(rec):
    fwd = sorted(rec['spans'].get('serve.forward', []))
    reqs = sorted(rec['spans'].get('serve.request', []))
    if not fwd or not reqs:
        return None
    starts = [s for s, _ in fwd]
    last = [0] * len(fwd)
    for _, _, e, at in rec['device']:
        i = in_spans(at, fwd, starts)
        if i >= 0:
            last[i] = max(last[i], e)
    gaps = []
    r_starts = [s for s, _ in reqs]
    for (s, _), end in zip(fwd, last):
        j = in_spans(s, reqs, r_starts)
        if j >= 0 and end:
            gaps.append(reqs[j][1] - end)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
