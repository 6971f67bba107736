"""% of its roofline that the int8 1x1 kernel reaches: the least time of
the convs routed to it (``counts.qconv1x1_bound_s`` at the traffic's size
and batch, each conv counted at its cfg layer's own work, each launch one
conv of a forward) over its summed device time."""

from benchmark import counts


def read(rec):
    ks = [(e - s) for name, s, e, _ in rec['device'] if 'qconv1x1' in name]
    lays, t = rec['layers'], rec['traffic']
    per = len(counts.qconv1x1_convs(lays))
    if not ks or not per:
        return None
    per_forward = counts.qconv1x1_bound_s(lays, t['size'], t['batch'])
    return 100.0 * per_forward * len(ks) / per / (sum(ks) / 1e9)
