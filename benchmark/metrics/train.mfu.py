"""% of the bf16 peak that the stepped images' needed operations fill over the
window run with the profiler off before the traced one (the profiler slows
the host): three times the forward's (``counts.forward_ops`` at the
traffic's size), for the forward and the two products of the backward."""

from benchmark import counts
from benchmark.trace import busy_s


def read(rec):
    u, t = rec['untraced'], rec['traffic']
    if not u or not u['images'] or busy_s(rec) <= 0:
        return None
    ops = 3 * counts.forward_ops(rec['layers'], t['size']) * u['images']
    return 100.0 * ops / u['wall_s'] / counts.PEAK[t['precision']]
