"""% of the device's peak for the cell's precision that the served images'
needed operations (the cfg's convs, ``counts.forward_ops`` at the traffic's
size) fill over the window run with the profiler off just before the
traced one (the profiler slows the host)."""

from benchmark import counts
from benchmark.trace import busy_s


def read(rec):
    u, t = rec['untraced'], rec['traffic']
    if not u or not u['images'] or busy_s(rec) <= 0:
        return None
    ops = counts.forward_ops(rec['layers'], t['size']) * u['images']
    return 100.0 * ops / u['wall_s'] / counts.PEAK[t['precision']]
