"""% of the traced window in which no kernel, copy or memset ran on the
device."""

from benchmark.trace import busy_s, window_s


def read(rec):
    w, b = window_s(rec), busy_s(rec)
    return 100.0 * (1.0 - b / w) if w > 0 and b > 0 else None
