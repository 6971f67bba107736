"""Kernel launch calls on the host per request in the traced window."""

from benchmark.trace import launches_in_window


def read(rec):
    n = launches_in_window(rec)
    return n / rec['n'] if n and rec['n'] else None
