"""Small host-side meters (the port of ``pqdet_tpu/utils/meters.py``, the
parts the trainer reads)."""

from __future__ import annotations

import time


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += value
        self.count += n

    def get_avg_reset(self) -> float:
        if self.count == 0:
            return 0.0
        avg = float(self.sum) / float(self.count)
        self.reset()
        return avg


class TicToc:
    """Nanosecond wall timer that sums its intervals."""

    def __init__(self):
        self.last = 0
        self.records = []

    def tic(self):
        self.last = time.perf_counter_ns()

    def toc(self):
        self.records.append(time.perf_counter_ns() - self.last)

    def sum_reset(self) -> float:
        s = float(sum(self.records))
        self.records.clear()
        return s
