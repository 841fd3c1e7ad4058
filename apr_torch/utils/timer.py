"""Wall-clock meters, API-compatible with the reference
(FCGF_APR/lib/timer.py:5-76; Predator_APR/lib/timer.py identical), less
its ``MinTimer``, which nothing reads."""

from __future__ import annotations

import time


class AverageMeter:
    """Running average + variance of a scalar series."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val * val * n

    @property
    def var(self):
        if self.count == 0:
            return 0.0
        return self.sq_sum / self.count - self.avg * self.avg


class Timer:
    """tic/toc accumulator; toc(average=True) returns the running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True, accumulate: bool = False):
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        if not accumulate:
            self.calls += 1
            self.avg = self.total_time / max(self.calls, 1)
        return self.avg if average else self.diff

    def incCount(self):
        self.calls += 1
        self.avg = self.total_time / max(self.calls, 1)
