"""Logging and training metrics (copy of tspn_tpu/runtime/logging_utils.py).

A named logger (rank > 0 muted) writing to stdout and a timestamped
file; window-20 smoothed values with median and global average and a
NaN guard.
"""

from __future__ import annotations

import logging
import math
import os
import sys
import time
from collections import defaultdict, deque


def get_timestamp() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def setup_logger(
    name: str, save_dir: str = "logs", distributed_rank: int = 0, filename: str = None
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(save_dir, filename or f"{get_timestamp()}_{name}.txt")
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Window median + global average of a scalar series."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.series.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            v = float(v)
            if math.isnan(v):  # NaN guard
                continue
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter.median:.4f} ({meter.global_avg:.4f})"
            for name, meter in self.meters.items()
        )


def eta_string(step_time: float, cur_iter: int, max_iter: int) -> str:
    eta = step_time * max(max_iter - cur_iter - 1, 0)
    h, rem = divmod(int(eta), 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}"
