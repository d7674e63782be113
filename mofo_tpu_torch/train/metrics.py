"""Metrics, console logging and the epoch logs of the runners.

Counterpart of mofo_tpu/train/metrics.py (reference utils.py:17-194):
  - SmoothedValue / MetricLogger: windowed meters and `log_every` console
    lines with ETA and data / iteration time; the logger keeps the epoch's
    data-wait and iteration times (`data_time`, `iter_time`);
  - JsonlLogger: the rank-0 JSONL log.txt per epoch
    (run_mae_pretraining.py:289-293);
  - TensorboardLogger: per-step scalar heads, a no-op without tensorboardX
    or a log dir.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


class SmoothedValue:
    """A window of values and their global average (utils.py:17-86)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Console meter aggregation and timed iteration (utils.py:89-170)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn
        # seconds per step of the last log_every: waiting on the iterable,
        # and the whole iteration (wait + the loop body)
        self.data_time = SmoothedValue(fmt="{avg:.4f}")
        self.iter_time = SmoothedValue(fmt="{avg:.4f}")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = -1
        start = end = time.time()
        self.data_time = SmoothedValue(fmt="{avg:.4f}")
        self.iter_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            self.data_time.update(time.time() - end)
            yield obj
            self.iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                if total > 0:
                    eta = self.iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                else:
                    eta_str = "?"
                self.print(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                           f"time: {self.iter_time} data: {self.data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print(f"{header} Total time: "
                   f"{str(datetime.timedelta(seconds=int(elapsed)))} "
                   f"({elapsed / max(i, 1):.4f} s / it)")

    def epoch_stats(self) -> Dict[str, float]:
        """Per-meter global averages (one process: nothing to reduce)."""
        return {k: m.global_avg for k, m in self.meters.items()}


class JsonlLogger:
    """Rank-0 JSONL epoch log (log.txt convention,
    run_mae_pretraining.py:289-293)."""

    def __init__(self, output_dir: str, enabled: bool = True,
                 filename: str = "log.txt"):
        self.enabled = enabled and bool(output_dir)
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, filename)

    def write(self, stats: Dict):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


class TensorboardLogger:
    """Thin tensorboardX wrapper (utils.py:173-194); a no-op when the
    package or the log dir is absent."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(logdir=log_dir)
            except ImportError:
                pass

    def update(self, head: str, step: int, **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = float(v)
            self.writer.add_scalar(f"{head}/{k}", v, step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
