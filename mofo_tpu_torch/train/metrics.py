"""Metrics, console logging and the epoch logs of the runners.

Counterpart of mofo_tpu/train/metrics.py (reference utils.py:17-194):
  - SmoothedValue / MetricLogger: windowed meters (update_weighted counts
    a batch by its real rows) and `log_every` console lines with ETA and
    data / iteration time; the logger keeps the epoch's data-wait and
    iteration times (`data_time`, `iter_time`);
  - JsonlLogger: the rank-0 JSONL log.txt per epoch
    (run_mae_pretraining.py:289-293);
  - TensorboardLogger: per-step scalar heads, a no-op without tensorboardX
    or a log dir;
  - ThroughputMeter: step time, clips/s and MFU over the last 50 steps;
  - profile_trace(log_dir): a torch.profiler context (CPU and, on a card,
    CUDA activity) that writes a Chrome trace into log_dir.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.parallel import ddp


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

    def update_weighted(self, n: int, **kwargs):
        """update with a sample count, so that global_avg weights batches by
        their real (not padded) size."""
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v, n=max(int(n), 0) or 1)

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

    def epoch_stats(self, sync: bool = False,
                    group=None) -> Dict[str, float]:
        """Per-meter global averages. With `sync` and more than one process
        each meter's (total, count) is summed over the processes first (the
        reference's synchronize_between_processes all-reduce, utils.py:
        45-56; mofo_tpu/train/metrics.py:138-160), over a mesh's batch axis
        `group` only when given (a model peer's meters are its coordinate's
        own); every process must call it with the same meters."""
        size = (distributed.process_count() if group is None
                else group.size)
        if sync and size > 1:
            names = sorted(self.meters)
            local = torch.tensor([[self.meters[k].total, self.meters[k].count]
                                  for k in names], dtype=torch.float64)
            tot = ddp.all_reduce_sum(local, group).numpy()
            return {k: float(tot[i, 0] / max(tot[i, 1], 1.0))
                    for i, k in enumerate(names)}
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


class ThroughputMeter:
    """Step time, clips/s and MFU (absent from the reference)."""

    def __init__(self, batch_size: int, flops_per_step: float = 0.0,
                 peak_flops: float = 0.0):
        self.batch_size = batch_size
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.times = SmoothedValue(window_size=50)

    def update(self, step_seconds: float):
        self.times.update(step_seconds)

    @property
    def clips_per_sec(self) -> float:
        return self.batch_size / max(self.times.avg, 1e-9)

    @property
    def mfu(self) -> float:
        if not (self.flops_per_step and self.peak_flops):
            return 0.0
        return (self.flops_per_step / max(self.times.avg, 1e-9)
                / self.peak_flops)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Traces the body with torch.profiler (CPU activity, CUDA too when a
    card is present) and writes the Chrome trace to log_dir/trace.json;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
