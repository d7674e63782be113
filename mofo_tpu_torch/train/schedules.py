"""Per-step LR / weight-decay schedules.

cosine_schedule is numerically identical to the reference cosine_scheduler
(utils.py:391-408): linear warmup over warmup_epochs*niter_per_ep steps
(np.linspace includes both endpoints), then a half-cosine from base to
final over the remaining steps. The reference mutates optimizer param
groups from this array every step (engine_for_pretraining.py:30-37); here
the train step indexes the array with its step counter
(mofo_tpu_torch/train/pretrain_step.py). A copy of
mofo_tpu/train/schedules.py.
"""

from __future__ import annotations

import math

import numpy as np


def cosine_schedule(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
    warmup_steps: int = -1,
) -> np.ndarray:
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup = (
        np.linspace(start_warmup_value, base_value, warmup_iters)
        if warmup_epochs > 0
        else np.array([])
    )
    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    main = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(math.pi * iters / n)
    )
    schedule = np.concatenate([warmup, main])
    assert len(schedule) == epochs * niter_per_ep
    return schedule.astype(np.float32)


def scaled_lr(base_lr: float, total_batch_size: int) -> float:
    """Linear LR scaling rule: lr * total_batch/256
    (run_mae_pretraining.py:217-219)."""
    return base_lr * total_batch_size / 256.0
