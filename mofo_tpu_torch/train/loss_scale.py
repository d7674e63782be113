"""Dynamic loss scaling for fp16 finetuning.

Counterpart of mofo_tpu/train/loss_scale.py: the reference finetunes under
DeepSpeed's fp16 engine with dynamic loss scaling (initial_scale_power 7 =>
128, loss_scale_window 128; utils.py:499-528). The step scales the loss
before the backward pass and unscales the gradients in f32; on non-finite
gradients it skips the update and backs the scale off by half (not below
1); after `growth_interval` good steps in a row it doubles the scale. The
scale is kept on the host: the step reads the finiteness of the gradient
norm once (mofo_tpu/train/finetune_step.py:108-199).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    scale: float
    good_steps: int = 0
    growth_interval: int = 128

    @classmethod
    def create(cls, initial_scale_power: int = 7,
               growth_interval: int = 128) -> "DynamicLossScale":
        return cls(scale=2.0 ** initial_scale_power,
                   growth_interval=growth_interval)

    def update(self, grads_finite: bool) -> "DynamicLossScale":
        """The state after a step whose gradients were (or were not)
        finite."""
        if not grads_finite:
            return dataclasses.replace(self, scale=max(self.scale * 0.5, 1.0),
                                       good_steps=0)
        good = self.good_steps + 1
        if good >= self.growth_interval:
            return dataclasses.replace(self, scale=self.scale * 2.0,
                                       good_steps=0)
        return dataclasses.replace(self, good_steps=good)


def apply_if_finite(new: Dict[str, torch.Tensor],
                    old: Dict[str, torch.Tensor],
                    finite) -> Dict[str, torch.Tensor]:
    """`new` where the gradients were finite, else `old`, entry by entry
    (`finite` a bool or a 0-dim bool tensor)."""
    finite = torch.as_tensor(finite)
    return {n: torch.where(finite.to(v.device), v, old[n])
            for n, v in new.items()}
