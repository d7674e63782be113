"""Typed configuration dataclasses for pretraining.

A copy of mofo_tpu/core/config.py's MaskingConfig, OptimizerConfig and
PretrainConfig (knob names and defaults mirror the reference argparse
surfaces, run_mae_pretraining.py:22-132 and run_mae_pretraining_BB.py).
The port runs on one device and has no mesh, so PretrainConfig has no
`mesh` field; finetuning's config comes with the finetune port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class MaskingConfig:
    mask_type: str = "tube"  # tube | tube_bb
    mask_ratio: float = 0.9
    mask_ratio_bb: float = 0.75  # run_mae_pretraining_BB.py:40-41
    bug_compat: bool = False  # reproduce reference quirks (SURVEY.md 2.2)
    box_reduce: str = "first"


@dataclasses.dataclass
class OptimizerConfig:
    opt: str = "adamw"
    lr: float = 1.5e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_epochs: int = 40
    warmup_steps: int = -1
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    opt_betas: Tuple[float, float] = (0.9, 0.95)  # pretrain default
    opt_eps: float = 1e-8
    momentum: float = 0.9
    clip_grad: Optional[float] = None
    layer_decay: Optional[float] = None  # finetune: 0.75
    scale_lr: bool = True  # lr * total_batch/256


@dataclasses.dataclass
class PretrainConfig:
    model: str = "pretrain_videomae_base_patch16_224"
    decoder_depth: int = 4  # run_mae_pretraining.py:32
    input_size: int = 224
    num_frames: int = 16
    tubelet_size: int = 2
    patch_size: int = 16
    drop_path: float = 0.0
    normalize_target: bool = True
    batch_size: int = 12  # per device
    epochs: int = 800
    save_ckpt_freq: int = 50
    update_freq: int = 1
    seed: int = 0
    dtype: str = "bfloat16"
    masking: MaskingConfig = dataclasses.field(default_factory=MaskingConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )
    # MOFO gradual loss weighting (run_mae_pretraining_BB.py:262: the
    # intended in-box loss upweighting, linearly annealed 1 -> 0).
    motion_loss_weight: bool = False

    @property
    def window_size(self) -> Tuple[int, int, int]:
        return (
            self.num_frames // self.tubelet_size,
            self.input_size // self.patch_size,
            self.input_size // self.patch_size,
        )

    @property
    def patches_per_frame(self) -> int:
        s = self.input_size // self.patch_size
        return s * s

    @property
    def num_tokens(self) -> int:
        return self.window_size[0] * self.patches_per_frame

    @property
    def num_masked(self) -> int:
        return self.window_size[0] * int(
            self.masking.mask_ratio * self.patches_per_frame
        )
