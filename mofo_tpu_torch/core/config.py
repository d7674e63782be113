"""Typed configuration dataclasses for pretraining and finetuning.

A copy of mofo_tpu/core/config.py's MaskingConfig, OptimizerConfig,
MeshSpec, PretrainConfig and FinetuneConfig (knob names and defaults mirror
the reference argparse surfaces, run_mae_pretraining.py:22-132,
run_mae_pretraining_BB.py and run_class_finetuning.py:31-214). `mesh` is
the run's (data, fsdp, model) mesh, data -1 for the processes that are
left (mofo_tpu/core/config.py:43-46, 69, 148); the runners resolve it at
the world size (parallel/mesh.py's MeshConfig.resolve).
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
class MeshSpec:
    data: int = -1
    fsdp: int = 1
    model: int = 1


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
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
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


@dataclasses.dataclass
class FinetuneConfig:
    """mofo_tpu/core/config.py:99-148 field for field."""

    model: str = "vit_base_patch16_224"
    nb_classes: int = 174
    input_size: int = 224
    num_frames: int = 16
    tubelet_size: int = 2
    patch_size: int = 16
    drop: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path: float = 0.1
    init_scale: float = 0.001
    use_mean_pooling: bool = True
    batch_size: int = 10
    epochs: int = 100
    update_freq: int = 1
    save_ckpt_freq: int = 10
    seed: int = 0
    dtype: str = "bfloat16"
    model_ema: bool = False
    model_ema_decay: float = 0.9999
    # augmentation (reference defaults, run_class_finetuning.py)
    color_jitter: float = 0.4
    aa: str = "rand-m7-n4-mstd0.5-inc1"
    smoothing: float = 0.1
    train_interpolation: str = "bicubic"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    mixup: float = 0.8
    cutmix: float = 1.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"
    # eval
    test_num_segment: int = 2
    test_num_crop: int = 3
    # MOFO finetune
    fusing_mode: str = "MCA"
    classtype: str = "action"  # EK: verb | noun | action
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(
            lr=5e-4,
            warmup_epochs=5,
            opt_betas=(0.9, 0.999),
            layer_decay=0.75,
            weight_decay=0.05,
        )
    )
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
