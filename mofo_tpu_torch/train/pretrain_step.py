"""The MAE / MOFO pretraining step.

Counterpart of mofo_tpu/train/pretrain_step.py (make_pretrain_step,
:131-236): the tube or motion-box mask, one patchify_flat that feeds both
the patch embedding and the normalized-pixel targets, the model, the
(optionally motion-weighted) masked MSE, the backward pass, update_freq
gradient accumulation, the gradient norm and the AdamW update. The mask is
drawn from a torch.Generator on the step's device (the JAX step folds its
key with the step counter instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core.config import PretrainConfig
from mofo_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from mofo_tpu_torch.ops import masking, patchify
from mofo_tpu_torch.train.optim import global_norm
from mofo_tpu_torch.train.train_state import TrainState, ema_update

Batch = Dict[str, torch.Tensor]


def generate_mask(batch: Batch, cfg: PretrainConfig,
                  generator: Optional[torch.Generator] = None):
    """Mask for batch['clip'] (B, T, H, W, C); 'tube_bb' reads
    batch['boxes'] (B, T, 4)."""
    B = batch["clip"].shape[0]
    t, h, _ = cfg.window_size
    if cfg.masking.mask_type == "tube_bb":
        return masking.motion_tube_mask(
            batch["boxes"],
            temporal_positions=t,
            patches_per_side=h,
            patch_size=cfg.patch_size,
            mask_ratio=cfg.masking.mask_ratio,
            mask_ratio_bb=cfg.masking.mask_ratio_bb,
            bug_compat=cfg.masking.bug_compat,
            box_reduce=cfg.masking.box_reduce,
            generator=generator,
        )
    return masking.tube_mask(
        B,
        temporal_positions=t,
        patches_per_frame=cfg.patches_per_frame,
        mask_ratio=cfg.masking.mask_ratio,
        generator=generator,
        device=batch["clip"].device,
    )


def loss_for_batch(model: torch.nn.Module, batch: Batch,
                   mask: torch.Tensor, cfg: PretrainConfig,
                   loss_weight,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The reconstruction loss of one (micro)batch under a given mask;
    `generator` also draws the model's drop-path masks."""
    vis_idx, masked_idx = masking.mask_to_indices(mask, cfg.num_masked)
    bf16 = cfg.dtype == "bfloat16"
    clip = batch["clip"]
    tokens_pix = patchify.patchify_flat(
        clip.to(torch.bfloat16) if bf16 else clip,
        patch_size=cfg.patch_size, tubelet_size=cfg.tubelet_size,
    )
    with torch.no_grad():
        targets = patchify.masked_normalized_targets(
            tokens_pix, masked_idx,
            normalize_target=cfg.normalize_target,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        )
    weights = None
    if cfg.motion_loss_weight and loss_weight is not None:
        # per masked token: 1 + w inside the motion box
        in_masked = masking.tokens_in_box(
            batch["boxes"], masked_idx,
            tubelet_size=cfg.tubelet_size,
            patches_per_side=cfg.input_size // cfg.patch_size,
            patch_size=cfg.patch_size,
        ).to(torch.float32)
        weights = 1.0 + loss_weight * in_masked
    pred = model(tokens_pix, vis_idx, masked_idx, generator)
    return patchify.masked_mse_loss(pred, targets, weights=weights)


def make_pretrain_step(
    model: torch.nn.Module,
    tx,
    cfg: PretrainConfig,
    lr_schedule: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    augment_fn: Optional[Callable[[Optional[torch.Generator], Batch],
                                  Batch]] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step_fn(state, batch, generator, loss_weight, mask=None) ->
    (state, metrics).

    The step runs on `device` (CUDA unless the caller passes "cpu"; raises
    without a GPU), where the model must already be. batch['clip'] (B, T,
    H, W, C) holds normalized clips and, for motion masking, batch['boxes']
    (B, T, 4) — or raw decoded uint8 frames when augment_fn is given:
    augment_fn(generator, batch) -> batch runs first, inside the step, on
    the step's device (mofo_tpu/train/pretrain_step.py:136, 158-160). With
    update_freq > 1, B must divide into that many microbatches.
    `generator` (on the step's device) draws the augmentation, then the
    masks (and drop path, which pretraining runs at rate 0);
    `mask` (B, N) bool replaces the draw, for tests. loss_weight is the
    MOFO in-box weight (0.0 if unused). Metrics: loss, grad_norm and, with
    a schedule, lr — tensors left on the device.
    """
    dev = resolve_device(device)
    mdev = device_of(model)
    if mdev is None or mdev.type != dev.type or (
        dev.index is not None and mdev.index != dev.index
    ):
        raise ValueError(f"the model is on {mdev}, the step on {dev}")
    k = cfg.update_freq

    def step_fn(state: TrainState, batch: Batch,
                generator: Optional[torch.Generator], loss_weight,
                mask: Optional[torch.Tensor] = None):
        model.train()
        if augment_fn is not None:
            batch = augment_fn(generator, batch)
        B = batch["clip"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} micro")
        mb = B // k
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            micro = {n: v[i * mb:(i + 1) * mb] for n, v in batch.items()}
            m = (generate_mask(micro, cfg, generator) if mask is None
                 else mask[i * mb:(i + 1) * mb])
            loss = loss_for_batch(model, micro, m, cfg, loss_weight,
                                  generator)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = {n: p.grad for n, p in state.params.items()}
        if k > 1:
            grads = dict(zip(grads, torch._foreach_div(list(grads.values()),
                                                       k)))
        loss = loss_sum / k if k > 1 else loss_sum
        grad_norm = global_norm(grads.values())
        tx.update(grads, state.opt_state, state.params)
        if state.ema_params is not None:
            ema_update(state.ema_params, state.params, 0.9999)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        if lr_schedule is not None:
            metrics["lr"] = torch.tensor(
                float(lr_schedule[min(state.step, len(lr_schedule) - 1)]),
                device=dev,
            )
        state.step += 1
        return state, metrics

    return step_fn
