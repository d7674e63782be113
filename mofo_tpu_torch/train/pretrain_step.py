"""The MAE / MOFO pretraining step.

Counterpart of mofo_tpu/train/pretrain_step.py (make_pretrain_step,
:131-236): the tube or motion-box mask, one patchify_flat that feeds both
the patch embedding and the normalized-pixel targets, the model, the
(optionally motion-weighted) masked MSE, the backward pass, update_freq
gradient accumulation, the gradient norm and the AdamW update. The mask is
drawn from a torch.Generator on the step's device (the JAX step folds its
key with the step counter instead).

A model wrapped by parallel.ddp.wrap_model trains data-parallel: every rank
runs this step on its local batch with the same generator state and
computes what one process computes on the global batch G' (parallel/ddp.py
states the contract). The augmentation, the masks and drop path draw the
global batch's draws (parallel.ddp.global_draws); microbatches 0..k-2
accumulate without DDP's reduction (no_sync), the last one reduces; the
motion-weighted loss divides by the global microbatch's weight sum and is
scaled by W, so that DDP's mean over the ranks gives mofo_tpu's global
ratio (mofo_tpu/ops/patchify.py:287-288); the loss metric is the mean over
the ranks. The gradient norm, the update and EMA then match on every rank.

A model sharded by parallel.mesh.shard_model trains on its mesh: the
ranks of a batch coordinate (parallel/mesh.py) hold that coordinate's rows
and draw as W = data * fsdp data-parallel ranks do (global_draws over the
batch axis); the model's forward and backward run the model and fsdp
axes' collectives; after the backward the gradients are reduced over the
batch axis (Sharding.reduce_grads), the motion weight sum and the loss
metric likewise, and the gradient norm and the optimizer's norms are taken
whole over each parameter's shards.

second_order (adahessian, mofo_tpu/train/pretrain_step.py:137-214) also
takes the Hutchinson probe z * Hz of the same stochastic loss (the same
mask and drop-path draws): each microbatch's gradient is taken once with
create_graph=True, and Hz is the gradient of sum <g, z> with z drawn from
the step's generator after the microbatch (train/optim.hutchinson_diag);
the probes are summed over the microbatches and divided by k, as the
gradients are. The model's attention must take the plain route
(attn_impl="xla"): the kernels' backwards are first-order only and raise.
A data-parallel second-order step differentiates the unwrapped module
(DistributedDataParallel supports no double backward, and
torch.autograd.grad bypasses its reducer) and averages the gradients and
the probes over the ranks itself (second_order_reduce); z is alike on every
rank because the generator is. A second-order step on a mesh differentiates
through the mesh's twice-differentiable collectives (parallel/
tensor_parallel.py); each rank draws z on the full shapes and keeps its
shards (optim.rademacher), and the gradients and the probes are reduced as
the first-order gradients are (Sharding.reduce_grads: the fsdp-sharded ones
over data, the others over the batch axis), never over the whole world,
whose model ranks hold different shards.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core.config import PretrainConfig
from mofo_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from mofo_tpu_torch.ops import masking, patchify
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.parallel.mesh import sharding_of
from mofo_tpu_torch.train.optim import (
    global_norm,
    hutchinson_diag,
    rademacher,
)
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
                   generator: Optional[torch.Generator] = None,
                   world: int = 1, group=None) -> torch.Tensor:
    """The reconstruction loss of one (micro)batch under a given mask;
    `generator` also draws the model's drop-path masks. With world > 1 (a
    data-parallel step) the motion-weighted loss takes the weight sum over
    the ranks (of a mesh's batch axis `group`) and is scaled by the world
    size, so that the ranks' mean is the global batch's loss."""
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
    if weights is None or world == 1:
        return patchify.masked_mse_loss(pred, targets, weights=weights)
    total = ddp.all_reduce_sum(weights.sum(dtype=torch.float32), group)
    return world * patchify.masked_mse_loss(pred, targets, weights=weights,
                                            weight_sum=total)


def grads_and_probe(loss: torch.Tensor, params: Dict[str, torch.Tensor],
                    z: Dict[str, torch.Tensor]):
    """The gradients of `loss` in `params` (detached) and the Hutchinson
    probe z * Hz of the same loss."""
    names = list(params)
    g = torch.autograd.grad(loss, [params[n] for n in names],
                            create_graph=True, allow_unused=True)
    g = {n: torch.zeros_like(params[n]) if t is None else t
         for n, t in zip(names, g)}
    hd = hutchinson_diag(lambda _: g, params, z=z)
    return {n: t.detach() for n, t in g.items()}, hd


def second_order_reduce(grads: Dict[str, torch.Tensor],
                        hess: Dict[str, torch.Tensor], world: int,
                        sharding=None) -> Tuple[Dict, Dict]:
    """The gradients and the probes (name -> tensor) averaged over the
    batch: on a mesh (`sharding`) by Sharding.reduce_grads, in place;
    otherwise the mean over the `world` data-parallel ranks (one flat
    all-reduce)."""
    if sharding is not None:
        sharding.reduce_grads(grads, hess)
        return grads, hess
    if world == 1:
        return grads, hess
    tensors = list(grads.values()) + list(hess.values())
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = ddp.all_reduce_sum(flat) / world
    parts = [c.view_as(t) for c, t in
             zip(flat.split([t.numel() for t in tensors]), tensors)]
    return (dict(zip(grads, parts[:len(grads)])),
            dict(zip(hess, parts[len(grads):])))


def make_pretrain_step(
    model: torch.nn.Module,
    tx,
    cfg: PretrainConfig,
    lr_schedule: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    augment_fn: Optional[Callable[[Optional[torch.Generator], Batch],
                                  Batch]] = None,
    second_order: bool = False,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step_fn(state, batch, generator, loss_weight, mask=None,
    probe_z=None) -> (state, metrics).

    The step runs on `device` (CUDA unless the caller passes "cpu"; raises
    without a GPU), where the model must already be. batch['clip'] (B, T,
    H, W, C) holds normalized clips and, for motion masking, batch['boxes']
    (B, T, 4) — or raw decoded uint8 frames when augment_fn is given:
    augment_fn(generator, batch) -> batch runs first, inside the step, on
    the step's device (mofo_tpu/train/pretrain_step.py:136, 158-160). With
    update_freq > 1, B must divide into that many microbatches.
    `generator` (on the step's device) draws the augmentation, then the
    masks (and drop path, which pretraining runs at rate 0);
    `mask` (B, N) bool replaces the draw, for tests (in a data-parallel
    step the rank's rows of G''s masks). `model` may be wrapped by
    parallel.ddp.wrap_model (see above). loss_weight is the
    MOFO in-box weight (0.0 if unused). With second_order the optimizer
    gets the Hutchinson probe (see above); `probe_z`, one name -> tensor
    dict per microbatch, replaces its draws, for tests. Metrics: loss,
    grad_norm and, with a schedule, lr — tensors left on the device.
    """
    dev = resolve_device(device)
    mdev = device_of(model)
    if mdev is None or mdev.type != dev.type or (
        dev.index is not None and mdev.index != dev.index
    ):
        raise ValueError(f"the model is on {mdev}, the step on {dev}")
    k = cfg.update_freq
    sharding, group = sharding_of(model), None
    if sharding is not None:
        group = sharding.mesh.batch
        rank, world = group.index, group.size
    else:
        rank, world = ddp.data_parallel(model) or (0, 1)
    wrapped = ddp.data_parallel(model) is not None

    net = ddp.unwrap(model) if second_order else model

    def step_fn(state: TrainState, batch: Batch,
                generator: Optional[torch.Generator], loss_weight,
                mask: Optional[torch.Tensor] = None, probe_z=None):
        model.train()
        if augment_fn is not None:
            with ddp.global_draws(rank, world, k, group):
                batch = augment_fn(generator, batch)
        B = batch["clip"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} micro")
        mb = B // k
        names = list(state.params)
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        acc = hess = None  # second order: summed gradients and probes
        for i in range(k):
            micro = {n: v[i * mb:(i + 1) * mb] for n, v in batch.items()}
            sync = not wrapped or i == k - 1 or second_order
            with ddp.global_draws(rank, world, 1, group), \
                    (contextlib.nullcontext() if sync else model.no_sync()):
                m = (generate_mask(micro, cfg, generator) if mask is None
                     else mask[i * mb:(i + 1) * mb])
                loss = loss_for_batch(net, micro, m, cfg, loss_weight,
                                      generator, world, group)
            if second_order:
                z = (rademacher(state.params, generator, sharding)
                     if probe_z is None else probe_z[i])
                g, hd = grads_and_probe(loss, state.params, z)
                part = [g[n] for n in names] + [hd[n] for n in names]
                acc = part if acc is None else torch._foreach_add(acc, part)
            else:
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        if world > 1:
            loss_sum = ddp.all_reduce_sum(loss_sum, group) / world
        if second_order:
            grads, hess = second_order_reduce(
                dict(zip(names, acc[:len(names)])),
                dict(zip(names, acc[len(names):])), world, sharding)
        else:
            grads = {n: p.grad for n, p in state.params.items()}
            if sharding is not None:
                sharding.reduce_grads(grads)
        if k > 1:
            grads = dict(zip(grads, torch._foreach_div(list(grads.values()),
                                                       k)))
            if second_order:
                hess = dict(zip(hess, torch._foreach_div(
                    list(hess.values()), k)))
        loss = loss_sum / k if k > 1 else loss_sum
        grad_norm = (global_norm(grads.values()) if sharding is None
                     else sharding.global_norm(grads))
        tx.update(grads, state.opt_state, state.params, hessian_diag=hess)
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


def make_eval_loss_fn(model: torch.nn.Module, cfg: PretrainConfig
                      ) -> Callable[..., torch.Tensor]:
    """eval_fn(batch, generator=None, mask=None) -> the deterministic
    reconstruction loss (mofo_tpu/train/pretrain_step.py:239-249): the model
    in eval mode (no dropout or drop path), no motion weighting, no
    gradient; the mask drawn from `generator` unless given (validation
    curves)."""

    @torch.no_grad()
    def eval_fn(batch: Batch, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        net = ddp.unwrap(model)
        was_training = net.training
        net.eval()
        try:
            m = generate_mask(batch, cfg, generator) if mask is None else mask
            return loss_for_batch(net, batch, m, cfg, None)
        finally:
            net.train(was_training)

    return eval_fn
