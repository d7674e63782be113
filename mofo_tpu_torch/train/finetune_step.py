"""Finetuning train and eval steps, plain and BB-focused.

Counterpart of mofo_tpu/train/finetune_step.py (reference
engine_for_finetuning.py:25-225 and train_one_epoch_BB_focused, :504-558):
the augmentation of the uint8 batch (augment_fn), mixup, the criterion
choice, the model (with per-frame boxes when bb_focused), the backward
pass, update_freq gradient accumulation, the fp16 loss scale, the gradient
norm, the optimizer update and EMA; the eval step's loss, acc1 and acc5
with the `valid` weighting.

Random draws have four roles, as the JAX step splits its key: the
augmentation and then the model's dropout and drop path (in the order the
model's modules run) draw on the device from the torch.Generator the
caller hands each step; mixup draws on the host from an
np.random.Generator seeded from (cfg.seed, the step), so a resumed run
draws what an uninterrupted one draws. Dropout (--drop, --attn_drop_rate)
is active in the train step only: the eval step runs the model in eval
mode. second_order (adahessian) also takes the Hutchinson probe of the same
stochastic loss, as train/pretrain_step.py does (mofo_tpu/train/
finetune_step.py:115-169): under the fp16 loss scale the probe of the
scaled loss is divided by the scale, by k * scale with update_freq k, as
the gradients are.

A model wrapped by parallel.ddp.wrap_model trains data-parallel, as in
train/pretrain_step.py: the augmentation, mixup, dropout and drop path
draw the global batch's draws and mixup's partner rows come from rank W-1-r
(ops/mixup.py); the criterion is a mean over equal local batches, so DDP's
mean over the ranks is the global one; the loss metric is the ranks' mean.
The fp16 skip reads the gradient norm of the reduced gradients, so every
rank skips together. The eval step of a wrapped model sums loss * w, hit1
* w, hit5 * w and the valid count over the ranks before it divides
(mofo_tpu/train/finetune_step.py:224-238 averages over the global batch).

A model sharded by parallel.mesh.shard_model trains on its mesh as in
train/pretrain_step.py: the draws, mixup's partner rows (from the batch
coordinate W-1-b of the same model coordinate), the loss metric and the
eval sums run over the batch axis; the gradients are reduced after the
backward (Sharding.reduce_grads) and their norm is taken whole, so an inf
in any rank's shard reaches every rank's norm and every rank skips the
fp16 step together. A second-order step there draws z and reduces the
gradients and the probes as train/pretrain_step.py does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mofo_tpu_torch.core.config import FinetuneConfig
from mofo_tpu_torch.core.device import DeviceLike, device_of, resolve_device
from mofo_tpu_torch.ops.mixup import Mixup, MixupParams
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.parallel.mesh import sharding_of
from mofo_tpu_torch.train import losses
from mofo_tpu_torch.train.optim import global_norm, rademacher
from mofo_tpu_torch.train.pretrain_step import (
    grads_and_probe,
    second_order_reduce,
)
from mofo_tpu_torch.train.train_state import TrainState, ema_update

Batch = Dict[str, torch.Tensor]


def build_criterion(cfg: FinetuneConfig, mixup_active: bool) -> Callable:
    """Reference criterion selection (run_class_finetuning.py:476-495)."""
    if mixup_active:
        return losses.soft_target_cross_entropy  # takes soft targets
    if cfg.smoothing > 0:
        return lambda logits, targets: losses.label_smoothing_cross_entropy(
            logits, targets, cfg.smoothing)
    return losses.cross_entropy


def mixup_for(cfg: FinetuneConfig) -> Mixup:
    return Mixup(mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
                 cutmix_minmax=cfg.cutmix_minmax, prob=cfg.mixup_prob,
                 switch_prob=cfg.mixup_switch_prob, mode=cfg.mixup_mode,
                 label_smoothing=cfg.smoothing, num_classes=cfg.nb_classes)


def _check_device(model: torch.nn.Module, device: DeviceLike):
    dev = resolve_device(device)
    mdev = device_of(model)
    if mdev is None or mdev.type != dev.type or (
        dev.index is not None and mdev.index != dev.index
    ):
        raise ValueError(f"the model is on {mdev}, the step on {dev}")
    return dev


def make_finetune_step(
    model: torch.nn.Module,
    tx,
    cfg: FinetuneConfig,
    lr_schedule: Optional[np.ndarray] = None,
    bb_focused: bool = False,
    augment_fn: Optional[Callable] = None,
    second_order: bool = False,
    device: DeviceLike = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step_fn(state, batch, generator, mixup_params=None,
    probe_z=None) -> (state, metrics).

    The step runs on `device` (CUDA unless the caller passes "cpu"; raises
    without a GPU), where the model must already be. batch: 'clip'
    (B, T, H, W, C) normalized clips, 'label' (B,) int and, when
    bb_focused, 'boxes' (B, T, 4) — or raw decoded uint8 frames when
    augment_fn is given: augment_fn(generator, batch) -> batch runs first,
    inside the step (mofo_tpu/train/finetune_step.py:103-106). With
    update_freq > 1, B splits into that many microbatches. `generator` (on
    the step's device) draws the augmentation, then dropout and drop path;
    `mixup_params` replaces the mixup draws, one MixupParams per
    microbatch (or a single one when update_freq is 1; at the global count
    in a data-parallel step), for tests. `model` may be wrapped by
    parallel.ddp.wrap_model (see above). With second_order the optimizer
    gets the Hutchinson probe; `probe_z`, one name -> tensor dict per
    microbatch, replaces its draws, for tests. The model's attention must
    take the plain route (attn_impl="xla").

    With state.loss_scale (fp16) the loss is scaled before the backward
    pass and the gradients unscaled in f32; when the gradient norm is not
    finite the parameters, the moments and the optimizer's count stay as
    they are and the scale backs off (one host read of the norm's
    finiteness per step); state.step advances either way, as in JAX.

    Metrics: loss, grad_norm, with a schedule lr and with a loss scale
    loss_scale and skipped — tensors left on the device.
    """
    dev = _check_device(model, device)
    mixup_fn = mixup_for(cfg)
    mixup_active = mixup_fn.enabled
    criterion = build_criterion(cfg, mixup_active)
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
                generator: Optional[torch.Generator],
                mixup_params: Union[MixupParams, Sequence[MixupParams],
                                    None] = None, probe_z=None):
        model.train()
        if augment_fn is not None:
            with ddp.global_draws(rank, world, k, group):
                batch = augment_fn(generator, batch)
        B = batch["clip"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} micro")
        if isinstance(mixup_params, MixupParams):
            mixup_params = [mixup_params]
        rng = np.random.default_rng([cfg.seed, state.step])
        scale = 1.0 if state.loss_scale is None else state.loss_scale.scale
        mb = B // k
        names = list(state.params)
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        acc = None  # second order: the summed gradients and probes
        for i in range(k):
            micro = {n: v[i * mb:(i + 1) * mb] for n, v in batch.items()}
            clip, target = micro["clip"], micro["label"]
            sync = not wrapped or i == k - 1 or second_order
            with ddp.global_draws(rank, world, 1, group), \
                    (contextlib.nullcontext() if sync else model.no_sync()):
                if mixup_active:
                    clip, target = mixup_fn(
                        clip, target, rng,
                        None if mixup_params is None else mixup_params[i])
                if bb_focused:
                    logits = net(clip, micro["boxes"], generator)
                else:
                    logits = net(clip, generator)
                loss = criterion(logits, target)
            if second_order:
                z = (rademacher(state.params, generator, sharding)
                     if probe_z is None else probe_z[i])
                g, hd = grads_and_probe(loss * scale, state.params, z)
                part = [g[n] for n in names] + [hd[n] for n in names]
                acc = part if acc is None else torch._foreach_add(acc, part)
            else:
                (loss * scale).backward()
            loss_sum = loss_sum + loss.detach()
        if world > 1:
            loss_sum = ddp.all_reduce_sum(loss_sum, group) / world
        hess = None
        if second_order:
            grads, hess = second_order_reduce(
                dict(zip(names, acc[:len(names)])),
                dict(zip(names, acc[len(names):])), world, sharding)
        else:
            grads = {n: p.grad for n, p in state.params.items()}
            if sharding is not None:
                sharding.reduce_grads(grads)
        if k * scale != 1.0:
            grads = dict(zip(grads, torch._foreach_div(list(grads.values()),
                                                       k * scale)))
            if hess is not None:
                hess = dict(zip(hess, torch._foreach_div(
                    list(hess.values()), k * scale)))
        loss = loss_sum / k if k > 1 else loss_sum
        grad_norm = (global_norm(grads.values()) if sharding is None
                     else sharding.global_norm(grads))
        finite = True
        if state.loss_scale is not None:
            finite = bool(torch.isfinite(grad_norm))
            state.loss_scale = state.loss_scale.update(finite)
        if finite:
            tx.update(grads, state.opt_state, state.params,
                      hessian_diag=hess)
        if state.ema_params is not None:
            ema_update(state.ema_params, state.params, cfg.model_ema_decay)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        if state.loss_scale is not None:
            metrics["loss_scale"] = torch.tensor(state.loss_scale.scale,
                                                 device=dev)
            metrics["skipped"] = torch.tensor(float(not finite), device=dev)
        if lr_schedule is not None:
            metrics["lr"] = torch.tensor(
                float(lr_schedule[min(state.step, len(lr_schedule) - 1)]),
                device=dev)
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(model: torch.nn.Module, cfg: FinetuneConfig,
                   bb_focused: bool = False, device: DeviceLike = None,
                   reduce: bool = True) -> Callable[[Batch], Dict]:
    """eval_fn(batch) -> {loss, acc1, acc5, n_valid, logits (f32)}
    (validation_one_epoch, engine_for_finetuning.py:172-225). An optional
    batch['valid'] flags the real rows of a padded last batch; the metrics
    average over those. With a model wrapped by parallel.ddp.wrap_model the
    sums and the count are the ranks' together (every rank must call
    eval_fn as often), with a sharded one those of the batch axis; the
    logits stay the rank's own. reduce=False keeps every rank's own sums
    (the multi-view test, whose ranks make different numbers of calls)."""
    del cfg  # the JAX signature; nothing in it changes the eval
    _check_device(model, device)
    sharding, group = sharding_of(model), None
    if sharding is not None:
        group = sharding.mesh.batch
        world = group.size
    else:
        world = (ddp.data_parallel(model) or (0, 1))[1]
    if not reduce:
        world = 1
    net = ddp.unwrap(model)

    @torch.no_grad()
    def eval_fn(batch: Batch) -> Dict[str, torch.Tensor]:
        net.eval()
        clip, label = batch["clip"], batch["label"]
        logits = net(clip, batch["boxes"]) if bb_focused else net(clip)
        valid = batch.get("valid")
        w = (torch.ones(label.shape[0], device=logits.device)
             if valid is None else valid.float())
        nll = losses.cross_entropy_per_sample(logits, label)
        hit1, hit5 = losses.topk_hits(logits, label, topk=(1, 5))
        sums = torch.stack([(nll * w).sum(), (hit1 * w).sum(),
                            (hit5 * w).sum(), w.sum()]).float()
        if world > 1:
            sums = ddp.all_reduce_sum(sums, group)
        n = sums[3].clamp(min=1.0)
        return {
            "loss": sums[0] / n,
            "acc1": sums[1] / n * 100.0,
            "acc5": sums[2] / n * 100.0,
            "n_valid": n,
            "logits": logits.float(),
        }

    return eval_fn
