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
mode. adahessian (second_order) is not ported yet and raises
NotImplementedError (ROADMAP Queue 1, item 17).

A model wrapped by parallel.ddp.wrap_model trains data-parallel, as in
train/pretrain_step.py: the augmentation, mixup, dropout and drop path
draw the global batch's draws and mixup's partner rows come from rank W-1-r
(ops/mixup.py); the criterion is a mean over equal local batches, so DDP's
mean over the ranks is the global one; the loss metric is the ranks' mean.
The fp16 skip reads the gradient norm of the reduced gradients, so every
rank skips together. The eval step of a wrapped model sums loss * w, hit1
* w, hit5 * w and the valid count over the ranks before it divides
(mofo_tpu/train/finetune_step.py:224-238 averages over the global batch).
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
from mofo_tpu_torch.train import losses
from mofo_tpu_torch.train.optim import global_norm
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
    """Returns step_fn(state, batch, generator, mixup_params=None) ->
    (state, metrics).

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
    parallel.ddp.wrap_model (see above).

    With state.loss_scale (fp16) the loss is scaled before the backward
    pass and the gradients unscaled in f32; when the gradient norm is not
    finite the parameters, the moments and the optimizer's count stay as
    they are and the scale backs off (one host read of the norm's
    finiteness per step); state.step advances either way, as in JAX.

    Metrics: loss, grad_norm, with a schedule lr and with a loss scale
    loss_scale and skipped — tensors left on the device.
    """
    if second_order:
        raise NotImplementedError("second_order (adahessian) is not ported "
                                  "(ROADMAP Queue 1, item 17)")
    dev = _check_device(model, device)
    mixup_fn = mixup_for(cfg)
    mixup_active = mixup_fn.enabled
    criterion = build_criterion(cfg, mixup_active)
    k = cfg.update_freq
    rank, world = ddp.data_parallel(model) or (0, 1)

    def step_fn(state: TrainState, batch: Batch,
                generator: Optional[torch.Generator],
                mixup_params: Union[MixupParams, Sequence[MixupParams],
                                    None] = None):
        model.train()
        if augment_fn is not None:
            with ddp.global_draws(rank, world, k):
                batch = augment_fn(generator, batch)
        B = batch["clip"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} micro")
        if isinstance(mixup_params, MixupParams):
            mixup_params = [mixup_params]
        rng = np.random.default_rng([cfg.seed, state.step])
        scale = 1.0 if state.loss_scale is None else state.loss_scale.scale
        mb = B // k
        for p in state.params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            micro = {n: v[i * mb:(i + 1) * mb] for n, v in batch.items()}
            clip, target = micro["clip"], micro["label"]
            sync = world == 1 or i == k - 1
            with ddp.global_draws(rank, world), \
                    (contextlib.nullcontext() if sync else model.no_sync()):
                if mixup_active:
                    clip, target = mixup_fn(
                        clip, target, rng,
                        None if mixup_params is None else mixup_params[i])
                if bb_focused:
                    logits = model(clip, micro["boxes"], generator)
                else:
                    logits = model(clip, generator)
                loss = criterion(logits, target)
                (loss * scale).backward()
            loss_sum = loss_sum + loss.detach()
        if world > 1:
            loss_sum = ddp.all_reduce_sum(loss_sum) / world
        grads = {n: p.grad for n, p in state.params.items()}
        if k * scale != 1.0:
            grads = dict(zip(grads, torch._foreach_div(list(grads.values()),
                                                       k * scale)))
        loss = loss_sum / k if k > 1 else loss_sum
        grad_norm = global_norm(grads.values())
        finite = True
        if state.loss_scale is not None:
            finite = bool(torch.isfinite(grad_norm))
            state.loss_scale = state.loss_scale.update(finite)
        if finite:
            tx.update(grads, state.opt_state, state.params)
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
                   bb_focused: bool = False,
                   device: DeviceLike = None) -> Callable[[Batch], Dict]:
    """eval_fn(batch) -> {loss, acc1, acc5, n_valid, logits (f32)}
    (validation_one_epoch, engine_for_finetuning.py:172-225). An optional
    batch['valid'] flags the real rows of a padded last batch; the metrics
    average over those. With a model wrapped by parallel.ddp.wrap_model the
    sums and the count are the ranks' together (every rank must call
    eval_fn as often); the logits stay the rank's own."""
    del cfg  # the JAX signature; nothing in it changes the eval
    _check_device(model, device)
    world = (ddp.data_parallel(model) or (0, 1))[1]
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
            sums = ddp.all_reduce_sum(sums)
        n = sums[3].clamp(min=1.0)
        return {
            "loss": sums[0] / n,
            "acc1": sums[1] / n * 100.0,
            "acc5": sums[2] / n * 100.0,
            "n_valid": n,
            "logits": logits.float(),
        }

    return eval_fn
