"""Convergence A/B of the finetune step: the production path, the fp16
path and the reference configuration over many steps, mixup on.

    python -m mofo_tpu_torch.tools.convergence_ab_finetune [--steps 50]
        [--batch 16] [--no-fp16] [--device cpu] [--out A.json]

Counterpart of tools/convergence_ab_finetune.py. From one seed's f32 master
weights it runs `--steps` full finetune steps of vit_base_patch16_224 with
174 classes at the FinetuneConfig defaults (mixup 0.8, cutmix 1.0, label
smoothing 0.1, soft-target cross entropy; drop path 0.1 in the model),
AdamW with betas (0.9, 0.999), wd 0.05, layer decay 0.75 and lr
cosine_schedule(5e-4, 1e-6, 1, steps, 0), in three arms on the same clips
and labels:

  production: bfloat16, attn_impl "auto" (K1/K2 on the card);
  reference : float32, attn_impl "xla" (the plain math; TF32 off);
  fp16      : float16 under train/loss_scale.py's dynamic loss scale,
              attn_impl "auto" (K1/K2 through their bf16 boundary).

The arms' generators are seeded alike and mixup draws from (cfg.seed, the
step), so the mixup and drop-path draws are the same in every arm (the
uniforms are f32 whatever the compute dtype). mofo_tpu's tool builds its
model without cfg.drop_path (it trains at the registry's 0); this one
passes it, so that drop path's draws are part of what the arms share.
The stream is the JAX tool's (tools/convergence_ab_finetune.py:104-113):
RandomState(0), labels, then a class-shifted gradient plus 0.3 x noise a
step. It moves to the device once; the losses are fetched at the end of
an arm (the fp16 step reads its gradient norm's finiteness each step).
The record holds the curves, max and final rel diffs, each arm's step ms
and peak memory, the card's name and power limit, and what
convergence_ab.gate_failures finds.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mofo_tpu_torch.core.config import FinetuneConfig
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools.convergence_ab import (
    MASK_SEED,
    PRODUCTION,
    REFERENCE,
    SEED,
    arm_fields,
    attention_blocks,
    device_record,
    gate_failures,
    peak_gib,
    reference_math,
    rel_curve,
    start_arm,
    sync_device,
    write,
)
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.finetune_step import make_finetune_step
from mofo_tpu_torch.train.loss_scale import DynamicLossScale
from mofo_tpu_torch.train.train_state import TrainState

MODEL = "vit_base_patch16_224"
NUM_CLASSES = 174
FP16 = ("float16", "auto")


def synthetic_stream(steps: int, batch: int, size: int = 224,
                     frames: int = 16, num_classes: int = NUM_CLASSES):
    """The JAX tool's stream: labels (batch,) int32 and one clip (batch,
    frames, size, size, 3) f32 a step, shifted by label / num_classes."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    base = ((yy + xx) / (2.0 * size)).astype(np.float32)[
        None, None, :, :, None]
    labels = rng.randint(0, num_classes, (batch,)).astype(np.int32)
    shift = (labels / float(num_classes)).astype(np.float32)[
        :, None, None, None, None]
    clips = []
    for _ in range(steps):
        noise = rng.randn(batch, frames, size, size, 3).astype(
            np.float32) * 0.3
        clips.append(base + shift + noise)
    return clips, labels


def run_curve(dtype: str, attn_impl: str, steps: int,
              clips: Sequence[np.ndarray], labels: np.ndarray, *,
              model: str = MODEL, num_classes: int = NUM_CLASSES,
              device=None, model_kw: Optional[dict] = None,
              cfg_kw: Optional[dict] = None,
              params: Optional[Dict[str, torch.Tensor]] = None,
              mixup_params: Optional[Sequence] = None) -> dict:
    """One arm: `steps` finetune steps of `model` (seed SEED's f32 master
    weights, or `params`) in compute dtype `dtype` (float16 under the
    dynamic loss scale) with attention `attn_impl` on clips[s] and
    `labels`. `model_kw` / `cfg_kw` resize the model and the config (the
    tests run a tiny one at drop path 0); `mixup_params`, one MixupParams a
    step, replace the mixup draws. Returns the losses, the ms a step after
    the first, the peak memory (GiB, on the card), the kernel launches of
    the steps, the model's count of attention Blocks and, in fp16, the
    steps the loss scale skipped and its last value."""
    dev = resolve_device(device)
    reference_math(dtype)
    cfg = FinetuneConfig(batch_size=clips[0].shape[0],
                         nb_classes=num_classes, dtype=dtype,
                         **(cfg_kw or {}))
    net = create_model(model, device=dev, dtype=getattr(torch, dtype),
                       seed=SEED, num_classes=num_classes,
                       attn_impl=attn_impl, drop_path_rate=cfg.drop_path,
                       **(model_kw or {}))
    if params is not None:
        net.load_state_dict(params)
    lr = schedules.cosine_schedule(5e-4, 1e-6, 1, steps, 0)
    tx = optim.create_optimizer(dict(net.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.999),
                                weight_decay=0.05, layer_decay=0.75)
    scale = DynamicLossScale.create() if dtype == "float16" else None
    state = TrainState.create(net, tx, loss_scale=scale)
    step = make_finetune_step(net, tx, cfg, lr, device=dev)
    pool = [torch.from_numpy(c).to(dev) for c in clips]
    label = torch.from_numpy(labels).to(dev)
    gen = torch.Generator(device=dev).manual_seed(MASK_SEED)
    start_arm(dev)
    fa.reset_launch_counts()
    losses, skipped = [], []
    t1 = None
    for s in range(steps):
        state, metrics = step(
            state, {"clip": pool[s], "label": label}, gen,
            None if mixup_params is None else mixup_params[s])
        losses.append(metrics["loss"])
        if "skipped" in metrics:
            skipped.append(metrics["skipped"])
        if s == 0:
            sync_device(dev)
            t1 = time.perf_counter()
    sync_device(dev)
    out = {"losses": torch.stack(losses).tolist(),
           "step_ms": ((time.perf_counter() - t1) * 1e3 / (steps - 1)
                       if steps > 1 else None),
           "peak_gib": peak_gib(dev), "launches": dict(fa.launch_counts),
           "attention_blocks": attention_blocks(net)}
    if scale is not None:
        out["skipped_steps"] = int(torch.stack(skipped).sum())
        out["loss_scale"] = state.loss_scale.scale
    del state, step, net, pool
    return out


def run(steps: int = 50, batch: int = 16, fp16: bool = True,
        device=None, stream=None) -> dict:
    """The A/B record: the arms on the JAX tool's stream (or `stream`,
    synthetic_stream's (clips, labels), made by the caller)."""
    resolve_device(device)  # no stream for a run that cannot start
    t0 = time.time()
    clips, labels = stream or synthetic_stream(steps, batch)
    t1 = time.time()
    plan = [("prod", PRODUCTION), ("ref", REFERENCE)]
    if fp16:
        plan.append(("fp16", FP16))
    arms = {key: run_curve(dtype, impl, steps, clips, labels, device=device)
            for key, (dtype, impl) in plan}
    prod, ref = arms["prod"]["losses"], arms["ref"]["losses"]
    half = arms.get("fp16", {}).get("losses")
    art = {
        "metric": "convergence A/B (K1/K2 + bf16 [+ fp16 loss scale] vs "
                  "plain attention + f32, ViT-B classifier finetune, "
                  "mixup on)",
        "steps": steps, "batch": batch, "device": device_record(device),
        "prod_losses": prod, "ref_losses": ref, "fp16_losses": half,
        "final_rel_diff": abs(prod[-1] - ref[-1]) / abs(ref[-1]),
        "max_rel_diff": rel_curve(prod, ref),
        "fp16_max_rel_diff": None if half is None else rel_curve(half, ref),
        **arm_fields(arms),
        "stream_s": t1 - t0, "wall_s": time.time() - t1,
    }
    if half is not None:
        art["fp16_skipped_steps"] = arms["fp16"]["skipped_steps"]
        art["fp16_loss_scale"] = arms["fp16"]["loss_scale"]
    art["gate_failures"] = gate_failures(art)
    return art


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--no-fp16", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    art = run(args.steps, args.batch, not args.no_fp16, args.device)
    write(art, args.out, ("final_rel_diff", "max_rel_diff",
                          "fp16_max_rel_diff", "step_ms", "peak_gib",
                          "gate_failures"))
    return art


if __name__ == "__main__":
    main()
