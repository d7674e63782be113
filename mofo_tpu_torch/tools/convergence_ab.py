"""Convergence A/B of the ViT-B MOFO pretrain step: the production path
against the reference configuration over many steps.

    python -m mofo_tpu_torch.tools.convergence_ab [--steps 50] [--batch 16]
        [--pool N] [--device cpu] [--out A.json]

Counterpart of tools/convergence_ab.py. One step is held against its plain
version elsewhere; this tool shows that the fast path trains the same. From
one seed's f32 master weights it runs `--steps` full pretrain steps of
pretrain_videomae_base_patch16_224 (tube_bb masks, motion-weighted loss,
AdamW with betas (0.9, 0.95), wd 0.05, lr cosine_schedule(1.5e-4, 0.0, 1,
steps, 0)) in two arms on the same stream:

  production: bfloat16, attn_impl "auto" (K1/K2 on the card);
  reference : float32, attn_impl "xla" (the plain math; TF32 off).

Both arms draw their masks from a generator seeded alike, and no draw
depends on the dtype (the uniforms are f32 in both), so they mask alike.
The stream is the JAX tool's: RandomState(0), a gradient base plus a
frame shift plus 0.3 x noise, min(steps, 32) batches (`--pool`) cycled,
then boxes. The pool moves to the device once and the losses stay there
until the end of an arm (one fetch, no synchronization a step). The
artifact holds both curves, max and final rel diff, each arm's step ms and
peak memory, and the card's name and power limit.

`gate_failures(artifact)` holds a record to mofo_tpu's own gates
(tests/test_tpu_kernels.py:338-351, 398-409): both arms trained (last loss
below the first), max rel diff below MAX_REL_DIFF, the two improvements
within IMPROVEMENT_RTOL of each other, an fp16 arm's max rel diff below
MAX_REL_DIFF; tools/convergence_ab_finetune.py's records use it too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.models.layers import Attention
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

MODEL = "pretrain_videomae_base_patch16_224"
PRODUCTION = ("bfloat16", "auto")
REFERENCE = ("float32", "xla")
MAX_REL_DIFF = 2e-2
IMPROVEMENT_RTOL = 5e-2
POOL_MAX = 32
SEED = 1  # the master weights
MASK_SEED = 2  # the arms' generators
LOSS_WEIGHT = 0.5


def device_record(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()


def reference_math(dtype: str) -> None:
    """The f32 reference arm computes f32 products: TF32 off."""
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def synthetic_stream(steps: int, batch: int, pool: Optional[int] = None,
                     size: int = 224, frames: int = 16):
    """The JAX tool's clips (tools/convergence_ab.py:103-116): a list of
    `pool` (default min(steps, 32)) normalized clips (batch, frames, size,
    size, 3) f32 and per-frame boxes (batch, frames, 4)."""
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    base = ((yy + xx) / (2.0 * size)).astype(np.float32)[
        None, None, :, :, None]
    shift = (np.arange(frames) / float(frames)).astype(np.float32)[
        None, :, None, None, None]
    clips = []
    for _ in range(pool or min(steps, POOL_MAX)):
        noise = rng.randn(batch, frames, size, size, 3).astype(
            np.float32) * 0.3
        clips.append(base + shift + noise)
    xy1 = rng.uniform(0, 96, (batch, frames, 2)).astype(np.float32)
    wh = rng.uniform(48, 128, (batch, frames, 2)).astype(np.float32)
    return clips, np.concatenate([xy1, xy1 + wh], axis=-1)


def peak_gib(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def start_arm(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def sync_device(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def attention_blocks(net: torch.nn.Module) -> int:
    """The model's self-attention modules (each launches K1 and K2's three
    kernels once a step when it takes the fused-qkv route)."""
    return sum(isinstance(m, Attention) for m in net.modules())


def run_curve(dtype: str, attn_impl: str, steps: int,
              clips: Sequence[np.ndarray], boxes: np.ndarray, *,
              model: str = MODEL, device=None,
              model_kw: Optional[dict] = None,
              cfg_kw: Optional[dict] = None,
              params: Optional[Dict[str, torch.Tensor]] = None,
              masks: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """One arm: `steps` pretrain steps of `model` (seed SEED's f32 master
    weights, or `params`) in compute dtype `dtype` with attention `attn_impl`
    on clips[s % len(clips)] and `boxes`. `model_kw` / `cfg_kw` resize the
    model and the config (the tests run a tiny one); `masks`, one (B, N) bool
    tensor a step, replace the generator's draws. Returns the losses, the ms
    a step after the first, the peak memory (GiB, on the card), the kernel
    launches of the steps and the model's count of attention Blocks."""
    dev = resolve_device(device)
    reference_math(dtype)
    cfg = PretrainConfig(batch_size=clips[0].shape[0], dtype=dtype,
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True, **(cfg_kw or {}))
    net = create_model(model, device=dev, dtype=getattr(torch, dtype),
                       seed=SEED, attn_impl=attn_impl, **(model_kw or {}))
    if params is not None:
        net.load_state_dict(params)
    lr = schedules.cosine_schedule(1.5e-4, 0.0, 1, steps, 0)
    tx = optim.create_optimizer(dict(net.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(net, tx)
    step = make_pretrain_step(net, tx, cfg, lr, device=dev)
    pool = [torch.from_numpy(c).to(dev) for c in clips]
    batch_boxes = torch.from_numpy(boxes).to(dev)
    gen = torch.Generator(device=dev).manual_seed(MASK_SEED)
    start_arm(dev)
    fa.reset_launch_counts()
    losses = []
    t1 = None
    for s in range(steps):
        batch = {"clip": pool[s % len(pool)], "boxes": batch_boxes}
        state, metrics = step(state, batch, gen, LOSS_WEIGHT,
                              mask=None if masks is None else masks[s])
        losses.append(metrics["loss"])
        if s == 0:
            sync_device(dev)
            t1 = time.perf_counter()
    sync_device(dev)
    step_ms = ((time.perf_counter() - t1) * 1e3 / (steps - 1)
               if steps > 1 else None)
    out = {"losses": torch.stack(losses).tolist(), "step_ms": step_ms,
           "peak_gib": peak_gib(dev), "launches": dict(fa.launch_counts),
           "attention_blocks": attention_blocks(net)}
    del state, step, net, pool
    return out


def rel_curve(curve: Sequence[float], ref: Sequence[float]) -> float:
    """max |a - b| / max(|b|, 1e-8) over the steps."""
    return max(abs(a - b) / max(abs(b), 1e-8) for a, b in zip(curve, ref))


def gate_failures(art: dict) -> List[str]:
    """What keeps a record from mofo_tpu's gates (empty when it passes);
    the rel diffs are taken from the curves, not the recorded fields."""
    prod, ref = art["prod_losses"], art["ref_losses"]
    bad = []
    if not (prod[-1] < prod[0] and ref[-1] < ref[0]):
        bad.append(f"an arm did not train: prod {prod[0]} -> {prod[-1]}, "
                   f"ref {ref[0]} -> {ref[-1]}")
    rel = rel_curve(prod, ref)
    if not rel < MAX_REL_DIFF:
        bad.append(f"max rel diff {rel} >= {MAX_REL_DIFF}")
    imp_prod, imp_ref = prod[0] - prod[-1], ref[0] - ref[-1]
    if not abs(imp_prod - imp_ref) / abs(imp_ref) < IMPROVEMENT_RTOL:
        bad.append(f"improvements {imp_prod} and {imp_ref} differ by more "
                   f"than {IMPROVEMENT_RTOL}")
    if art.get("fp16_losses") is not None:
        rel16 = rel_curve(art["fp16_losses"], ref)
        if not rel16 < MAX_REL_DIFF:
            bad.append(f"fp16 max rel diff {rel16} >= {MAX_REL_DIFF}")
    return bad


def run(steps: int = 50, batch: int = 16, pool: Optional[int] = None,
        device=None, stream=None) -> dict:
    """The A/B record: both arms on the JAX tool's stream (or `stream`,
    synthetic_stream's (clips, boxes), made by the caller)."""
    resolve_device(device)  # no stream for a run that cannot start
    t0 = time.time()
    clips, boxes = stream or synthetic_stream(steps, batch, pool)
    t1 = time.time()
    arms = {key: run_curve(dtype, impl, steps, clips, boxes, device=device)
            for key, (dtype, impl) in (("prod", PRODUCTION),
                                       ("ref", REFERENCE))}
    prod, ref = arms["prod"]["losses"], arms["ref"]["losses"]
    art = {
        "metric": "convergence A/B (K1/K2 + bf16 vs plain attention + "
                  "f32, ViT-B MOFO pretrain)",
        "steps": steps, "pool": len(clips), "batch": batch,
        "device": device_record(device),
        "prod_losses": prod, "ref_losses": ref,
        "final_rel_diff": abs(prod[-1] - ref[-1]) / abs(ref[-1]),
        "max_rel_diff": rel_curve(prod, ref),
        **arm_fields(arms),
        "stream_s": t1 - t0, "wall_s": time.time() - t1,
    }
    art["gate_failures"] = gate_failures(art)
    return art


def arm_fields(arms: Dict[str, dict]) -> dict:
    """Each arm's step ms, peak memory and nonzero kernel launches, and
    the model's attention Blocks."""
    return {
        "step_ms": {k: a["step_ms"] for k, a in arms.items()},
        "peak_gib": {k: a["peak_gib"] for k, a in arms.items()},
        "launches": {k: {n: c for n, c in a["launches"].items() if c}
                     for k, a in arms.items()},
        "attention_blocks": next(iter(arms.values()))["attention_blocks"],
    }


def write(art: dict, out: Optional[str], keys: Sequence[str]) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(art, f, indent=1)
    print(json.dumps({k: art[k] for k in keys}))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pool", type=int, default=None,
                    help="distinct synthetic batches to cycle (default "
                         "min(steps, 32))")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    art = run(args.steps, args.batch, args.pool, args.device)
    write(art, args.out, ("final_rel_diff", "max_rel_diff", "step_ms",
                          "peak_gib", "gate_failures"))
    return art


if __name__ == "__main__":
    main()
