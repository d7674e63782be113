#!/usr/bin/env python3
"""Drives the PyTorch / CUDA port (mofo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - refuses to run without CUDA; the card's name and power limit
               (nvidia-smi); TF32 off for the f32 phases.
  2. build   - compiles the CUDA kernels from mofo_tpu_torch/csrc (nvcc,
               sm_90a), or reuses the build of this checkout.
  3. kernels - each kernel against its plain PyTorch version at the step's
               encoder and decoder shapes (B=16) and a ragged one, bf16 and
               f32, with the bounds of mofo_tpu_torch/tools/main_path.py
               (which must also reject two planted faults); then, on the
               same bf16 qkv, kernel, plain, library
               (F.scaled_dot_product_attention, a yardstick the port never
               calls) and bound times.
  4. step    - the ViT-B MOFO pretrain step at full width (tube_bb masks,
               motion-weighted loss, AdamW): 1 warm-up + 5 timed steps, the
               launch counts of every kernel checked.
  5. parity  - a ViT-B-width model cut to 2+1 blocks, f32, B=1: loss and
               gradient norm on the card (kernels) against the CPU (plain
               versions), same weights and masks. f32 runs the FMA kernels,
               so this phase does not cover the bf16 (tensor-core) kernels
               of the step: phase 3 holds those.
Then the card's nvidia-smi line, the kernels line and, last, the ok line.
Any failed check raises, and the script exits non-zero without the ok line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import masking
from mofo_tpu_torch.tools.main_path import (
    MODEL,
    attention_against_plain,
    build_step,
    check_against_plain,
    compare_with_plain,
    planted_faults,
    synthetic_batch,
)
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

SOURCE = "mofo_tpu_torch/csrc/qkv_flash_attention.cu"
TPU_FILE = "mofo_tpu/ops/flash_attention.py"
REPLACES = {  # the pallas_call sites of the TPU kernels
    "qkv_attn_fwd": f"{TPU_FILE}:1160",  # _qkv_fwd_impl -> _mh_fwd_kernel
    "qkv_attn_bwd_dkv": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dK, dV)
    "qkv_attn_bwd_dq": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dQ)
}
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
HBM = 3.35e12  # H100 SXM bytes/s
STEP_BATCH = 16
# (B, N, H) of the main path's attention at STEP_BATCH; the checks add a
# ragged geometry
MAIN = {"encoder": (STEP_BATCH, 160, 12), "decoder": (STEP_BATCH, 1568, 6)}
CHECKS = {**MAIN, "ragged": (8, 100, 2)}
D = fa.HEAD_DIM
SCALE = D ** -0.5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")
    return smi


def phase_build() -> None:
    info = _build.build()
    _build.load()
    usage = [line.strip() for line in info["report"].splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=info["seconds"], cached=info["cached"],
         library=info["path"], ptxas=usage)


def _qkv(B, N, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * H * D, generator=g).to(dtype).cuda()


def check_kernels(x, H) -> dict:
    """Each kernel against its plain version on qkv x (main_path's bounds;
    raises beyond them). The same bounds must reject two planted faults,
    dQ zeroed and dK without its 1/log2(e) fix."""
    got, want = attention_against_plain(x, H, SCALE)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    res["planted"] = {}
    for fault, outputs in planted_faults(got).items():
        caught = compare_with_plain(outputs, want)
        if not caught["beyond_bounds"]:
            raise AssertionError(f"the bounds let a planted fault pass: "
                                 f"{fault}")
        res["planted"][fault] = {
            "beyond_bounds": caught["beyond_bounds"],
            "max_abs_err": {k: caught["max_abs_err"][k] for k in ("dq", "dk")},
        }
    return res


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` single calls timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(B, N, H) -> dict:
    """Least time (ms) for each kernel's work on an H100 SXM: the larger of
    its FLOPs over the bf16 tensor peak and its bytes (each input read once,
    each output written once) over HBM bandwidth."""
    e, A = 2, H * D
    mm = 2 * B * H * N * N * D  # one (N x N x D) product
    qkv, row = B * N * 3 * A * e, B * N * A * e
    lse = B * H * N * 4
    work = {
        "qkv_attn_fwd": (2 * mm, qkv + row + lse),  # S, P.V
        "qkv_attn_bwd_dkv": (4 * mm, qkv + 2 * row + lse + 2 * row),
        "qkv_attn_bwd_dq": (3 * mm, qkv + 2 * row + lse + row),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_kernels(x, H) -> dict:
    """kernel, plain, library and bound times (ms) on bf16 qkv x."""
    dtype = x.dtype
    B, N, _ = x.shape
    out, lse = fa.qkv_attn_fwd(x, SCALE, H)
    dout = (2 * out.float()).to(dtype)
    dqkv = torch.empty_like(x)
    q, k, v = (t.contiguous().requires_grad_(True)
               for t in fa.split_heads(x, H))
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)
    g_lib = dout.reshape(B, N, H, D).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_qkv_bwd_plain(
        x, out, lse, dout, SCALE, H), runs=10)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (q, k, v), g_lib, retain_graph=True))
    res = {
        "qkv_attn_fwd": {
            "ms": time_ms(lambda: fa.qkv_attn_fwd(x, SCALE, H)),
            "plain_ms": time_ms(
                lambda: fa.attention_qkv_fwd_plain(x, SCALE, H), runs=10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q.detach(), k.detach(), v.detach(), scale=SCALE)),
        },
        "qkv_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dkv(
                x, out, lse, dout, dqkv, SCALE, H)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "qkv_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dq(
                x, out, lse, dout, dqkv, SCALE, H)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds(B, N, H).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def phase_kernels():
    """Checks every kernel at the step's shapes (and a ragged one) in bf16
    and f32, and times them, in bf16, on the very qkv that was checked."""
    errors, timings = {}, {}
    for i, (geo, (B, N, H)) in enumerate(CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = _qkv(B, N, H, dtype, seed=i)
            res = check_kernels(x, H)
            emit("kernels_vs_plain", geometry=geo, B=B, N=N, H=H,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if dtype == torch.bfloat16 and geo in MAIN:
                err = res["max_abs_err"]
                errors[geo] = {"qkv_attn_fwd": err["out"],
                               "qkv_attn_bwd_dkv": max(err["dk"], err["dv"]),
                               "qkv_attn_bwd_dq": err["dq"]}
                timings[geo] = time_kernels(x, H)
                emit("kernel_times", geometry=geo, B=B, N=N, H=H,
                     dtype="bfloat16", times=timings[geo])
            del x
    return errors, timings


def phase_step(smi: str) -> dict:
    """The main path: the full-width ViT-B MOFO step on the card."""
    B = STEP_BATCH
    model, state, step, gen, batch = build_step(B)
    named = dict(model.named_parameters())
    watched = ["encoder.blocks.0.attn.qkv.weight",
               "decoder.blocks.3.mlp.fc2.weight", "mask_token"]
    before = {n: named[n].detach().clone() for n in watched}
    blocks = len(model.encoder.blocks) + len(model.decoder.blocks)

    n_steps = 6  # 1 warm-up + 5 timed
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0.5)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.launch_counts)

    expected = n_steps * blocks
    if launches != dict.fromkeys(fa.KERNELS, expected):
        raise AssertionError(f"launches {launches}, expected {expected} each")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss/grad_norm {losses} {norms}")
    unchanged = [n for n in watched if torch.equal(before[n], named[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    step_ms = statistics.median(times[1:])
    emit("step", model=MODEL, dtype="bfloat16", batch=B, blocks=blocks,
         steps=n_steps, step_ms=step_ms, step_ms_all=times,
         clips_per_s=B / step_ms * 1e3, loss=losses, grad_norm=norms,
         launches=launches, launches_per_step={
             k: v / n_steps for k, v in launches.items()},
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return launches


def phase_parity() -> None:
    """Card (kernels) against CPU (plain versions) at ViT-B width."""
    cfg = PretrainConfig(batch_size=1, dtype="float32", masking=MaskingConfig(
        mask_type="tube_bb"), motion_loss_weight=True)
    gen = torch.Generator().manual_seed(7)
    batch = synthetic_batch(1, gen, "cpu")
    mask = masking.motion_tube_mask(batch["boxes"], generator=gen)
    lr = np.full(4, 1e-4, np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        model = create_model(MODEL, device=dev, seed=5, encoder_depth=2,
                             decoder_depth=1)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr,
                                    betas=(0.9, 0.95), weight_decay=0.05)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, metrics = step(TrainState.create(model, tx),
                          {k: v.to(dev) for k, v in batch.items()}, None,
                          0.5, mask=mask.to(dev))
        results[dev] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        results[dev]["launches"] = dict(fa.launch_counts)
    if min(results["cuda"]["launches"].values()) < 3:
        raise AssertionError(f"the card run skipped a kernel: {results}")
    rel = {k: abs(results["cuda"][k] - results["cpu"][k])
           / abs(results["cpu"][k]) for k in ("loss", "grad_norm")}
    emit("parity", model=MODEL, depth="2+1", dtype="float32", batch=1,
         results=results, rel_diff=rel, bound=1e-4)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU beyond rtol 1e-4: {rel}")


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    errors, timings = phase_kernels()
    launches = phase_step(smi)
    phase_parity()
    kernels = []
    for name in fa.KERNELS:
        dec = timings["decoder"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors["decoder"][name], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "shape": "decoder (B=%d, N=%d, H=%d, D=%d) bf16" % (
                *MAIN["decoder"], D),
            "encoder": {**timings["encoder"][name],
                        "max_abs_err": errors["encoder"][name]},
        })
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
