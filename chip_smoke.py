#!/usr/bin/env python3
"""Drives the PyTorch / CUDA port (mofo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - refuses to run without CUDA; the card's name and power limit
               (nvidia-smi); TF32 off for the f32 phases.
  2. build   - compiles the CUDA kernels from mofo_tpu_torch/csrc (nvcc,
               sm_90a), or reuses the build of this checkout.
  3. kernels - each fused-qkv kernel (K1/K2) against its plain PyTorch
               version at the pretrain step's encoder and decoder shapes
               (B=16), the finetune backbone's (B=10, N=1568, H=12) and a
               ragged one, bf16 and f32, with the bounds of
               mofo_tpu_torch/tools/main_path.py (which must also reject two
               planted faults); then, on the same bf16 qkv, kernel, plain,
               library (F.scaled_dot_product_attention, a yardstick the port
               never calls) and bound times.
  4. mh_kernels - the same for the masked multihead kernels (K3): the MCA
               (B=10, N=1568, 3 x 256), 12 x 64 at N=1568 and ragged N=100
               at 1 x 256 and 2 x 64, bf16 and f32, bias present and
               absent; planted faults (the bias ignored, dQ zeroed, dK
               without its 1/log2 e fix) must be rejected and masked kv
               rows must get zero dK/dV; then the times at the MCA shape.
  5. step    - the ViT-B MOFO pretrain step at full width (tube_bb masks,
               motion-weighted loss, AdamW): 1 warm-up + 5 timed steps, the
               launch counts of every kernel checked.
  6. parity  - a ViT-B-width model cut to 2+1 blocks, f32, B=1: loss and
               gradient norm on the card (kernels) against the CPU (plain
               versions), same weights and masks. f32 runs the FMA kernels,
               so this phase does not cover the bf16 (tensor-core) kernels
               of the step: phase 3 holds those.
  7. finetune_step - the ViT-B BB-focused MCA finetune step at the
               FinetuneConfig defaults (bf16, B=10, mixup, cutmix, label
               smoothing, drop path 0.1, AdamW with layer decay), backbone
               from the pretrain model: 1 warm-up + 5 timed steps and one
               eval call, every kernel's launches checked.
  8. finetune_parity - the BB-focused model at ViT-B width cut to 2
               Blocks, f32, B=2, same weights and mixup draws: loss and
               gradient norm on the card against the CPU; one sample has no
               in-box token, the other a box over the whole frame.
  9. hm_kernels - the head-major kernels (K4) against their plain versions
               at the ViT-S runner's decoder (B=32, H=3, N=1568), the TPU's
               own gated geometry (B=2, H=6, N=1568), ragged N=100 and the
               32-frame N=3136, bf16 and f32, D=64; planted faults (dQ
               zeroed, the LSE in log2 units) must be rejected; then the
               times at the runner's decoder shape, and (k1_vs_k4) how far
               K1's numerics, which the ViT-S decoder ran before it took
               the head-major route, lie from K4's on the same inputs.
 10. vits_step - the ViT-S MOFO pretrain step at full width (bf16, B=32):
               1 warm-up + 5 timed steps, 12 K1/K2 launches (encoder) and 4
               K4 launches (decoder) of each kernel per step, exactly.
 11. vits_parity - ViT-S width cut to 2+1 blocks, f32, B=1: card against
               CPU as in phase 6; covers the f32 K4 kernels.
 12. runner  - the main path of this slice: the ViT-S MOFO pretrain runner
               (mofo_tpu_torch.cli.pretrain_mofo.main, in this process) on
               64 synthetic uint8 clips at B=32 for 2 epochs into a
               temporary output dir, then again with --epochs 3, which must
               resume at epoch 2; log.txt, checkpoint-{0,1,2}.pth, finite
               losses and the launches per step are checked, and the step
               time and the loader wait printed apart.
Then the card's nvidia-smi line, the kernels line and, last, the ok line.
Any failed check raises, and the script exits non-zero without the ok line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mofo_tpu_torch.cli import pretrain_mofo
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import masking
from mofo_tpu_torch.tools.main_path import (
    FINETUNE_MODEL,
    MODEL,
    VITS_MODEL,
    attention_against_plain,
    build_finetune_step,
    build_step,
    check_against_plain,
    compare_with_plain,
    finetune_model,
    hm_attention_against_plain,
    hm_inputs,
    hm_planted_faults,
    masked_kv_grad,
    mh_attention_against_plain,
    mh_inputs,
    planted_faults,
    synthetic_batch,
    synthetic_finetune_batch,
)
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.finetune_step import (
    make_eval_step,
    make_finetune_step,
    mixup_for,
)
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

SOURCES = {n: "mofo_tpu_torch/csrc/qkv_flash_attention.cu"
           for n in fa.QKV_KERNELS}
SOURCES.update({n: "mofo_tpu_torch/csrc/mh_flash_attention.cu"
                for n in fa.MH_KERNELS})
SOURCES.update({n: "mofo_tpu_torch/csrc/hm_flash_attention.cu"
                for n in fa.HM_KERNELS})
TPU_FILE = "mofo_tpu/ops/flash_attention.py"
REPLACES = {  # the pallas_call sites of the TPU kernels
    "qkv_attn_fwd": f"{TPU_FILE}:1160",  # _qkv_fwd_impl -> _mh_fwd_kernel
    "qkv_attn_bwd_dkv": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dK, dV)
    "qkv_attn_bwd_dq": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dQ)
    # _mh_fwd_impl -> _mh_fwd_kernel with has_bias
    "mh_attn_fwd": f"{TPU_FILE}:678",
    "mh_attn_bwd_dkv": f"{TPU_FILE}:783",  # _mh_bwd_impl (dK, dV)
    "mh_attn_bwd_dq": f"{TPU_FILE}:783",  # _mh_bwd_impl (dQ)
    "hm_attn_fwd": f"{TPU_FILE}:275",  # _fwd_impl -> _fwd_kernel
    "hm_attn_bwd_dkv": f"{TPU_FILE}:359",  # _bwd_impl -> _dkv_kernel
    "hm_attn_bwd_dq": f"{TPU_FILE}:332",  # _bwd_impl -> _dq_kernel
}
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
HBM = 3.35e12  # H100 SXM bytes/s
STEP_BATCH = 16
# (B, N, H) of the main path's attention at STEP_BATCH; the checks add a
# ragged geometry
MAIN = {"encoder": (STEP_BATCH, 160, 12), "decoder": (STEP_BATCH, 1568, 6),
        "backbone": (10, 1568, 12)}  # the finetune backbone's Blocks
CHECKS = {**MAIN, "ragged": (8, 100, 2)}
FT_BATCH = 10
# K3: (B, N, H, D); the MCA is the finetune step's own
MH_CHECKS = {"mca": (FT_BATCH, 1568, 3, 256), "h12": (FT_BATCH, 1568, 12, 64),
             "ragged_d256": (4, 100, 1, 256), "ragged_d64": (4, 100, 2, 64)}
VITS_BATCH = 32  # B*H = 96 in the ViT-S decoder, as ViT-B's at B=16
# K4: (B, H, N); the runner's decoder is the main path's own
HM_CHECKS = {"runner_decoder": (VITS_BATCH, 3, 1568),
             "tpu_gated": (2, 6, 1568), "ragged": (4, 3, 100),
             "frames32": (2, 6, 3136)}
# launches of each kernel per step: ViT-B runs K1/K2 in all 16 Blocks; the
# ViT-S decoder's 3 x 64 heads (A = 192) take K4 in its 4 Blocks
STEP_LAUNCHES = {
    MODEL: {**dict.fromkeys(fa.KERNELS, 0),
            **dict.fromkeys(fa.QKV_KERNELS, 16)},
    VITS_MODEL: {**dict.fromkeys(fa.KERNELS, 0),
                 **dict.fromkeys(fa.QKV_KERNELS, 12),
                 **dict.fromkeys(fa.HM_KERNELS, 4)},
}
# the runner's flags; --warmup_epochs 1 because the default 40 warm-up
# epochs do not fit a 2-epoch cosine schedule
RUNNER_ARGS = ["--model", VITS_MODEL, "--synthetic", "64", "--batch_size",
               str(VITS_BATCH), "--steps_per_epoch", "2", "--save_ckpt_freq",
               "1", "--warmup_epochs", "1"]
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
    """Builds both sources with one nvcc call; reports each kernel
    instance's registers and spills (ptxas -v)."""
    info = _build.build()
    _build.load()
    ptxas, name = {}, None
    for line in info["report"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.strip())
    emit("build", seconds=info["seconds"], cached=info["cached"],
         library=info["path"], sources=list(_build.SOURCES), ptxas=ptxas)


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


def least_times(work: dict) -> dict:
    """name -> (least ms, what bounds it) for name -> (FLOPs, bytes)."""
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


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
    return least_times(work)


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
    """Checks every fused-qkv kernel at the steps' shapes (and a ragged
    one) in bf16 and f32, and times them, in bf16, on the very qkv that was
    checked."""
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


def bounds_mh(B, N, H, D) -> dict:
    """bounds() for the K3 kernels: separate q, k, v (each read once), the
    bias row, and the backward's delta; the work at its least (the dK/dV
    kernel's recomputed products not counted)."""
    e, A = 2, H * D
    mm = 2 * B * H * N * N * D
    row, stat = B * N * A * e, B * H * N * 4
    inputs = 3 * row + B * N * 4  # q, k, v, bias
    work = {
        "mh_attn_fwd": (2 * mm, inputs + row + stat),  # -> out, lse
        # + dout, lse, delta -> dk, dv
        "mh_attn_bwd_dkv": (4 * mm, inputs + row + 2 * stat + 2 * row),
        "mh_attn_bwd_dq": (3 * mm, inputs + row + 2 * stat + row),
    }
    return least_times(work)


def time_mh_kernels(q, k, v, b, H, D) -> dict:
    """kernel, plain, library and bound times (ms) of K3 on bf16 inputs."""
    scale = D ** -0.5
    B, N, _ = q.shape
    out, lse = fa.mh_attn_fwd(q, k, v, b, scale, H)
    dout = (2 * out.float()).to(q.dtype)
    delta = fa.mh_delta(out, dout, H)
    dkv = torch.empty(B, N, 2 * H * D, dtype=q.dtype, device=q.device)
    dq = torch.empty_like(q)
    heads = [t.reshape(B, N, H, D).transpose(1, 2).contiguous()
             .requires_grad_(True) for t in (q, k, v)]
    mask = b[:, None, None, :].to(q.dtype)
    o_lib = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                           scale=scale)
    g_lib = dout.reshape(B, N, H, D).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_mh_bwd_plain(
        q, k, v, b, out, lse, dout, scale, H), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "mh_attn_fwd": {
            "ms": time_ms(lambda: fa.mh_attn_fwd(q, k, v, b, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_mh_fwd_plain(
                q, k, v, b, scale, H), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), attn_mask=mask, scale=scale)),
        },
        "mh_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dkv(
                q, k, v, b, dout, lse, delta, dkv[..., :H * D],
                dkv[..., H * D:], scale, H)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "mh_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dq(
                q, k, v, b, dout, lse, delta, dq, scale, H)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds_mh(B, N, H, D).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def phase_mh_kernels():
    """K3 against its plain version at every MH_CHECKS geometry, bf16 and
    f32, bias present and absent: main_path's bounds, the planted faults
    rejected, masked kv rows with exactly zero dK/dV. Times at the MCA."""
    errors, timings = {}, {}
    for i, (geo, (B, N, H, D)) in enumerate(MH_CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            for bias in (True, False):
                q, k, v, b = mh_inputs(B, N, H, D, dtype, i, "cuda", bias)
                got, want = mh_attention_against_plain(q, k, v, b, H,
                                                       D ** -0.5)
                torch.cuda.synchronize()
                res = check_against_plain(got, want)
                ignored = None
                if bias:
                    ignored, _ = mh_attention_against_plain(
                        q, k, v, None, H, D ** -0.5)
                res["planted"] = {}
                for fault, outputs in planted_faults(got, ignored).items():
                    caught = compare_with_plain(outputs, want)
                    if not caught["beyond_bounds"]:
                        raise AssertionError(
                            f"the bounds let a planted fault pass: {fault} "
                            f"({geo}, {dtype}, bias={bias})")
                    res["planted"][fault] = caught["beyond_bounds"]
                res["masked_kv_grad"] = masked_kv_grad(got, b)
                if res["masked_kv_grad"] != 0.0:
                    raise AssertionError(f"masked kv rows got dK/dV: {res}")
                emit("mh_kernels_vs_plain", geometry=geo, B=B, N=N, H=H, D=D,
                     dtype=str(dtype).replace("torch.", ""), bias=bias,
                     **res)
                if geo == "mca" and dtype == torch.bfloat16 and bias:
                    err = res["max_abs_err"]
                    errors = {"mh_attn_fwd": err["out"],
                              "mh_attn_bwd_dkv": max(err["dk"], err["dv"]),
                              "mh_attn_bwd_dq": err["dq"]}
                    timings = time_mh_kernels(q, k, v, b, H, D)
                    emit("mh_kernel_times", geometry=geo, B=B, N=N, H=H,
                         D=D, dtype="bfloat16", bias=True, times=timings)
                del q, k, v, b, got, want, ignored
    return errors, timings


def phase_step(smi: str, phase: str = "step", model_name: str = MODEL,
               B: int = STEP_BATCH) -> dict:
    """A full-width MOFO pretrain step on the card (ViT-B by default): 1
    warm-up + 5 timed steps, every kernel's launches checked exactly
    against STEP_LAUNCHES."""
    model, state, step, gen, batch = build_step(B, model_name)
    named = dict(model.named_parameters())
    watched = ["encoder.blocks.0.attn.qkv.weight",
               "decoder.blocks.3.mlp.fc2.weight", "mask_token"]
    before = {n: named[n].detach().clone() for n in watched}
    blocks = len(model.encoder.blocks) + len(model.decoder.blocks)
    per_step = STEP_LAUNCHES[model_name]

    n_steps = 6  # 1 warm-up + 5 timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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

    expected = {k: n_steps * v for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss/grad_norm {losses} {norms}")
    unchanged = [n for n in watched if torch.equal(before[n], named[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    step_ms = statistics.median(times[1:])
    emit(phase, model=model_name, dtype="bfloat16", batch=B, blocks=blocks,
         steps=n_steps, step_ms=step_ms, step_ms_all=times,
         clips_per_s=B / step_ms * 1e3, loss=losses, grad_norm=norms,
         launches=launches, launches_per_step=per_step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return launches


def phase_parity(phase: str = "parity", model_name: str = MODEL,
                 kernels=fa.QKV_KERNELS) -> None:
    """Card (kernels) against CPU (plain versions) at full width, cut to
    2+1 blocks, f32, B=1; each of `kernels` must have run on the card."""
    cfg = PretrainConfig(model=model_name, batch_size=1, dtype="float32",
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True)
    gen = torch.Generator().manual_seed(7)
    batch = synthetic_batch(1, gen, "cpu")
    mask = masking.motion_tube_mask(batch["boxes"], generator=gen)
    lr = np.full(4, 1e-4, np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        model = create_model(model_name, device=dev, seed=5, encoder_depth=2,
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
    if min(results["cuda"]["launches"][k] for k in kernels) < 1:
        raise AssertionError(f"the card run skipped a kernel: {results}")
    rel = {k: abs(results["cuda"][k] - results["cpu"][k])
           / abs(results["cpu"][k]) for k in ("loss", "grad_norm")}
    emit(phase, model=model_name, depth="2+1", dtype="float32", batch=1,
         results=results, rel_diff=rel, bound=1e-4)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU beyond rtol 1e-4: {rel}")


def phase_finetune_step(smi: str) -> dict:
    """The main path of this slice: the full-width ViT-B BB-focused MCA
    finetune step on the card, then one eval call."""
    B = FT_BATCH
    model, state, step, gen, batch, cfg = build_finetune_step(B)
    named = dict(model.named_parameters())
    watched = ["backbone.blocks.0.attn.qkv.weight",
               "local_MCA.0.attn.q.weight", "head.weight"]
    before = {n: named[n].detach().clone() for n in watched}
    blocks = len(model.backbone.blocks)
    mca = len(model.local_MCA)

    n_steps = 6  # 1 warm-up + 5 timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.launch_counts)
    expected = {**dict.fromkeys(fa.KERNELS, 0),
                **dict.fromkeys(fa.QKV_KERNELS, n_steps * blocks),
                **dict.fromkeys(fa.MH_KERNELS, n_steps * mca)}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss/grad_norm {losses} {norms}")
    unchanged = [n for n in watched if torch.equal(before[n], named[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    fa.reset_launch_counts()
    ev = make_eval_step(model, cfg, bb_focused=True)(batch)
    torch.cuda.synchronize()
    eval_launches = dict(fa.launch_counts)
    want_eval = {**dict.fromkeys(fa.KERNELS, 0), "qkv_attn_fwd": blocks,
                 "mh_attn_fwd": mca}
    if eval_launches != want_eval:
        raise AssertionError(f"eval launches {eval_launches}, expected "
                             f"{want_eval}")
    if ev["logits"].shape != (B, cfg.nb_classes) or not all(
            np.isfinite(float(ev[k])) for k in ("loss", "acc1", "acc5")):
        raise AssertionError(f"bad eval output: {ev}")
    step_ms = statistics.median(times[1:])
    emit("finetune_step", model=FINETUNE_MODEL, fusing="MCA",
         dtype="bfloat16", batch=B, blocks=blocks, mca_blocks=mca,
         mixup=cfg.mixup, cutmix=cfg.cutmix, smoothing=cfg.smoothing,
         drop_path=cfg.drop_path, layer_decay=cfg.optimizer.layer_decay,
         steps=n_steps, step_ms=step_ms, step_ms_all=times,
         clips_per_s=B / step_ms * 1e3, loss=losses, grad_norm=norms,
         launches=launches, launches_per_step={
             k: v / n_steps for k, v in launches.items()},
         eval_launches=eval_launches,
         eval={k: float(ev[k]) for k in ("loss", "acc1", "acc5")},
         peak_mem_gib=peak, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return launches


def phase_finetune_parity() -> None:
    """BB-focused MCA at ViT-B width, 2 Blocks, f32, B=2: card (kernels)
    against CPU (plain versions), same weights and mixup draws."""
    cfg = FinetuneConfig(batch_size=2, dtype="float32", drop_path=0.0,
                         model=FINETUNE_MODEL)
    gen = torch.Generator().manual_seed(9)
    batch = synthetic_finetune_batch(2, gen, "cpu", cfg.nb_classes)
    batch["boxes"][0] = torch.tensor([300.0, 300.0, 330.0, 330.0])  # no in
    batch["boxes"][1] = torch.tensor([0.0, 0.0, 224.0, 224.0])  # no out
    mix = mixup_for(cfg)
    draws = mix.sample(np.random.default_rng(1), mix.count(2), 224, 224)
    lr = np.full(4, 1e-4, np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        model = finetune_model(cfg, device=dev, seed=5, depth=2)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr,
                                    weight_decay=0.05, layer_decay=0.75)
        step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                                  device=dev)
        fa.reset_launch_counts()
        _, metrics = step(TrainState.create(model, tx),
                          {k: v.to(dev) for k, v in batch.items()}, None,
                          draws)
        results[dev] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        results[dev]["launches"] = dict(fa.launch_counts)
    if min(results["cuda"]["launches"][k]
           for k in fa.QKV_KERNELS + fa.MH_KERNELS) < 1:
        raise AssertionError(f"the card run skipped a kernel: {results}")
    rel = {k: abs(results["cuda"][k] - results["cpu"][k])
           / abs(results["cpu"][k]) for k in ("loss", "grad_norm")}
    emit("finetune_parity", model=FINETUNE_MODEL, fusing="MCA", depth=2,
         dtype="float32", batch=2, results=results, rel_diff=rel,
         bound=1e-4)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU beyond rtol 1e-4: {rel}")


def bounds_hm(BH, N, D) -> dict:
    """bounds() for the K4 kernels on (BH, N, D) q, k, v (each read once),
    the LSE and the backward's delta; the work at its least (the forward's
    second score product and the dK/dV kernel's recomputed ones not
    counted)."""
    mm = 2 * BH * N * N * D
    row, stat = BH * N * D * 2, BH * N * 4
    return least_times({
        "hm_attn_fwd": (2 * mm, 3 * row + row + stat),  # -> out, lse
        # + dout, lse, delta -> dk, dv
        "hm_attn_bwd_dkv": (4 * mm, 4 * row + 2 * stat + 2 * row),
        "hm_attn_bwd_dq": (3 * mm, 4 * row + 2 * stat + row),
    })


def time_hm_kernels(q, k, v, B, H) -> dict:
    """kernel, plain, library and bound times (ms) of K4 on bf16 (B*H, N,
    D) inputs."""
    BH, N, D = q.shape
    scale = D ** -0.5
    out, lse = fa.hm_attn_fwd(q, k, v, scale)
    dout = (2 * out.float()).to(q.dtype)
    delta = fa.hm_delta(out, dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    heads = [t.reshape(B, H, N, D).clone().requires_grad_(True)
             for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*heads, scale=scale)
    g_lib = dout.reshape(B, H, N, D)
    plain_bwd = time_ms(lambda: fa.attention_hm_bwd_plain(
        q, k, v, out, lse, dout, scale), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "hm_attn_fwd": {
            "ms": time_ms(lambda: fa.hm_attn_fwd(q, k, v, scale)),
            "plain_ms": time_ms(lambda: fa.attention_hm_fwd_plain(
                q, k, v, scale), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), scale=scale)),
        },
        "hm_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dkv(
                q, k, v, dout, lse, delta, dk, dv, scale)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "hm_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dq(
                q, k, v, dout, lse, delta, dq, scale)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds_hm(BH, N, D).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def k1_vs_k4(B, H, N, dtype) -> dict:
    """The K1/K2 kernels and the K4 kernels on the same q, k, v (and the
    same dout): how far the two numerics lie apart (max |K1 - K4| of out,
    dq, dk, dv, each beside its max |K4|)."""
    x = _qkv(B, N, H, dtype, seed=11)
    out1, lse1 = fa.qkv_attn_fwd(x, SCALE, H)
    dout = torch.randn(out1.shape, generator=torch.Generator().manual_seed(
        12)).to(dtype).cuda()
    dqkv = fa.qkv_attn_bwd(x, out1, lse1, dout, SCALE, H)
    q, k, v = (t.reshape(B * H, N, D).contiguous()
               for t in fa.split_heads(x, H))
    to_hm = lambda t: t.reshape(B, N, H, D).transpose(1, 2).reshape(  # noqa
        B * H, N, D).contiguous()
    out4, lse4 = fa.hm_attn_fwd(q, k, v, SCALE)
    grads4 = fa.hm_attn_bwd(q, k, v, out4, lse4, to_hm(dout), SCALE)
    A = H * D
    k1 = {"out": out1, "dq": dqkv[..., :A], "dk": dqkv[..., A:2 * A],
          "dv": dqkv[..., 2 * A:]}
    back = lambda t: t.reshape(B, H, N, D).transpose(1, 2).reshape(  # noqa
        B, N, A)
    k4 = {"out": back(out4), **{n: back(g) for n, g in
                                zip(("dq", "dk", "dv"), grads4)}}
    torch.cuda.synchronize()
    return {n: {"max_abs_diff": (k1[n].float() - k4[n].float()).abs().max()
                .item(),
                "max_abs_k4": k4[n].float().abs().max().item(),
                "share_differing": (k1[n] != k4[n]).float().mean().item()}
            for n in k1}


def phase_hm_kernels():
    """K4 against its plain version at every HM_CHECKS geometry, bf16 and
    f32: main_path's bounds, the planted faults rejected. Times at the
    runner's decoder shape, and K1's numerics against K4's there."""
    errors, timings = {}, {}
    for i, (geo, (B, H, N)) in enumerate(HM_CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = hm_inputs(B * H, N, dtype, i, "cuda")
            got, want = hm_attention_against_plain(q, k, v, SCALE)
            torch.cuda.synchronize()
            res = check_against_plain(got, want)
            res["planted"] = {}
            for fault, outputs in hm_planted_faults(got).items():
                caught = compare_with_plain(outputs, want)
                if not caught["beyond_bounds"]:
                    raise AssertionError(
                        f"the bounds let a planted fault pass: {fault} "
                        f"({geo}, {dtype})")
                res["planted"][fault] = caught["beyond_bounds"]
            emit("hm_kernels_vs_plain", geometry=geo, B=B, H=H, N=N, D=D,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if geo == "runner_decoder" and dtype == torch.bfloat16:
                err = res["max_abs_err"]
                errors = {"hm_attn_fwd": err["out"],
                          "hm_attn_bwd_dkv": max(err["dk"], err["dv"]),
                          "hm_attn_bwd_dq": err["dq"]}
                timings = time_hm_kernels(q, k, v, B, H)
                emit("hm_kernel_times", geometry=geo, B=B, H=H, N=N, D=D,
                     dtype="bfloat16", times=timings)
            del q, k, v, got, want
    B, H, N = HM_CHECKS["runner_decoder"]
    emit("k1_vs_k4", B=B, H=H, N=N, D=D,
         **{str(dt).replace("torch.", ""): k1_vs_k4(B, H, N, dt)
            for dt in (torch.bfloat16, torch.float32)})
    return errors, timings


def phase_runner(smi: str) -> dict:
    """The main path of this slice: the ViT-S MOFO pretrain runner, 2
    epochs, then resumed for a third."""
    calls = []
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for epochs in (2, 3):
            args = pretrain_mofo.get_args(
                RUNNER_ARGS + ["--epochs", str(epochs), "--output_dir", out],
                mofo_defaults=True)
            t0 = time.perf_counter()
            state = pretrain_mofo.main(args)
            torch.cuda.synchronize()
            calls.append({"epochs": epochs, "steps_after": state.step,
                          "seconds": time.perf_counter() - t0})
        launches = dict(fa.launch_counts)
        with open(os.path.join(out, "log.txt")) as f:
            log = [json.loads(line) for line in f]
        ckpts = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
    steps = calls[-1]["steps_after"]
    per_step = {k: v / steps for k, v in launches.items()}
    want = STEP_LAUNCHES[VITS_MODEL]
    if [c["steps_after"] for c in calls] != [4, 6]:
        raise AssertionError(f"the runner took other steps: {calls}")
    if [line["epoch"] for line in log] != [0, 1, 2]:
        raise AssertionError(f"log.txt holds other epochs: {log}")
    if ckpts != [f"checkpoint-{e}.pth" for e in range(3)]:
        raise AssertionError(f"checkpoints {ckpts}")
    if not all(np.isfinite(line["train_loss"]) for line in log):
        raise AssertionError(f"non-finite losses: {log}")
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    emit("runner", model=VITS_MODEL, dtype="bfloat16", batch=VITS_BATCH,
         args=RUNNER_ARGS, calls=calls, launches=launches,
         launches_per_step=per_step,
         epochs=[{k: line[k] for k in ("epoch", "train_loss", "step_s",
                                       "data_wait_s")} for line in log],
         step_ms=[line["step_s"] * 1e3 for line in log],
         loader_wait_ms=[line["data_wait_s"] * 1e3 for line in log],
         checkpoints=ckpts, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return launches


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    errors, timings = phase_kernels()
    mh_errors, mh_timings = phase_mh_kernels()
    launches = phase_step(smi)
    phase_parity()
    ft_launches = phase_finetune_step(smi)
    phase_finetune_parity()
    hm_errors, hm_timings = phase_hm_kernels()
    vits_launches = phase_step(smi, "vits_step", VITS_MODEL, VITS_BATCH)
    phase_parity("vits_parity", VITS_MODEL, fa.QKV_KERNELS + fa.HM_KERNELS)
    runner_launches = phase_runner(smi)
    kernels = []
    for name in fa.QKV_KERNELS:
        dec = timings["decoder"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors["decoder"][name], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "shape": "decoder (B=%d, N=%d, H=%d, D=%d) bf16" % (
                *MAIN["decoder"], D),
            "launches_finetune": ft_launches[name],
            "launches_vits_step": vits_launches[name],
            "launches_runner": runner_launches[name],
            **{geo: {**timings[geo][name],
                     "max_abs_err": errors[geo][name]}
               for geo in ("encoder", "backbone")},
        })
    for name in fa.MH_KERNELS:
        mca = mh_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": ft_launches[name],
            "max_abs_err": mh_errors[name], "ms": mca["ms"],
            "plain_ms": mca["plain_ms"], "bound_ms": mca["bound_ms"],
            "bound_by": mca["bound_by"], "library_ms": mca["library_ms"],
            "shape": "MCA (B=%d, N=%d, H=%d, D=%d) bf16, kv bias" % (
                MH_CHECKS["mca"]),
        })
    for name in fa.HM_KERNELS:
        dec = hm_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": runner_launches[name],
            "max_abs_err": hm_errors[name], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "shape": "ViT-S runner decoder (B=%d, H=%d, N=%d, D=%d) bf16"
                     % (*HM_CHECKS["runner_decoder"], D),
            "launches_vits_step": vits_launches[name],
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
