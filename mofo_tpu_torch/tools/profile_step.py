"""Profile the ViT-B MOFO pretrain step, the ViT-S one, or the BB-focused
MCA finetune step, on the GPU with torch.profiler.

    python -m mofo_tpu_torch.tools.profile_step [--vits | --finetune
        [--augment]] [--batch B] [--steps 3] [--trace OUT.json]

Counterpart of tools/profile_step.py. Runs the step of chip_smoke.py's
phase `step` (main_path.build_step: bf16, tube_bb masks, motion-weighted
loss, AdamW; B=16 by default), with --vits of its phase `vits_step` (the
same step at ViT-S width, B=32 by default) or, with --finetune, of its phase
`finetune_step` (main_path.build_finetune_step: bf16, mixup, drop path,
AdamW with layer decay; B=10 by default) and with --finetune --augment the
finetune runner's step (the same on uint8 clips of 16 x 256 x 320 that the
step augments first, as cli.finetune does), warms it up, then traces a few
steps and prints one JSON line: host time per step, device kernel time per step
and the device's busy share, the time of each kernel group (the port's
attention kernels, the GEMMs, the rest), the top kernels and every kernel
instance of the port by name. --trace writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mofo_tpu_torch.ops.flash_attention import KERNELS
from mofo_tpu_torch.tools.main_path import (
    VITS_MODEL,
    build_finetune_step,
    build_step,
)


# the instances of the shared bf16 backward kernels (wgmma_attn_bwd.cuh) by
# their demangled or mangled template arguments: base e is K4's, the bias
# flag (the last argument) and the prep pass at 32 chunks a head K3's
_BASE_E = re.compile(r"bwd_d(kv|q)_bf16(<true|ILb1)")
_BIAS = re.compile(r"bwd_d(kv|q)_bf16(<[^>]*true>|I(Lb[01]E)+Lb1EE)")
_PREP_K3 = re.compile(r"bwd_prep_bf16(<32>|ILi32E)")
# the f32 forwards shared across families: K1's narrow kernel with the bias
# flag set is K3's; the column-split one in two passes is K4's, in one K3's
_FWD_F32_BIAS = re.compile(r"fwd_f32(<\d+, true>|ILi\d+ELb1E)")
_SPLIT_FWD_TWO_PASS = re.compile(r"split_fwd_tf32(<\d+, true>|ILi\d+ELb1E)")


def _group(name: str) -> str:
    low = name.lower()
    if "hm_fwd_" in name or "hm_bwd_" in name or _BASE_E.search(name) or \
            _SPLIT_FWD_TWO_PASS.search(name):
        return "head-major attention, K4 (port kernels)"
    if "mh_fwd_" in name or "mh_bwd_" in name or _BIAS.search(name) or \
            _PREP_K3.search(name) or _FWD_F32_BIAS.search(name) or \
            "split_fwd_tf32" in name:
        return "masked attention, K3 (port kernels)"
    if "bwd_prep_bf16" in name:  # one kernel, launched by K2 and by K4
        return "backward prep pass, K2 and K4 (port kernels)"
    if any(k in name for k in ("fwd_bf16", "bwd_dkv_bf16",
                               "bwd_dq_bf16", "fwd_f32", "bwd_dkv_f32",
                               "bwd_dq_f32")):
        return "attention, K1/K2 (port kernels)"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
        return "gemm (cuBLAS)"
    if "foreach" in low or "multi_tensor" in low:
        return "foreach"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--finetune", action="store_true")
    which.add_argument("--vits", action="store_true")
    ap.add_argument("--augment", action="store_true",
                    help="with --finetune: augment uint8 clips in the step")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if args.augment and not args.finetune:
        ap.error("--augment goes with --finetune")

    if args.finetune:
        B = args.batch or 10
        _, state, step_fn, gen, batch, _ = build_finetune_step(
            B, augment=args.augment)
        step = lambda st: step_fn(st, batch, gen)  # noqa: E731
    else:
        B = args.batch or (32 if args.vits else 16)
        _, state, step_fn, gen, batch = build_step(
            B, VITS_MODEL) if args.vits else build_step(B)
        step = lambda st: step_fn(st, batch, gen, 0.5)  # noqa: E731

    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(ev.name, [0.0, 0])
            kernels[ev.name][0] += (ev.time_range.elapsed_us() / 1e3
                                   / args.steps)
            kernels[ev.name][1] += 1
    device_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "step": ("finetune, augmented in the step" if args.augment else
                 "finetune" if args.finetune else
                 "pretrain ViT-S" if args.vits else "pretrain"), "batch": B,
        "steps": args.steps, "host_ms_per_step": host_ms,
        "device_kernel_ms_per_step": device_ms,
        "device_busy_share": device_ms / host_ms,
        "launches_per_step": sum(n for _, n in kernels.values())
        / args.steps,
        "groups_ms_per_step": groups,
        "top_kernels_ms_per_step": [
            {"name": n[:120], "ms": ms, "calls": c / args.steps}
            for n, (ms, c) in top
        ],
        "port_kernels": list(KERNELS),
        "port_kernels_ms_per_step": [
            {"name": n[:160], "ms": ms, "calls": c / args.steps}
            for n, (ms, c) in sorted(kernels.items())
            if "port kernels" in _group(n)
        ],
        "loss": float(metrics["loss"]),
    }), flush=True)


if __name__ == "__main__":
    main()
