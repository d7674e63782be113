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


# Every kernel that csrc/ defines, by name: (the template argument that
# says base e or two passes, i.e. K4; the one that is the kv-bias flag, i.e.
# K3; the families that launch it otherwise). An instance whose name cannot
# tell its family goes into the group of all the families that launch it:
# the unbiased f32 dK/dV and dQ, for one, are K2's, K3's without a kv bias
# and K4's (its (BH, N, D) planes as K3's at H = 1).
_CSRC_KERNELS = {
    # bf16 (wgmma_tiles.cuh and the wgmma_attn_*.cuh kernels)
    "fwd_bf16": (None, None, "K1"),
    "hm_fwd_bf16": (None, None, "K4"),
    "hm_fwd_wide_bf16": (None, None, "K4"),
    "bwd_prep_bf16": (None, None, "K2, K3 and K4"),
    "bwd_prep_wide_bf16": (None, None, "K2, K3 and K4"),
    "bwd_dkv_bf16": (0, 1, "K2"),  # <kBaseE, kBias, D>
    "bwd_dq_bf16": (0, 2, "K2"),  # <kBaseE, kScaledCopy, kBias, D>
    "strip_fwd_bf16": (None, None, "K1 and K3"),
    "strip_bwd_dkv_bf16": (1, None, "K2 and K3"),  # <D, kBaseE>
    "strip_bwd_dq_bf16": (1, None, "K2 and K3"),
    "split_fwd_bf16": (0, None, "K1 and K3"),  # <kBaseE>
    "split_bwd_dkv_bf16": (0, None, "K2 and K3"),
    "split_bwd_dq_bf16": (0, None, "K2 and K3"),
    # f32, 3xTF32 (the wgmma_tf32_*.cuh kernels)
    "fwd_f32": (2, 1, "K1"),  # <D, kBias, kTwoPass>
    "bwd_dkv_f32": (None, 1, "K2, K3 and K4"),  # <D, kBias>
    "mh_dq_f32": (None, 1, "K2, K3 and K4"),  # <D, kBias>
    "mh_fwd_tf32": (None, None, "K1 and K3"),
    "mh_dkv_tf32": (None, None, "K2, K3 and K4"),
    "mh_dq_tf32": (None, None, "K2, K3 and K4"),
    "split_fwd_tf32": (1, None, "K1 and K3"),  # <NG, kTwoPass>
    "split_dkv_tf32": (None, None, "K2, K3 and K4"),
    "split_dq_tf32": (None, None, "K2, K3 and K4"),
}
_FAMILY_GROUPS = {"K1": "attention, K1/K2 (port kernels)",
                  "K2": "attention, K1/K2 (port kernels)",
                  "K3": "masked attention, K3 (port kernels)",
                  "K4": "head-major attention, K4 (port kernels)"}
# the kernels live in anonymous namespaces: "void (anonymous
# namespace)::name<64, false>(...)" demangled; mangled "_ZN", the
# namespace's length and name (nvcc's "_GLOBAL__N__<hash>_<file>_cu_<hash>",
# gcc's "_GLOBAL__N_1"), the kernel's length and name, "I...E" (Li64E, Lb0E)
_DEMANGLED = re.compile(r"\(anonymous namespace\)::(\w+)(?:<([^<>]*)>)?\(")
_MANGLED = re.compile(r"_ZN(\d+)_GLOBAL__N_")


def _kernel(name: str):
    """(csrc kernel name, its template arguments as ints) or None."""
    m = _DEMANGLED.search(name)
    if m:
        args = [a.strip() for a in (m.group(2) or "").split(",") if a]
        return m.group(1), [int(a == "true") if a in ("true", "false")
                            else int(a) for a in args]
    m = _MANGLED.search(name)
    n = m and re.match(r"\d+", name[m.end(1) + int(m.group(1)):])
    if n:
        start = n.end() + m.end(1) + int(m.group(1))
        base = name[start:start + int(n.group())]
        args = re.match(r"I((?:L[ib]\d+E)+)E", name[start + len(base):])
        return base, [int(a) for a in re.findall(
            r"L[ib](\d+)E", args.group(1) if args else "")]
    return None


def _group(name: str) -> str:
    kernel = _kernel(name)
    if kernel and kernel[0] in _CSRC_KERNELS:
        base, args = kernel
        k4_arg, bias_arg, families = _CSRC_KERNELS[base]
        if k4_arg is not None and k4_arg < len(args) and args[k4_arg]:
            families = "K4"
        elif bias_arg is not None and bias_arg < len(args) and \
                args[bias_arg]:
            families = "K3"
        return _FAMILY_GROUPS.get(
            families, f"attention shared by {families} (port kernels)")
    low = name.lower()
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
