"""Times the f32 attention path of one checkout of this repository on the
card, so that two checkouts (a parent and its change) can be compared in
one call, alternated parent, change, change, parent:

    python mofo_tpu_torch/tools/f32_ab.py --root <checkout> \
        [--only name,name] [--out f.json]

It imports `mofo_tpu_torch` and `chip_smoke.py` from <checkout> (so each
checkout builds and runs its own kernels, into its own build directory),
takes the MEASUREMENTS named by --only (all by default), and prints one
JSON line, also written to --out: the card's name and power limit, the
build's seconds and, under "results", each measurement by name. A new
measurement is a new row of MEASUREMENTS; the rows stay, so that a later
change can be timed against every path that an earlier one claimed.

A row is (kind, shape, dtype). The kinds:

- `qkv`: K1's forward and K2's dK/dV and dQ (the f32 delta reduction as
  "delta_ms"; in bf16 the prep pass), the plain versions and the library's
  call (`F.scaled_dot_product_attention`, its backward through
  `torch.autograd.grad`), each beside its bound (chip_smoke.time_kernels),
  on a (B, N, 3 H D) qkv at (B, N, H, D). Above D = 128 K1/K2 run K3's
  kernels through its entry points.
- `k3`: K3's kernels with the kv bias the same way
  (chip_smoke.time_mh_kernels) on main_path.mh_inputs at (B, N, H, D).
- `hm`: K4's kernels the same way (chip_smoke.time_hm_kernels) on
  main_path.hm_inputs at (B*H, N, D).
- `classifier_forward`: feature_extract's forward (its default model at
  batch B, 16 x 224^2 clips, no grad), ms a batch and its launches.
- `pretrain_step`: one MOFO pretrain step at B (main_path.build_step;
  shape (B,) ViT-B, or (B, model name)), ms and launches.
- `bb_step`: one ViT-B BB-focused MCA finetune step at B
  (main_path.build_finetune_step, 174 classes; shape (B,) or (B,
  mca_num_heads)), ms and launches a step.
- `vis`: cli/vis.py on ViT-B, seconds a call.

Each kernel row carries two bounds (chip_smoke's, at PEAK_TF32X3 in f32):
bound_ms, the work at its least, and bound_recompute_ms, the products the
column-split kernels do above head dim 256 (chip_smoke.products at
split_groups(D) output groups; the least work at or below 256). K4's f32
forward up to 256 also carries bound_two_pass_ms: its two passes form S
twice (chip_smoke.products(1, two_pass=True), 3 products).

Kernel times are chip_smoke.time_ms's medians; model-level times are
medians of REPS timed calls after one warm-up. Only what both checkouts
share is used: the wrappers of `ops/flash_attention.py`,
`main_path.build_step` / `build_finetune_step` / `mh_inputs` /
`hm_inputs`,
`create_model`, `cli.vis` and chip_smoke's timing and video helpers. No
card: exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

MEASUREMENTS = {
    # K1/K2 at head dim 64, and the f32 paths that run them
    "decoder": ("qkv", (16, 1568, 6, 64), "float32"),
    "backbone": ("qkv", (10, 1568, 12, 64), "float32"),
    "res512": ("qkv", (1, 8192, 16, 64), "float32"),
    "decoder_bf16": ("qkv", (16, 1568, 6, 64), "bfloat16"),
    "classifier_forward": ("classifier_forward", (4,), "float32"),
    "pretrain_step": ("pretrain_step", (16,), "float32"),
    "vis": ("vis", (), "float32"),
    # K3 at the ViT-B BB-focused MCA (3 heads of 256) and at 4 heads of
    # 192; K1/K2 at 256, through K3's entry points
    "mca": ("k3", (10, 1568, 3, 256), "float32"),
    "mca_h4": ("k3", (10, 1568, 4, 192), "float32"),
    "mca_bf16": ("k3", (10, 1568, 3, 256), "bfloat16"),
    "d256": ("qkv", (10, 1568, 3, 256), "float32"),
    "bb_step": ("bb_step", (10,), "float32"),
    # K3 with the BB-focused MCA at 8 and 16 heads (D = 128 and 64, the
    # narrow kernels) and at 2 heads (D = 384, the column-split kernels)
    "mca_h8": ("k3", (10, 1568, 8, 128), "float32"),
    "mca_h16": ("k3", (10, 1568, 16, 64), "float32"),
    "mca_h2": ("k3", (10, 1568, 2, 384), "float32"),
    # the column-split kernels' other paths: the MCA at 1 head (D = 768),
    # at 3 heads of ViT-L width (341, zero-padded to 384), K4 at D = 512,
    # and the f32 BB-focused step with the MCA at 2 heads
    "mca_h1": ("k3", (10, 1568, 1, 768), "float32"),
    "vitl_mca_h3": ("k3", (4, 1568, 3, 341), "float32"),
    "hm_d512": ("hm", (4, 1568, 512), "float32"),
    "bb_step_h2": ("bb_step", (10, 2), "float32"),
    # the f32 BB-focused step with the MCA at 8 heads of 128 (K3's narrow
    # f32 forward)
    "bb_step_h8": ("bb_step", (10, 8), "float32"),
    # K4's f32 forward up to 256 (two passes) at the ViT-S decoder (3 x
    # 64 heads, B = 32) and at 128 and 256; the f32 BB-focused step with
    # the MCA at 16 heads of 64; the f32 ViT-S pretrain step, whose
    # decoder launches K4 four times
    "hm_vits": ("hm", (96, 1568, 64), "float32"),
    "hm_d128": ("hm", (48, 1568, 128), "float32"),
    "hm_d256": ("hm", (24, 1568, 256), "float32"),
    "bb_step_h16": ("bb_step", (10, 16), "float32"),
    "vits_step": ("pretrain_step", (32, "pretrain_videomae_small_patch16_224"),
                  "float32"),
}
CLASSIFIER = "vit_base_patch16_224_feature_ext"
REPS = 3  # timed calls after one warm-up (model-level numbers)


def timed(torch, fn) -> dict:
    """One warm-up, REPS timed calls ending in a synchronize: ms."""
    times = []
    for _ in range(1 + REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": statistics.median(times[1:]), "ms_all": times}


def with_recompute(C, res: dict, bound_fn, d: int, dtype: str,
                   *shape) -> dict:
    """Puts bound_fn's least time with the column-split kernels' products
    at head dim d (chip_smoke.split_groups(d) groups; 0 at or below 256)
    into each kernel row of res as bound_recompute_ms, at the dtype's peak
    (PEAK_TF32X3 in f32)."""
    f32 = dtype == "float32"
    for name, (bound, by) in bound_fn(
            *shape, groups=C.split_groups(d), e=4 if f32 else 2,
            peak=C.PEAK_TF32X3 if f32 else C.PEAK_BF16).items():
        if name in res:
            res[name].update(bound_recompute_ms=bound,
                             bound_recompute_by=by)
    return res


def measure(kind: str, shape: tuple, dtype: str) -> dict:
    """One row of MEASUREMENTS on the card (the checkout's modules are on
    sys.path)."""
    import torch

    import chip_smoke as C
    from mofo_tpu_torch.ops import flash_attention as fa
    from mofo_tpu_torch.tools import main_path

    dt = getattr(torch, dtype)
    if kind == "qkv":
        B, N, H, D = shape
        return with_recompute(C, C.time_kernels(
            C._qkv(B, N, H, dt, seed=1, d=D), H), C.bounds, D, dtype,
            B, N, H, D)
    if kind == "k3":
        B, N, H, D = shape
        q, k, v, b = main_path.mh_inputs(B, N, H, D, dt, 0, "cuda")
        return with_recompute(C, C.time_mh_kernels(q, k, v, b, H, D),
                              C.bounds_mh, D, dtype, B, N, H, D)
    if kind == "hm":
        BH, N, D = shape
        q, k, v = main_path.hm_inputs(BH, N, dt, 0, "cuda", D=D)
        res = with_recompute(C, C.time_hm_kernels(q, k, v, 1, BH),
                             C.bounds_hm, D, dtype, BH, N, D)
        if D <= fa.HEAD_DIMS[-1] and dtype == "float32":
            # the two passes' floor: S twice and P V, products(1, True)
            res["hm_attn_fwd"]["bound_two_pass_ms"] = C.bounds_hm(
                BH, N, D, groups=1, e=4,
                peak=C.PEAK_TF32X3)["hm_attn_fwd"][0]
        return res
    if kind == "classifier_forward":
        from mofo_tpu_torch.models import create_model

        gen = torch.Generator(device="cuda").manual_seed(0)
        model = create_model(CLASSIFIER, device="cuda", seed=1,
                             num_classes=0)
        model.eval()
        clips = main_path.synthetic_batch(shape[0], gen, "cuda")["clip"]
        fa.reset_launch_counts()
        with torch.no_grad():
            res = timed(torch, lambda: model(clips, return_features=True))
        return dict(res, launches=dict(fa.launch_counts))
    if kind == "pretrain_step":
        _, state, step, gen, batch = main_path.build_step(
            shape[0], *shape[1:], dtype=dtype)
        box = {"state": state}

        def one_step():
            box["state"], _ = step(box["state"], batch, gen, 0.5)
        fa.reset_launch_counts()
        res = timed(torch, one_step)
        return dict(res, launches=dict(fa.launch_counts))
    if kind == "bb_step":
        _, state, step, gen, batch, _ = main_path.build_finetune_step(
            shape[0], dtype=dtype,
            mca_num_heads=shape[1] if len(shape) > 1 else 3)
        box = {"state": state}

        def one_step():
            box["state"], box["metrics"] = step(box["state"], batch, gen)
        fa.reset_launch_counts()
        res = timed(torch, one_step)
        return dict(res, launches_per_step={
            k: n // (1 + REPS) for k, n in fa.launch_counts.items() if n},
            loss=float(box["metrics"]["loss"]))
    if kind == "vis":
        from mofo_tpu_torch.cli import vis
        from mofo_tpu_torch.data.video_reader import VideoReader

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "v0.mp4")
            C.write_memory_video(path)
            card = []
            for i in range(2):  # a warm-up call, then the timed one
                _, _, card_s = C._quiet_main(vis.main, vis.get_args(
                    ["--img_path", path, "--model", main_path.MODEL,
                     "--save_path", os.path.join(tmp, f"card{i}")]),
                    VideoReader)
                card.append(card_s)
        return {"card_s": card[-1], "card_s_all": card}
    raise ValueError(f"no measurement of kind {kind}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="the checkout whose package and kernels to time")
    p.add_argument("--only", default=",".join(MEASUREMENTS),
                   help="comma-separated names of MEASUREMENTS")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    names = args.only.split(",")
    unknown = [n for n in names if n not in MEASUREMENTS]
    if unknown:
        p.error(f"no measurement named {unknown}; "
                f"the names: {list(MEASUREMENTS)}")
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("f32_ab: no CUDA device", file=sys.stderr)
        return 2
    from mofo_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    built = _build.build()
    _build.load()
    res = {"root": root, "nvidia_smi": smi, "build_s": built["seconds"],
           "results": {}}
    for name in names:
        res["results"][name] = measure(*MEASUREMENTS[name])
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
