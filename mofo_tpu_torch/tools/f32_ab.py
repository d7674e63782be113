"""Times the f32 attention path of one checkout of this repository on the
card, so that two checkouts (a parent and its change) can be compared in
one call, alternated parent, change, change, parent:

    python mofo_tpu_torch/tools/f32_ab.py --root <checkout> [--out f.json]

It imports `mofo_tpu_torch` and `chip_smoke.py` from <checkout> (so each
checkout builds and runs its own kernels, into its own build directory)
and prints one JSON line, also written to --out:

- `kernels`: K1's forward and K2's dK/dV and dQ in f32 (the backward's
  delta reduction, `fa._qkv_prep`, as "delta_ms"), and the library's f32
  call on the same inputs (`F.scaled_dot_product_attention`, its backward
  through `torch.autograd.grad`), at the ViT-B decoder (16, 1568, 6), the
  finetune backbone (10, 1568, 12) and vit_large_patch16_512's grid (1,
  8192, 16), D = 64; K1/K2's bf16 kernels at the decoder beside them;
- `classifier_forward`: feature_extract's forward (its default model,
  vit_base_patch16_224_feature_ext, at its default batch 4, 16 x 224^2
  clips, f32, no grad), ms a batch and its launches;
- `pretrain_step`: one f32 ViT-B MOFO pretrain step at B = 16
  (`main_path.build_step`), ms and launches;
- `vis_card_s`: cli/vis.py on ViT-B, seconds a call.

Times are chip_smoke.time_ms's medians (kernels) and medians of timed
calls after one warm-up (the rest), with the card's name and power limit.
Only what both checkouts share is used: the wrappers of
`ops/flash_attention.py`, `main_path.build_step`, `create_model`,
`cli.vis` and chip_smoke's timing and video helpers. No card: exit 2.
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

GEOMETRIES = {"decoder": (16, 1568, 6), "backbone": (10, 1568, 12),
              "res512": (1, 8192, 16)}
HEAD_DIM = 64
CLASSIFIER = "vit_base_patch16_224_feature_ext"
CLASSIFIER_BATCH = 4
STEP_BATCH = 16
REPS = 3  # timed calls after one warm-up (model-level numbers)


def kernel_times(C, fa, F, torch, B, N, H, dtype) -> dict:
    """ms of K1's forward, K2's dK/dV and dQ (and in f32 the delta
    reduction; in bf16 the prep pass) and the library's forward and
    backward on one qkv."""
    scale = HEAD_DIM ** -0.5
    x = C._qkv(B, N, H, dtype, seed=1)
    out, lse = fa.qkv_attn_fwd(x, scale, H)
    dout = (2 * out.float()).to(dtype)
    dqkv = torch.empty_like(x)
    prep = fa._qkv_prep(x, out, dout, scale, H)
    q, k, v = (t.contiguous().requires_grad_(True)
               for t in fa.split_heads(x, H))
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=scale)
    g_lib = dout.reshape(B, N, H, HEAD_DIM).transpose(1, 2).contiguous()
    res = {
        "fwd_ms": C.time_ms(lambda: fa.qkv_attn_fwd(x, scale, H)),
        "dkv_ms": C.time_ms(lambda: fa.qkv_attn_bwd_dkv(
            x, out, lse, dout, dqkv, scale, H, prep)),
        "dq_ms": C.time_ms(lambda: fa.qkv_attn_bwd_dq(
            x, out, lse, dout, dqkv, scale, H, prep)),
        ("delta_ms" if dtype == torch.float32 else "prep_ms"): C.time_ms(
            lambda: fa._qkv_prep(x, out, dout, scale, H)),
        "library_fwd_ms": C.time_ms(lambda: F.scaled_dot_product_attention(
            q.detach(), k.detach(), v.detach(), scale=scale)),
        "library_bwd_ms": C.time_ms(lambda: torch.autograd.grad(
            o_lib, (q, k, v), g_lib, retain_graph=True)),
    }
    return res


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="the checkout whose package and kernels to time")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("f32_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from mofo_tpu_torch.cli import vis
    from mofo_tpu_torch.data.video_reader import VideoReader
    from mofo_tpu_torch.models import create_model
    from mofo_tpu_torch.ops import _build
    from mofo_tpu_torch.ops import flash_attention as fa
    from mofo_tpu_torch.tools import main_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    built = _build.build()
    _build.load()
    res = {"root": root, "nvidia_smi": smi, "build_s": built["seconds"],
           "kernels": {}}
    for geo, (B, N, H) in GEOMETRIES.items():
        res["kernels"][geo] = kernel_times(C, fa, F, torch, B, N, H,
                                           torch.float32)
    B, N, H = GEOMETRIES["decoder"]
    res["kernels"]["decoder_bf16"] = kernel_times(C, fa, F, torch, B, N, H,
                                                  torch.bfloat16)

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_model(CLASSIFIER, device="cuda", seed=1, num_classes=0)
    model.eval()
    clips = main_path.synthetic_batch(CLASSIFIER_BATCH, gen, "cuda")["clip"]
    fa.reset_launch_counts()
    with torch.no_grad():
        res["classifier_forward"] = timed(
            torch, lambda: model(clips, return_features=True))
    res["classifier_forward"]["launches"] = dict(fa.launch_counts)
    del model, clips

    _, state, step, gen, batch = main_path.build_step(STEP_BATCH,
                                                      dtype="float32")
    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], batch, gen, 0.5)

    fa.reset_launch_counts()
    res["pretrain_step"] = timed(torch, one_step)
    res["pretrain_step"]["launches"] = dict(fa.launch_counts)
    del state, step, batch, box

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v0.mp4")
        C.write_memory_video(path)
        card = []
        for i in range(2):  # a warm-up call, then the timed one
            _, _, card_s = C._quiet_main(vis.main, vis.get_args(
                ["--img_path", path, "--model", main_path.MODEL,
                 "--save_path", os.path.join(tmp, f"card{i}")]), VideoReader)
            card.append(card_s)
    res["vis_card_s"] = card[-1]
    res["vis_card_s_all"] = card
    line = json.dumps(res)
    print(line, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
