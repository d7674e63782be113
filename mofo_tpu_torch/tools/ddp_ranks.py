"""The rank processes of chip_smoke.py's data-parallel phases.

  python -m mofo_tpu_torch.tools.ddp_ranks check <dir>
      (RANK, WORLD_SIZE and LOCAL_RANK set) one rank of phase
      ddp_two_ranks: joins a gloo group through a FileStore in <dir> on its
      CUDA device (NCCL refuses two ranks on one device), runs
      `two_rank_runs` on its rows of the global batch G', holds its final
      parameters against <dir>/reference.pt (the single process's at G')
      and saves its results and kernel launch counts to <dir>/rank-<r>.pt.
  python -m mofo_tpu_torch.tools.ddp_ranks cli <counts.json> <runner> ...
      runs mofo_tpu_torch.cli.<runner>'s main (pretrain, pretrain_mofo,
      finetune or finetune_mofo) on the remaining arguments,
      as `python -m mofo_tpu_torch.cli.<runner> ...` does, and writes this
      process's kernel launch counts to counts.json: phase ddp_runner
      starts it under torch.distributed.run, tools/overfit_real.py as is.

`two_rank_runs(0, 1)` is the single process at G' that chip_smoke.py holds
the ranks against, on the same card: the ViT-B MOFO pretrain step at full
width, cut to DEPTH Blocks (B=8 a rank, update_freq 2, motion-weighted
loss, masks drawn in the step) for 3 steps in f32 and in bf16, and the
ViT-B BB-focused MCA finetune step at DEPTH[0] Blocks (f32, 10 classes,
B=5 a rank, RandAugment,
crop, flip, erasing, mixup elem with cutmix, drop path 0.1) for 2 steps,
then one validation pass and the multi-view merge of its views.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path as mp

WORLD = 2
# the ViT-B (encoder, decoder) Blocks of the runs: every layer kind at full
# width; full depth (12, 4) spent the script's time on gloo
DEPTH = (4, 2)
PRETRAIN_BK = (8, 2)  # a rank's batch and update_freq
FINETUNE_B = 5
STEPS = {"pretrain": 3, "finetune": 2}
DTYPES = ("float32", "bfloat16")
NUM_CLASSES = 10  # of the finetune runs


def eval_views(G: int, generator: torch.Generator, num_classes: int) -> dict:
    """G' of validation views: normalized clips, boxes and labels, the last
    row padding (valid False), and view tags in which one row repeats
    another's (video, chunk, split)."""
    batch = mp.synthetic_finetune_batch(G, generator, "cuda", num_classes)
    vid = torch.arange(G, device="cuda") // 2
    vid[G - 2] = 0  # repeats one of video 0's two views
    batch.update(valid=torch.arange(G, device="cuda") < G - 1,
                 video_idx=vid, chunk_nb=torch.zeros_like(vid),
                 split_nb=torch.arange(G, device="cuda") % 2)
    return batch


def two_rank_runs(rank: int, world: int) -> dict:
    """The runs of phase ddp_two_ranks on rank `rank` of `world` ranks
    (through DDP on its rows of G'), or with world 1 on all of G' in one
    process. Returns {run: main_path's results} for pretrain_float32,
    pretrain_bfloat16 and finetune_float32, and the kernel launches."""
    wrap = world > 1
    fa.reset_launch_counts()
    out = {}
    B, k = PRETRAIN_BK
    for dtype in DTYPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = mp.synthetic_batch(WORLD * B, gen, "cuda")
        if wrap:
            batch = mp.rank_batch(batch, rank, WORLD, k)
        cfg = PretrainConfig(model=mp.MODEL, batch_size=len(batch["clip"]),
                             update_freq=k, dtype=dtype,
                             masking=MaskingConfig(mask_type="tube_bb"),
                             motion_loss_weight=True)
        model = create_model(mp.MODEL, device="cuda", seed=1,
                             dtype=getattr(torch, dtype),
                             encoder_depth=DEPTH[0], decoder_depth=DEPTH[1])
        out[f"pretrain_{dtype}"] = mp.pretrain_steps(
            model, cfg, batch, STEPS["pretrain"], wrap=wrap)
        del model, batch
    gen = torch.Generator(device="cuda").manual_seed(1)
    # 10 classes, so that the views' Acc@1 and Acc@5 are neither 0 nor 100
    cfg = FinetuneConfig(model=mp.FINETUNE_MODEL, dtype="float32",
                         mixup_mode="elem", nb_classes=NUM_CLASSES,
                         batch_size=FINETUNE_B * (1 if wrap else WORLD))
    batch = mp.synthetic_clips_u8(WORLD * FINETUNE_B, gen, "cuda",
                                  cfg.nb_classes)
    views = eval_views(WORLD * FINETUNE_B, gen, cfg.nb_classes)
    if wrap:
        batch = mp.rank_batch(batch, rank, WORLD)
        views = mp.rank_batch(views, rank, WORLD)
    out["finetune_float32"] = mp.finetune_steps(
        mp.finetune_model(cfg, depth=DEPTH[0]), cfg, batch, STEPS["finetune"],
        wrap=wrap, augment=True, eval_batch=views)
    out["launches"] = dict(fa.launch_counts)
    return out


def _check(out_dir: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init_distributed_mode(
        verbose=False, device="cuda", backend="gloo",
        init_method=f"file://{os.path.join(out_dir, 'store')}")
    rank, world = distributed.process_index(), distributed.process_count()
    try:
        out = two_rank_runs(rank, world)
    finally:
        distributed.destroy()
    reference = torch.load(os.path.join(out_dir, "reference.pt"))
    for run, want in reference.items():
        got = out[run].pop("params")
        out[run]["params_max_abs_err"] = max(
            (got[n] - v).abs().max().item() for n, v in want.items())
    torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))


def _cli(counts_path: str, runner: str, argv: list) -> None:
    import importlib

    cli = importlib.import_module(f"mofo_tpu_torch.cli.{runner}")
    kw = {"pretrain_mofo": {"mofo_defaults": True},
          "finetune_mofo": {"bb_defaults": True}}.get(runner, {})
    fa.reset_launch_counts()
    cli.main(cli.get_args(argv, **kw))
    with open(counts_path, "w") as f:
        json.dump(fa.launch_counts, f)


if __name__ == "__main__":
    if sys.argv[1] == "check":
        _check(sys.argv[2])
    elif sys.argv[1] == "cli":
        _cli(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}: check or cli")
