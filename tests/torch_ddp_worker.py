"""Rank processes of tests/test_torch_ddp.py and tests/test_torch_ddp_cli.py.

    python tests/torch_ddp_worker.py <tasks> <dir>     (RANK, WORLD_SIZE set)

joins a gloo process group through a FileStore in <dir>, runs each of the
comma-separated <tasks> and saves what each returns to
<dir>/<task>-<rank>.pt. It imports torch and mofo_tpu_torch only, never JAX
or tests/conftest.py. The models, configurations and global batches G' are
built here from seeds, so that the tests' single-process references at G'
run the same code; the steps are mofo_tpu_torch.tools.main_path's.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mofo_tpu_torch.core import distributed  # noqa: E402
from mofo_tpu_torch.core.config import (  # noqa: E402
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model  # noqa: E402
from mofo_tpu_torch.parallel import ddp  # noqa: E402
from mofo_tpu_torch.tools import main_path as mp  # noqa: E402
from mofo_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from mofo_tpu_torch.train import metrics as M  # noqa: E402
from mofo_tpu_torch.train import optim  # noqa: E402
from mofo_tpu_torch.train.finetune_step import make_finetune_step  # noqa
from mofo_tpu_torch.train.loss_scale import DynamicLossScale  # noqa: E402
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step  # noqa
from mofo_tpu_torch.train.train_state import TrainState  # noqa: E402

PRETRAIN = "pretrain_videomae_base_patch16_224"
PRETRAIN_GEO = dict(img_size=32, num_frames=4, encoder_embed_dim=64,
                    encoder_depth=2, encoder_num_heads=2,
                    decoder_embed_dim=32, decoder_depth=1,
                    decoder_num_heads=2, decoder_num_classes=1536)
BB = "vit_base_patch16_224_BB_focused"
NC = 7
BB_GEO = dict(img_size=32, all_frames=4, embed_dim=128, depth=2,
              num_heads=2, num_classes=NC, init_scale=1.0,
              fusing_method="MCA", mca_num_heads=2, drop_path_rate=0.1)
DECODE = (40, 48)  # (h, w) of the uint8 clips the augmentations crop
STEPS = 3
# adahessian's eps in the rank checks: at 1e-8 an update divides by probe
# elements (1e-8) smaller than the probe's rounding across reduction orders
ADAHESSIAN_EPS = 1e-3
# per world: (local batch, update_freq) of the pretrain and finetune steps
PRETRAIN_BK = {1: (4, 2), 2: (2, 2), 3: (2, 2)}
FINETUNE_BK = {2: (4, 2), 3: (2, 1)}


def pretrain_cfg(B, k):
    return PretrainConfig(
        input_size=32, num_frames=4, batch_size=B, dtype="float32",
        update_freq=k, motion_loss_weight=True,
        masking=MaskingConfig(mask_type="tube_bb", mask_ratio=0.5))


def pretrain_model(**overrides):
    return create_model(PRETRAIN, device="cpu", seed=3, **PRETRAIN_GEO,
                        **overrides)


def finetune_cfg(B, k):
    return FinetuneConfig(model=BB, nb_classes=NC, input_size=32,
                          num_frames=4, batch_size=B, update_freq=k,
                          dtype="float32", drop_path=0.1, mixup_mode="elem",
                          seed=5)


def finetune_model():
    return create_model(BB, device="cpu", seed=4, **BB_GEO)


def _boxes(rng, G, hw):
    h, w = hw
    xy1 = rng.uniform(0, [w / 2, h / 2], (G, 4, 2))
    wh = rng.uniform(6, [w / 2, h / 2], (G, 4, 2))
    return torch.from_numpy(np.concatenate([xy1, xy1 + wh], -1)
                            .astype(np.float32))


def pretrain_batch(G, seed=0):
    """G' of normalized clips (G, 4, 32, 32, 3) and per-frame boxes."""
    rng = np.random.RandomState(seed)
    clip = torch.from_numpy(rng.randn(G, 4, 32, 32, 3).astype(np.float32))
    return {"clip": clip, "boxes": _boxes(rng, G, (32, 32))}


def u8_batch(G, seed=1, labels=False):
    """G' of uint8 clips (G, 4, 40, 48, 3), boxes and, with `labels`,
    labels in [0, NC)."""
    rng = np.random.RandomState(seed)
    out = {"clip": torch.from_numpy(
        rng.randint(0, 256, (G, 4) + DECODE + (3,)).astype(np.uint8)),
        "boxes": _boxes(rng, G, DECODE)}
    if labels:
        out["label"] = torch.from_numpy(rng.randint(0, NC, G))
    return out


def eval_batch(G, seed=2):
    """G' of test views: normalized clips, boxes, labels, the last two rows
    padding (valid False), and view tags in which two videos repeat a
    (chunk, split) view (the sampler's wrap-padding)."""
    rng = np.random.RandomState(seed)
    valid = np.ones(G, bool)
    valid[-2:] = False
    vid = np.arange(G) // 2
    vid[G - 3] = 0  # repeats one of video 0's two views
    return {"clip": torch.from_numpy(
        rng.randn(G, 4, 32, 32, 3).astype(np.float32)),
        "boxes": _boxes(rng, G, (32, 32)),
        "label": torch.from_numpy(rng.randint(0, NC, G)),
        "valid": torch.from_numpy(valid),
        "video_idx": torch.from_numpy(vid),
        "chunk_nb": torch.zeros(G, dtype=torch.int64),
        "split_nb": torch.from_numpy(np.arange(G) % 2)}


def meter_updates(rank):
    """The (n, loss, acc1) updates rank `rank`'s MetricLogger takes."""
    return [(rank + 1 + i, float(rank * 3 + i), float(10 * i - rank))
            for i in range(2 + rank)]


# --- the tasks ----------------------------------------------------------


def task_pretrain(rank, world, out):
    """3 steps on the rank's rows of G' with G''s masks injected (the
    masks mofo_tpu draws), and 3 with the uint8 clips augmented and the
    masks drawn inside the step."""
    B, k = PRETRAIN_BK[world]
    masks = torch.load(os.path.join(out, "masks.pt"))
    rows = torch.from_numpy(ddp.global_rows(rank, world, B, k))
    injected = mp.pretrain_steps(
        pretrain_model(), pretrain_cfg(B, k),
        mp.rank_batch(pretrain_batch(world * B), rank, world, k), STEPS,
        wrap=True, masks=[m[rows] for m in masks])
    drawn = mp.pretrain_steps(
        pretrain_model(), pretrain_cfg(B, k),
        mp.rank_batch(u8_batch(world * B), rank, world, k), STEPS,
        wrap=True, augment=True)
    return {"injected": injected, "drawn": drawn}


def task_finetune(rank, world, out):
    """3 BB-MCA steps on the rank's uint8 rows (RandAugment, crop, flip,
    erasing, mixup elem + cutmix, drop path 0.1), one validation pass and
    the multi-view merge."""
    B, k = FINETUNE_BK[world]
    return mp.finetune_steps(
        finetune_model(), finetune_cfg(B, k),
        mp.rank_batch(u8_batch(world * B, labels=True), rank, world, k),
        STEPS, wrap=True, augment=True,
        eval_batch=mp.rank_batch(eval_batch(world * 4), rank, world))


def task_collectives(rank, world, out):
    """epoch_stats(sync=True) of rank-dependent meters, and
    exchange_flipped of rank-dependent rows."""
    logger = M.MetricLogger()
    for n, loss, acc1 in meter_updates(rank):
        logger.update_weighted(n, loss=loss, acc1=acc1)
    x = torch.arange(3 * world, dtype=torch.float32).reshape(world, 3)
    return {"stats": logger.epoch_stats(sync=True),
            "flipped": ddp.exchange_flipped(x[rank:rank + 1].repeat(2, 1)
                                            + torch.tensor([[0.0], [0.5]]))}


def task_checkpoint(rank, world, out):
    """One DDP step, a save from rank 0, then auto-resume into a model of
    another seed on every rank."""
    B, k = PRETRAIN_BK[world]
    cfg = pretrain_cfg(B, k)
    model = pretrain_model()
    lrs = np.full(2, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lrs)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(ddp.wrap_model(model), tx, cfg, lrs,
                              device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, mp.rank_batch(pretrain_batch(world * B), rank,
                                         world, k), gen, 0.5)
    d = os.path.join(out, "ckpt")
    path = ckpt.save_checkpoint(d, model, state, 0)
    files = sorted(os.listdir(d))
    other = create_model(PRETRAIN, device="cpu", seed=9, **PRETRAIN_GEO)
    tx2 = optim.create_optimizer(dict(other.named_parameters()),
                                 lr_schedule=lrs)
    state2 = TrainState.create(other, tx2)
    epoch = ckpt.auto_resume(d, other, state2)
    same = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), other.state_dict().values()))
    moments = all(torch.equal(state.opt_state.mu[n], state2.opt_state.mu[n])
                  for n in state.opt_state.mu)
    return {"path": path, "files": files, "epoch": epoch, "same": same,
            "moments": moments, "step": state2.step,
            "count": state2.opt_state.count}


def task_loss_scale(rank, world, out):
    """Two fp16-scaled steps: in the first rank 1's clips hold an inf, so
    its gradients and, after DDP's reduction, every rank's are not finite;
    the second is finite everywhere."""
    B, _ = FINETUNE_BK[world]
    cfg = finetune_cfg(B, 1)
    model = finetune_model()
    lrs = np.full(2, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lrs)
    state = TrainState.create(model, tx, loss_scale=DynamicLossScale.create())
    step = make_finetune_step(ddp.wrap_model(model), tx, cfg, lrs,
                              bb_focused=True, device="cpu")
    batch = mp.rank_batch(eval_batch(world * B), rank, world)
    batch = {n: batch[n] for n in ("clip", "boxes", "label")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    bad = dict(batch, clip=batch["clip"].clone())
    if rank == 1:
        bad["clip"][0, 0, 0, 0, 0] = float("inf")
    state, m1 = step(state, bad, gen)
    kept = all(torch.equal(before[n], p) for n, p in
               model.named_parameters())
    state, m2 = step(state, batch, gen)
    moved = not all(torch.equal(before[n], p) for n, p in
                    model.named_parameters())
    return {"skipped": [float(m1["skipped"]), float(m2["skipped"])],
            "scale": [float(m1["loss_scale"]), float(m2["loss_scale"])],
            "kept": kept, "moved": moved}


def pretrain_argv(out, B, epochs=2):
    """A tiny MOFO pretrain run of the CLI at local batch B."""
    return ["--model", "pretrain_videomae_tiny_debug", "--decoder_depth",
            "1", "--synthetic", "8", "--batch_size", str(B), "--input_size",
            "32", "--num_frames", "4", "--epochs", str(epochs),
            "--warmup_epochs", "0", "--save_ckpt_freq", "1",
            "--decode_height", "48", "--decode_width", "64", "--dtype",
            "float32", "--device", "cpu", "--output_dir", out]


def finetune_argv(out, B):
    """A tiny BB-focused finetune run of the CLI at local batch B, with
    validation and the final multi-view test."""
    return ["--model", "vit_tiny_debug_BB_focused", "--synthetic", "8",
            "--batch_size", str(B), "--input_size", "32", "--num_frames",
            "4", "--nb_classes", "3", "--epochs", "2", "--warmup_epochs",
            "1", "--decode_height", "48", "--decode_width", "64", "--dtype",
            "float32", "--device", "cpu", "--output_dir", out]


def task_cli(rank, world, out):
    """cli.pretrain_mofo (2 epochs, then auto-resumed for a third) and
    cli.finetune_mofo in this rank, each one's printing kept per rank."""
    from mofo_tpu_torch.cli import finetune_mofo, pretrain_mofo

    pt, ft = os.path.join(out, "pt"), os.path.join(out, "ft")
    runs = (("pretrain", pretrain_mofo, pretrain_mofo.get_args(
                pretrain_argv(pt, 2), mofo_defaults=True)),
            ("resume", pretrain_mofo, pretrain_mofo.get_args(
                pretrain_argv(pt, 2, epochs=3), mofo_defaults=True)),
            ("finetune", finetune_mofo, finetune_mofo.get_args(
                finetune_argv(ft, 2), bb_defaults=True)))
    printed = {}
    for name, cli, args in runs:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main(args)
        printed[name] = text.getvalue()
    return printed


def task_adahessian(rank, world, out):
    """3 adahessian steps at eps ADAHESSIAN_EPS (the plain attention route,
    masks and the probe's z drawn in the step) on the rank's rows of G'."""
    B, k = PRETRAIN_BK[world]
    return mp.pretrain_steps(
        pretrain_model(attn_impl="xla"), pretrain_cfg(B, k),
        mp.rank_batch(pretrain_batch(world * B), rank, world, k), STEPS,
        wrap=True, opt="adahessian", eps=ADAHESSIAN_EPS)


TASKS = {"pretrain": task_pretrain, "adahessian": task_adahessian,
         "finetune": task_finetune, "collectives": task_collectives, "checkpoint": task_checkpoint,
         "loss_scale": task_loss_scale, "cli": task_cli}


def spawn(tasks: str, world: int, out: str) -> list:
    """Starts `world` processes of this file for `tasks`, writing under
    `out` (the caller's side)."""
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), tasks, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs: list, timeout: float = 240) -> list:
    """The processes' outputs; fails on one that failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank process failed:\n{out[-4000:]}"
    return outs


def main() -> None:
    tasks, out = sys.argv[1].split(","), sys.argv[2]
    torch.set_num_threads(1)
    distributed.init_distributed_mode(
        verbose=False, device="cpu",
        init_method=f"file://{os.path.join(out, 'store')}")
    rank, world = distributed.process_index(), distributed.process_count()
    try:
        for task in tasks:
            torch.save(TASKS[task](rank, world, out),
                       os.path.join(out, f"{task}-{rank}.pt"))
    finally:
        distributed.destroy()


if __name__ == "__main__":
    main()
