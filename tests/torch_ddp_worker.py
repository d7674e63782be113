"""Rank processes of tests/test_torch_ddp.py, tests/test_torch_ddp_cli.py,
tests/test_torch_mesh.py and tests/test_torch_mesh_zoo.py.

    python tests/torch_ddp_worker.py <tasks> <dir>     (RANK, WORLD_SIZE set)

A mesh_* task named with a shape, e.g. mesh_pretrain@122, lays the ranks
out on that (data, fsdp, model) mesh; one set of ranks runs the tasks of
every shape of their world.

joins a gloo process group through a FileStore in <dir>, runs each of the
comma-separated <tasks> and saves what each returns to
<dir>/<task>-<rank>.pt. It imports torch and mofo_tpu_torch only, never JAX
or tests/conftest.py. The models, configurations and global batches G' are
built here from seeds, so that the tests' single-process references at G'
run the same code; the steps are mofo_tpu_torch.tools.main_path's.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from unittest import mock

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
from mofo_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mofo_tpu_torch.tools import main_path as mp  # noqa: E402
from mofo_tpu_torch.tools.mesh_ranks import recorded_probes  # noqa: E402
from mofo_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from mofo_tpu_torch.train import metrics as M  # noqa: E402
from mofo_tpu_torch.train import finetune_step  # noqa: E402
from mofo_tpu_torch.train import optim  # noqa: E402
from mofo_tpu_torch.train import pretrain_step  # noqa: E402
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


def finetune_model(**overrides):
    return create_model(BB, device="cpu", seed=4, **BB_GEO, **overrides)


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


# --- the mesh tasks (tests/test_torch_mesh.py) ------------------------------

MESH_G = 8  # the global batch of the mesh tasks
MESH_K = 2  # update_freq of the drawn pretrain steps
MESH_STEPS = 2
# one update an optimizer: its norms over the shards (the clip, LAMB's and
# LARS's trust ratios, Novograd's moments) all act on the first
MESH_OPT_STEPS = 1
# the elementwise and norm-reading optimizers the mesh runs here, against
# one process (the layout-reading ones: tests/test_torch_mesh_zoo.py)
MESH_OPTS = ("adamw", "adam", "sgd", "nesterov", "momentum", "lamb",
             "rmsprop", "adadelta", "lars", "lion", "nadam", "radam",
             "novograd", "adamax", "adagrad", "adabelief", "yogi",
             "lookahead_adamw")
# every --opt name of mofo_tpu's zoo (tests/test_optim.py:199-205 and
# adahessian): create_optimizer builds each on a sharded mesh
ZOO_NAMES = ("adamw", "adam", "sgd", "nesterov", "momentum", "lamb",
             "adafactor", "rmsprop", "adadelta", "lars", "lion", "nadam",
             "radam", "novograd", "adamax", "adagrad", "adabelief", "yogi",
             "fusedadam", "fusedadamw", "fusedsgd", "fusedlamb",
             "fusednovograd", "nvnovograd", "fusedmomentum", "adamp", "sgdp",
             "lookahead_adamw", "lookahead_sgd", "adahessian")


# the mesh of the mesh_* task that runs (main sets it from the task name)
_SHAPE = None


def _mesh():
    return mesh_lib.build_mesh(mesh_lib.MeshConfig(*_SHAPE))


def _coord_batch(batch, mesh, k=1):
    """The batch coordinate's rows of G' (its model peers' alike)."""
    return mp.rank_batch(batch, mesh.batch.index, mesh.batch.size, k)


def task_mesh_pretrain(rank, world, out):
    """The tiny pretrain steps on the coordinate's rows of G': with G''s
    masks injected (k = 1, the masks mofo_tpu draws), and with the uint8
    clips augmented and the masks drawn in the step (k = MESH_K)."""
    mesh = _mesh()
    n = MESH_G // mesh.batch.size
    masks = torch.load(os.path.join(out, "masks.pt"))
    rows = torch.from_numpy(ddp.global_rows(mesh.batch.index,
                                            mesh.batch.size, n))
    injected = mp.pretrain_steps(
        pretrain_model(), pretrain_cfg(n, 1),
        _coord_batch(pretrain_batch(MESH_G), mesh), STEPS,
        masks=[m[rows] for m in masks], mesh=mesh)
    mesh = _mesh()
    drawn = mp.pretrain_steps(
        pretrain_model(), pretrain_cfg(n, MESH_K),
        _coord_batch(u8_batch(MESH_G), mesh, MESH_K), STEPS, augment=True,
        mesh=mesh)
    return {"injected": injected, "drawn": drawn, "coord": mesh.coord}


def mesh_finetune_cfg(B):
    """finetune_cfg with dropout and attention dropout at 0.1 too: the
    attention of a head-sharded module takes its heads' slice of the full
    draw."""
    return dataclasses.replace(finetune_cfg(B, 1), drop=0.1,
                               attn_drop_rate=0.1)


def mesh_finetune_model():
    return create_model(BB, device="cpu", seed=4, drop_rate=0.1,
                        attn_drop_rate=0.1, **BB_GEO)


def task_mesh_finetune(rank, world, out):
    """MESH_STEPS BB-MCA steps on the coordinate's uint8 rows (RandAugment,
    crop, flip, erasing, mixup elem + cutmix, drop path, dropout and
    attention dropout), one validation pass and the multi-view merge."""
    mesh = _mesh()
    n = MESH_G // mesh.batch.size
    return mp.finetune_steps(
        mesh_finetune_model(), mesh_finetune_cfg(n),
        _coord_batch(u8_batch(MESH_G, labels=True), mesh), MESH_STEPS,
        augment=True, eval_batch=_coord_batch(eval_batch(MESH_G), mesh),
        mesh=mesh)


def task_mesh_checkpoint(rank, world, out):
    """One step on the mesh and a save (rank 0 writes the full tensors);
    then <out>/one/checkpoint-0.pth, written by one process, resumed into
    a sharded model of another seed, returned whole."""
    mesh = _mesh()
    n = MESH_G // mesh.batch.size
    cfg = pretrain_cfg(n, 1)
    lrs = np.full(2, mp.STEPS_LR, np.float32)

    def sharded(seed):
        model = create_model(PRETRAIN, device="cpu", seed=seed,
                             **PRETRAIN_GEO)
        sharding = mesh_lib.shard_model(model, mesh)
        tx = optim.create_optimizer(dict(model.named_parameters()),
                                    lr_schedule=lrs, sharding=sharding)
        return (model, sharding, tx,
                TrainState.create(model, tx, use_ema=True))

    model, _, tx, state = sharded(3)
    step = make_pretrain_step(model, tx, cfg, lrs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, _coord_batch(pretrain_batch(MESH_G), mesh),
                    gen, 0.5)
    d = os.path.join(out, "mesh_ckpt")
    path = ckpt.save_checkpoint(d, model, state, 0)
    other, sharding2, _, state2 = sharded(9)
    epoch = ckpt.auto_resume(os.path.join(out, "one"), other, state2)
    mu = {n: sharding2.full(n, t) for n, t in state2.opt_state.mu.items()}
    ema = {n: sharding2.full(n, t) for n, t in state2.ema_params.items()}
    return {"path": path, "files": sorted(os.listdir(d)), "epoch": epoch,
            "resumed": sharding2.full_state_dict(other), "mu": mu,
            "ema": ema, "step": state2.step,
            "count": state2.opt_state.count}


def task_mesh_loss_scale(rank, world, out):
    """Two loss-scaled BB-MCA steps: in the first the clips of rank 1's
    batch coordinate hold an inf, so every rank's norm is not finite and
    every rank skips; the second is finite everywhere."""
    mesh = _mesh()
    n = MESH_G // mesh.batch.size
    cfg = finetune_cfg(n, 1)
    model = finetune_model()
    sharding = mesh_lib.shard_model(model, mesh)
    lrs = np.full(2, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lrs, sharding=sharding)
    state = TrainState.create(model, tx, loss_scale=DynamicLossScale.create())
    step = make_finetune_step(model, tx, cfg, lrs, bb_focused=True,
                              device="cpu")
    batch = _coord_batch(eval_batch(MESH_G), mesh)
    batch = {k: batch[k] for k in ("clip", "boxes", "label")}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    bad = dict(batch, clip=batch["clip"].clone())
    if mesh.batch.index == 1:
        bad["clip"][0, 0, 0, 0, 0] = float("inf")
    state, m1 = step(state, bad, gen)
    kept = all(torch.equal(before[k], p) for k, p in
               model.named_parameters())
    state, m2 = step(state, batch, gen)
    moved = not all(torch.equal(before[k], p) for k, p in
                    model.named_parameters())
    return {"skipped": [float(m1["skipped"]), float(m2["skipped"])],
            "scale": [float(m1["loss_scale"]), float(m2["loss_scale"])],
            "kept": kept, "moved": moved}


def task_mesh_optim(rank, world, out):
    """MESH_OPT_STEPS tiny pretrain steps (G''s rows, masks drawn) through
    each zoo entry of MESH_OPTS, with a clip at 0.5; then every name of
    ZOO_NAMES made on the sharded model (its stages' names, or the error
    it raised)."""
    runs, built = {}, {}
    for opt in MESH_OPTS:
        mesh = _mesh()
        n = MESH_G // mesh.batch.size
        runs[opt] = mp.pretrain_steps(
            pretrain_model(), pretrain_cfg(n, 1),
            _coord_batch(pretrain_batch(MESH_G), mesh), MESH_OPT_STEPS,
            opt=opt, mesh=mesh, clip_grad=0.5)
    model = pretrain_model()
    sharding = mesh_lib.shard_model(model, _mesh())
    for opt in ZOO_NAMES:
        try:
            tx = optim.create_optimizer(dict(model.named_parameters()),
                                        opt=opt, lr_schedule=np.ones(1),
                                        sharding=sharding)
            built[opt] = [type(st).__name__ for st in tx.stages]
        except Exception as e:  # noqa: BLE001 (the test names it)
            built[opt] = f"{type(e).__name__}: {e}"
    return {"runs": runs, "built": built}


# --- the layout-reading zoo on the mesh (tests/test_torch_mesh_zoo.py) -------

# the tiny pretrain steps of each entry (7 for lookahead: its k = 6 sync)
ZOO_PRETRAIN = {"adamp": MESH_STEPS, "sgdp": MESH_STEPS,
                "lookahead_adamp": 7}
# the pretrain geometry at BB_GEO's width, where Adafactor factors (both
# axes of mofo_tpu's layout at least 128)
WIDE_GEO = dict(PRETRAIN_GEO, encoder_embed_dim=128, decoder_embed_dim=128)
# the two updates of adamp_updates, the second from gradients orthogonal to
# the weights in every channel row, where AdamP / SGDP project
PROJECT_LR = 1e-2
# the entries whose state the checkpoint tasks carry across meshes
ZOO_CKPT = ("adafactor", "adahessian")


def wide_model(**overrides):
    return create_model(PRETRAIN, device="cpu", seed=3, **WIDE_GEO,
                        **overrides)


def channel_orthogonal(params: dict, seed: int) -> dict:
    """Random gradients, made orthogonal to each weight in every row of
    mofo_tpu's channel view (axis 0 of optim.jax_layout)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for n, p in params.items():
        g = torch.randn(p.shape, generator=gen)
        if p.ndim >= 2:
            pj = optim.jax_layout(n, p).double()
            gj = optim.jax_layout(n, g).double()
            pm, gm = pj.reshape(pj.shape[0], -1), gj.reshape(gj.shape[0], -1)
            gm = gm - pm * (gm * pm).sum(1, keepdim=True) / (pm * pm).sum(
                1, keepdim=True)
            g = optim.torch_layout(n, gm.reshape(pj.shape).float(),
                                   p.shape).contiguous()
        out[n] = g
    return out


def adamp_updates(opt: str, mesh=None) -> dict:
    """Two updates of `opt` (adamp or sgdp) at PROJECT_LR of the BB-MCA
    model's weights (sharded on `mesh` when given), from random gradients
    and then from gradients orthogonal to the updated weights; the final
    weights, whole."""
    model = finetune_model()
    sharding = None if mesh is None else mesh_lib.shard_model(model, mesh)
    cut = (lambda n, t: t) if sharding is None else sharding.shard
    params = dict(model.named_parameters())
    tx = optim.create_optimizer(
        params, opt=opt, lr_schedule=np.full(2, PROJECT_LR, np.float32),
        weight_decay=0.05, sharding=sharding)
    state = tx.init(params)
    full = mp._final(model)
    gen = torch.Generator().manual_seed(6)
    for g in ({n: torch.randn(p.shape, generator=gen)
               for n, p in full.items()}, None):
        if g is None:
            g = channel_orthogonal(mp._final(model), 7)
        tx.update({n: cut(n, t).contiguous() for n, t in g.items()}, state,
                  params)
    return mp._final(model)


@contextlib.contextmanager
def recorded_choices():
    """Inside, each call of optim.adamp_project_sharded appends its
    parameters' (use_ch, use_ly), name -> pair, to the yielded list."""
    seen, real = [], optim.adamp_project_sharded

    def record(sharding, names, *args):
        out = real(sharding, names, *args)
        seen.append({n: (bool(o[2]), bool(o[3])) for n, o in zip(names,
                                                                 out)})
        return out

    with mock.patch.object(optim, "adamp_project_sharded", record):
        yield seen


def zoo_finetune(opt: str, mesh=None, **overrides) -> dict:
    """MESH_STEPS BB-MCA steps of `opt` (adahessian on the plain attention
    route at ADAHESSIAN_EPS, its probes recorded) on G''s uint8 rows of
    this batch coordinate (all of G' without a mesh): RandAugment, crop,
    flip, erasing, mixup elem + cutmix, drop path 0.1."""
    second = optim.is_second_order(opt)
    n = MESH_G // (1 if mesh is None else mesh.batch.size)
    batch = u8_batch(MESH_G, labels=True)
    with recorded_probes() as probes:
        res = mp.finetune_steps(
            finetune_model(**({"attn_impl": "xla"} if second else {}),
                           **overrides),
            finetune_cfg(n, 1),
            batch if mesh is None else _coord_batch(batch, mesh),
            MESH_STEPS, augment=True, mesh=mesh, opt=opt,
            eps=ADAHESSIAN_EPS if second else None)
    return dict(res, probes=probes)


def zoo_pretrain(opt: str, steps: int, mesh=None, masks=None,
                 model=None) -> dict:
    """`steps` pretrain steps of `opt` on this batch coordinate's rows of
    G' (all of G' without a mesh): the tiny model (adahessian on the plain
    route at ADAHESSIAN_EPS, update_freq MESH_K, its probes recorded) or
    `model`; G''s `masks` injected when given (update_freq 1)."""
    second = optim.is_second_order(opt)
    k = MESH_K if second else 1
    n = MESH_G // (1 if mesh is None else mesh.batch.size)
    batch = pretrain_batch(MESH_G)
    if mesh is not None:
        batch = _coord_batch(batch, mesh, k)
        if masks is not None:
            rows = torch.from_numpy(ddp.global_rows(
                mesh.batch.index, mesh.batch.size, n))
            masks = [m[rows] for m in masks]
    if model is None:
        model = pretrain_model(**({"attn_impl": "xla"} if second else {}))
    with recorded_probes() as probes:
        res = mp.pretrain_steps(model, pretrain_cfg(n, k), batch, steps,
                                opt=opt, mesh=mesh, masks=masks,
                                eps=ADAHESSIAN_EPS if second else 1e-8)
    return dict(res, probes=probes)


def _shard_shapes(sharding, name, local):
    """The planted fault of Adafactor: the shape of this rank's shard in
    mofo_tpu's layout taken for the parameter's."""
    return tuple(optim.jax_layout(name, torch.empty(local,
                                                    device="meta")).shape)


_JAX_CUTS = mesh_lib.Sharding.jax_cuts


def _no_model_cut_but_rows(sharding, name):
    """The planted fault of AdamP: the model axis left out of the row sums
    (it stays where it cuts the rows)."""
    return {axis: key for axis, key in _JAX_CUTS(sharding, name).items()
            if key != "model" or axis == 0}


def task_zoo_pretrain(rank, world, out):
    """ZOO_PRETRAIN's entries, masks drawn in the step."""
    return {opt: zoo_pretrain(opt, steps, _mesh())
            for opt, steps in ZOO_PRETRAIN.items()}


def task_zoo_project(rank, world, out):
    """adamp_updates of adamp and sgdp with each update's choices; on
    (1, 2, 2) also AdamP with the row sums left unsummed over model."""
    res = {}
    for opt in ("adamp", "sgdp"):
        with recorded_choices() as choices:
            res[opt] = adamp_updates(opt, _mesh())
        res[f"{opt}_choices"] = choices
    if _SHAPE == (1, 2, 2):
        with mock.patch.object(mesh_lib.Sharding, "jax_cuts",
                               _no_model_cut_but_rows):
            res["fault"] = adamp_updates("adamp", _mesh())
    return res


def task_zoo_adafactor(rank, world, out):
    """adafactor in the BB-MCA finetune step (BB_GEO: its weights factor);
    on (1, 2, 2) also the wide pretrain step with G''s masks injected and
    the finetune with the factored dims chosen from the shard."""
    res = {"finetune": zoo_finetune("adafactor", _mesh())}
    if _SHAPE == (1, 2, 2):
        masks = torch.load(os.path.join(out, "masks.pt"))
        res["wide"] = zoo_pretrain("adafactor", STEPS, _mesh(), masks,
                                   wide_model())
        with mock.patch.object(mesh_lib.Sharding, "full_jax_shape",
                               _shard_shapes):
            res["fault"] = zoo_finetune("adafactor", _mesh())
    return res


def task_zoo_adahessian(rank, world, out):
    """adahessian in the pretrain and the BB-MCA finetune steps; on
    (1, 2, 2) also the pretrain with z drawn on the shards' shapes and with
    the probes averaged over the whole world (the planted faults)."""
    res = {"pretrain": zoo_pretrain("adahessian", MESH_STEPS, _mesh()),
           "finetune": zoo_finetune("adahessian", _mesh())}
    if _SHAPE == (1, 2, 2):
        real_z = optim.rademacher
        with mock.patch.object(pretrain_step, "rademacher",
                               lambda params, gen, sharding: real_z(params,
                                                                    gen)):
            res["local_z"] = zoo_pretrain("adahessian", MESH_STEPS, _mesh())
        real = pretrain_step.second_order_reduce
        with mock.patch.object(pretrain_step, "second_order_reduce",
                               lambda g, h, w, sharding: real(g, h, world)):
            res["world_reduce"] = zoo_pretrain("adahessian", MESH_STEPS,
                                               _mesh())
    return res


def ckpt_run(opt: str, mesh, seeds, resume=None, save=None) -> dict:
    """Steps of `opt` seeded `seeds` with G''s masks drawn (the wide model
    for adafactor, the tiny one on the plain route for adahessian; seed 9
    when it resumes from the latest checkpoint in `resume`, 3 otherwise),
    a save to `save` after them when given; the final weights, whole."""
    kw = {"seed": 9 if resume else 3}
    if opt == "adahessian":
        model = create_model(PRETRAIN, device="cpu", attn_impl="xla",
                             **PRETRAIN_GEO, **kw)
    else:
        model = create_model(PRETRAIN, device="cpu", **WIDE_GEO, **kw)
    sharding = None if mesh is None else mesh_lib.shard_model(model, mesh)
    lrs = np.full(2, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()), opt=opt,
                                lr_schedule=lrs, eps=ADAHESSIAN_EPS,
                                sharding=sharding)
    state = TrainState.create(model, tx)
    if resume:
        ckpt.auto_resume(resume, model, state)
    n = MESH_G // (1 if mesh is None else mesh.batch.size)
    step = make_pretrain_step(model, tx, pretrain_cfg(n, 1), lrs,
                              device="cpu",
                              second_order=optim.is_second_order(opt))
    batch = pretrain_batch(MESH_G)
    if mesh is not None:
        batch = _coord_batch(batch, mesh)
    gen = torch.Generator()
    for s in seeds:
        gen.manual_seed(s)
        state, _ = step(state, batch, gen, 0.5)
    if save:
        ckpt.save_checkpoint(save, model, state, 0)
    return mp._final(model)


# the zoo entries of task_zoo_cli's runners (adahessian at its eps here)
ZOO_CLI_PRETRAIN = ["--opt", "adahessian", "--opt_eps",
                    str(ADAHESSIAN_EPS)]
ZOO_CLI_FINETUNE = ["--opt", "lookahead_adafactor"]


def task_zoo_cli(rank, world, out):
    """mesh_clis with ZOO_CLI_PRETRAIN and ZOO_CLI_FINETUNE."""
    return mesh_clis(out, "zoo", ZOO_CLI_PRETRAIN, ZOO_CLI_FINETUNE)


def task_zoo_checkpoint(rank, world, out):
    """Per ZOO_CKPT entry: step 0 on the mesh, saved to <out>/mesh_<opt>;
    then <out>/one_<opt> (one process's step 0) resumed on the mesh for
    step 1."""
    res = {}
    for opt in ZOO_CKPT:
        ckpt_run(opt, _mesh(), [0], save=os.path.join(out, f"mesh_{opt}"))
        res[opt] = ckpt_run(opt, _mesh(), [1],
                            resume=os.path.join(out, f"one_{opt}"))
    return res


# a constant LR (the scaled lr, 2.56e-4 * 4 / 256, is the min_lr): a run of
# --epochs 1 then resumed with --epochs 2 steps as one of --epochs 2 does
CONSTANT_LR = ["--lr", "2.56e-4", "--min_lr", "4e-6"]


def mesh_pretrain_argv(out, epochs):
    """The tiny MOFO pretrain run of the CLI on the (1, 2, 2) mesh at one
    clip a device (2 rows a batch coordinate), an epoch a checkpoint."""
    return pretrain_argv(out, 1, epochs) + CONSTANT_LR + [
        "--mesh_fsdp", "2", "--mesh_model", "2"]


def mesh_clis(out: str, prefix: str, pretrain_extra=(),
              finetune_extra=()) -> dict:
    """cli.pretrain_mofo's first epoch on the (1, 2, 2) mesh into
    <out>/<prefix>_pt and cli.finetune_mofo (1 epoch, validation, the final
    multi-view test) on it into <out>/<prefix>_ft, each with its extra
    flags; what each printed."""
    from mofo_tpu_torch.cli import finetune_mofo, pretrain_mofo

    pt, ft = (os.path.join(out, f"{prefix}_{k}") for k in ("pt", "ft"))
    runs = (("pretrain", pretrain_mofo, pretrain_mofo.get_args(
                mesh_pretrain_argv(pt, 1) + list(pretrain_extra),
                mofo_defaults=True)),
            ("finetune", finetune_mofo, finetune_mofo.get_args(
                finetune_argv(ft, 1) + ["--epochs", "1", "--warmup_epochs",
                                        "0", "--mesh_fsdp", "2",
                                        "--mesh_model", "2"]
                + list(finetune_extra), bb_defaults=True)))
    printed = {}
    for name, cli, args in runs:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main(args)
        printed[name] = text.getvalue()
    return printed


def task_mesh_cli(rank, world, out):
    """mesh_clis with AdamW."""
    return mesh_clis(out, "mesh")


TASKS = {"pretrain": task_pretrain, "adahessian": task_adahessian,
         "finetune": task_finetune, "collectives": task_collectives,
         "checkpoint": task_checkpoint, "loss_scale": task_loss_scale,
         "cli": task_cli, "mesh_pretrain": task_mesh_pretrain,
         "mesh_finetune": task_mesh_finetune,
         "mesh_checkpoint": task_mesh_checkpoint,
         "mesh_loss_scale": task_mesh_loss_scale,
         "mesh_optim": task_mesh_optim, "mesh_cli": task_mesh_cli,
         "zoo_pretrain": task_zoo_pretrain, "zoo_project": task_zoo_project,
         "zoo_adafactor": task_zoo_adafactor,
         "zoo_adahessian": task_zoo_adahessian,
         "zoo_checkpoint": task_zoo_checkpoint, "zoo_cli": task_zoo_cli}


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
    global _SHAPE
    try:
        for task in tasks:
            name, _, shape = task.partition("@")
            _SHAPE = tuple(int(c) for c in shape) or None
            torch.save(TASKS[name](rank, world, out),
                       os.path.join(out, f"{task}-{rank}.pt"))
    finally:
        distributed.destroy()


if __name__ == "__main__":
    main()
