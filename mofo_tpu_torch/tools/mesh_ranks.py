"""The rank processes of chip_smoke.py's mesh phases: WORLD = 4 ranks on
the (1, 2, 2) mesh of parallel/mesh.py, all on cuda:0 over gloo (NCCL
refuses two ranks on one device), each joining through a FileStore.

  python -m mofo_tpu_torch.tools.mesh_ranks step <dir>
      (RANK, WORLD_SIZE set; LOCAL_RANK 0) one rank of phase mesh_step:
      `mesh_runs` on its batch coordinate's rows of G', its final
      parameters gathered whole and held against <dir>/reference.pt (the
      single process's at G'), then the planted fault (the fused qkv cut
      as a contiguous third); saves its results and kernel launches to
      <dir>/rank-<r>.pt.
  python -m mofo_tpu_torch.tools.mesh_ranks memory <dir> <enc> <dec>
      one rank of phase mesh_memory: `memory_run` (ViT-L cut to <enc> +
      <dec> Blocks) into <dir>/memory-<r>.pt.
  python -m mofo_tpu_torch.tools.mesh_ranks cli <dir> <runner> ...
      joins the group and runs mofo_tpu_torch.cli.<runner>'s main on the
      remaining arguments in this process (which then uses the group), and
      writes this process's kernel launch counts to <dir>/counts-<r>.json.
  python -m mofo_tpu_torch.tools.mesh_ranks tp <dir>
      (2 ranks) the tensor-parallel autograd functions on CUDA tensors
      against their definitions; <dir>/tp-<r>.json.
  python -m mofo_tpu_torch.tools.mesh_ranks zoo <dir>
  python -m mofo_tpu_torch.tools.mesh_ranks adahessian <dir>
      one rank of phase mesh_zoo (`zoo_runs`) or mesh_adahessian
      (`adahessian_runs`), each run held against <dir>/reference.pt (the
      single process's final parameters and probes at G'): the largest
      difference of the gathered parameters, their change's distance
      relative to one process's change, the probes' largest difference
      relative to each tensor's largest magnitude; into <dir>/rank-<r>.pt
      with the run's launches, step ms, peak memory and collectives.

`mesh_runs(None)` is the single process at G' that chip_smoke.py holds the
ranks against, on the same card: the ViT-B MOFO pretrain step at full
width, cut to DEPTH Blocks (PRETRAIN_B a device, so G' = 16 and 8 rows a batch
coordinate, motion-weighted loss, masks drawn in the step) for 2 steps in
f32 and 3 in bf16, and the ViT-B BB-focused MCA finetune step at DEPTH[0]
Blocks (f32, 10
classes, FINETUNE_B a device, RandAugment, crop, flip, erasing, mixup elem
with cutmix, drop path 0.1) for 2 steps, then one validation pass and the
multi-view merge. `zoo_runs(None)` is phase mesh_zoo's single process:
the same ViT-B pretrain in bf16 for ZOO_STEPS steps of each of
ZOO_PRETRAIN_OPTS, then the BB-MCA finetune step in f32 for ZOO_STEPS steps
of ZOO_FINETUNE_OPT; `adahessian_runs(None)` phase mesh_adahessian's:
ViT-B widths at AH_DEPTH Blocks, f32, on the plain attention route, AH_B a
device, AH_STEPS adahessian steps at eps AH_EPS with z drawn in the step.
`counted_collectives` counts parallel.tensor_parallel's collectives (calls
and bytes, the optimizer's update apart). `coord_order` makes the single
process's sampler of phase mesh_runner: its epoch 0 yields the mesh run's
global batches.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.parallel import mesh as mesh_lib
from mofo_tpu_torch.parallel import tensor_parallel as tp
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.tools.ddp_ranks import eval_views
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

SHAPE = (1, 2, 2)
WORLD = 4
# the ViT-B (encoder, decoder) Blocks of phases mesh_step and mesh_zoo
# (the BB-focused model's encoder too): every layer kind and its sharding
# at full width; full depth (12, 4) spent the script's time on gloo
DEPTH = (4, 2)
PRETRAIN_B = 4  # a device
FINETUNE_B = 2  # a device
STEPS = {"pretrain_float32": 2, "pretrain_bfloat16": 3,
         "finetune_float32": 2}
NUM_CLASSES = 10
LARGE = "pretrain_videomae_large_patch16_224"
MEMORY_STEPS = 2
# phase mesh_zoo: the entries that read a tensor's layout, after AdamW (no
# such stage), run alike as their yardstick
ZOO_STEPS = 2
ZOO_PRETRAIN_OPTS = ("adamw", "adafactor", "adamp", "sgdp")
ZOO_FINETUNE_OPT = "adamp"
# phase mesh_adahessian: ViT-B widths, its (encoder, decoder) Blocks (as
# DEPTH), clips a device, steps, and eps 1e-3 (at 1e-8 an update
# divides by probe elements smaller than their rounding across reduction
# orders)
AH_DEPTH = DEPTH
AH_B = 2
AH_STEPS = 2
AH_EPS = 1e-3


def _coord(batch: dict, mesh) -> dict:
    if mesh is None:
        return batch
    return mp.rank_batch(batch, mesh.batch.index, mesh.batch.size)


def _pretrain_cfg(rows: int, dtype: str) -> PretrainConfig:
    return PretrainConfig(model=mp.MODEL, batch_size=rows, dtype=dtype,
                          masking=MaskingConfig(mask_type="tube_bb"),
                          motion_loss_weight=True)


def mesh_runs(mesh) -> dict:
    """The runs of phase mesh_step on this rank's batch coordinate of
    `mesh`, or with mesh None on all of G' in one process. Returns {run:
    main_path's results, with the run's kernel launches}."""
    out = {}
    G = PRETRAIN_B * WORLD
    for dtype in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = _coord(mp.synthetic_batch(G, gen, "cuda"), mesh)
        model = create_model(mp.MODEL, device="cuda", seed=1,
                             dtype=getattr(torch, dtype),
                             encoder_depth=DEPTH[0], decoder_depth=DEPTH[1])
        fa.reset_launch_counts()
        run = f"pretrain_{dtype}"
        out[run] = mp.pretrain_steps(
            model, _pretrain_cfg(len(batch["clip"]), dtype), batch,
            STEPS[run], mesh=mesh)
        out[run]["launches"] = dict(fa.launch_counts)
        del model, batch
        torch.cuda.empty_cache()
    G = FINETUNE_B * WORLD
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = mp.synthetic_clips_u8(G, gen, "cuda", NUM_CLASSES)
    views = eval_views(G, gen, NUM_CLASSES)
    batch, views = _coord(batch, mesh), _coord(views, mesh)
    # 10 classes, so that the views' Acc@1 and Acc@5 are neither 0 nor 100
    cfg = FinetuneConfig(model=mp.FINETUNE_MODEL, dtype="float32",
                         mixup_mode="elem", nb_classes=NUM_CLASSES,
                         batch_size=len(batch["clip"]))
    fa.reset_launch_counts()
    out["finetune_float32"] = mp.finetune_steps(
        mp.finetune_model(cfg, depth=DEPTH[0]), cfg, batch,
        STEPS["finetune_float32"],
        augment=True, eval_batch=views, mesh=mesh)
    out["finetune_float32"]["launches"] = dict(fa.launch_counts)
    return out


@contextlib.contextmanager
def counted_collectives():
    """Inside, every all_reduce and all_gather of parallel.tensor_parallel
    over an axis of two or more ranks is counted; yields {"step": [calls,
    bytes], "optimizer": [calls, bytes]}, the optimizer's update's apart
    (the bytes each rank sends in: a reduce-scatter is an all-reduce)."""
    counts = {"step": [0, 0], "optimizer": [0, 0]}
    where = ["step"]

    def counted(fn):
        def wrapped(t, axis, *args):
            if axis is not None and axis.size > 1:
                counts[where[0]][0] += 1
                counts[where[0]][1] += t.numel() * t.element_size()
            return fn(t, axis, *args)
        return wrapped

    real_update = optim.Optimizer.update

    def update(self, *args, **kwargs):
        where[0] = "optimizer"
        try:
            return real_update(self, *args, **kwargs)
        finally:
            where[0] = "step"

    with mock.patch.object(tp, "all_reduce", counted(tp.all_reduce)), \
            mock.patch.object(tp, "all_gather", counted(tp.all_gather)), \
            mock.patch.object(optim.Optimizer, "update", update):
        yield counts


@contextlib.contextmanager
def recorded_probes():
    """Inside, each optimizer update that gets a probe keeps a copy of this
    rank's shards of it; on leaving, the yielded list gets each probe
    whole (name -> z * Hz, f32 on the CPU), gathered only then, so that no
    collective of the recording falls inside the run."""
    kept, seen, real = [], [], optim.Optimizer.update

    def update(self, grads, state, params, hessian_diag=None):
        if hessian_diag is not None:
            kept.append((self.sharding, {n: t.detach().clone()
                                         for n, t in hessian_diag.items()}))
        return real(self, grads, state, params, hessian_diag)

    with mock.patch.object(optim.Optimizer, "update", update):
        yield seen
    for sh, probe in kept:
        seen.append({n: (t if sh is None else sh.full(n, t)).float().cpu()
                     for n, t in probe.items()})


def _timed_run(run_fn) -> dict:
    """run_fn() (main_path's results) with its kernel launches,
    collectives and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    with counted_collectives() as coll:
        res = run_fn()
    res.update(launches=dict(fa.launch_counts), collectives=coll,
               peak_bytes=torch.cuda.max_memory_allocated())
    return res


def zoo_runs(mesh) -> dict:
    """The runs of phase mesh_zoo on this rank's batch coordinate of
    `mesh`, or with mesh None on all of G' in one process. Returns {run:
    main_path's results, with `init` (the weights before the steps, whole),
    launches, collectives and peak memory}."""
    out = {}
    G = PRETRAIN_B * WORLD
    for opt in ZOO_PRETRAIN_OPTS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = _coord(mp.synthetic_batch(G, gen, "cuda"), mesh)
        model = create_model(mp.MODEL, device="cuda", seed=1,
                             dtype=torch.bfloat16, encoder_depth=DEPTH[0],
                             decoder_depth=DEPTH[1])
        init = mp._final(model)
        out[f"pretrain_{opt}"] = dict(_timed_run(lambda: mp.pretrain_steps(
            model, _pretrain_cfg(len(batch["clip"]), "bfloat16"), batch,
            ZOO_STEPS, mesh=mesh, opt=opt)), init=init)
        del model, batch
        torch.cuda.empty_cache()
    G = FINETUNE_B * WORLD
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _coord(mp.synthetic_clips_u8(G, gen, "cuda", NUM_CLASSES), mesh)
    cfg = FinetuneConfig(model=mp.FINETUNE_MODEL, dtype="float32",
                         mixup_mode="elem", nb_classes=NUM_CLASSES,
                         batch_size=len(batch["clip"]))
    model = mp.finetune_model(cfg, depth=DEPTH[0])
    init = mp._final(model)
    out[f"finetune_{ZOO_FINETUNE_OPT}"] = dict(_timed_run(
        lambda: mp.finetune_steps(model, cfg, batch, ZOO_STEPS,
                                  augment=True, mesh=mesh,
                                  opt=ZOO_FINETUNE_OPT)), init=init)
    return out


def adahessian_runs(mesh) -> dict:
    """The run of phase mesh_adahessian on this rank's batch coordinate
    (all of G' with mesh None), as zoo_runs returns it, with the probes
    the optimizer got, whole."""
    G = AH_B * WORLD
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _coord(mp.synthetic_batch(G, gen, "cuda"), mesh)
    model = create_model(mp.MODEL, device="cuda", seed=1, attn_impl="xla",
                         encoder_depth=AH_DEPTH[0], decoder_depth=AH_DEPTH[1])
    init = mp._final(model)
    with recorded_probes() as probes:
        res = _timed_run(lambda: mp.pretrain_steps(
            model, _pretrain_cfg(len(batch["clip"]), "float32"), batch,
            AH_STEPS, mesh=mesh, opt="adahessian", eps=AH_EPS))
    return {"pretrain_adahessian": dict(res, init=init, probes=probes)}


def reference_of(runs: dict) -> dict:
    """What the ranks are held against: each run's final parameters and
    probes (popped from `runs`)."""
    return {run: {"params": res.pop("params"),
                  "probes": res.pop("probes", None)}
            for run, res in runs.items()}


def _against(runs: dict, reference: dict) -> None:
    """In place, each run's parameters, initial weights and probes replaced
    by their distance to the reference's (see the module docstring)."""
    for run, want in reference.items():
        got, init = runs[run].pop("params"), runs[run].pop("init")
        num = den = 0.0
        err = 0.0
        for n, v in want["params"].items():
            d = (got[n] - v).double()
            err = max(err, d.abs().max().item())
            num += d.square().sum().item()
            den += (v.double() - init[n].double()).square().sum().item()
        runs[run].update(params_max_abs_err=err,
                         change_rel=(num / max(den, 1e-300)) ** 0.5)
        if want["probes"] is not None:
            probes = runs[run].pop("probes")
            if len(probes) != len(want["probes"]):
                raise ValueError(f"{run}: {len(probes)} probes, one process "
                                 f"{len(want['probes'])}")
            runs[run]["probe_rel_err"] = max(
                (g[n] - v).abs().max().item() / max(v.abs().max().item(),
                                                    1e-30)
                for g, w in zip(probes, want["probes"])
                for n, v in w.items())


def _compared(out_dir: str, runs_fn) -> None:
    _join(out_dir)
    rank = distributed.process_index()
    try:
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(*SHAPE))
        t0 = time.perf_counter()
        out = runs_fn(mesh)
        seconds = time.perf_counter() - t0
    finally:
        distributed.destroy()
    _against(out, torch.load(os.path.join(out_dir, "reference.pt"),
                             mmap=True))
    out.update(seconds=seconds, coord=mesh.coord)
    torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))


def contiguous_qkv_step(mesh) -> float:
    """The first f32 pretrain step's loss with the fused qkv cut as a
    contiguous third of its rows (the planted fault that the bounds must
    reject)."""
    G = PRETRAIN_B * WORLD
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _coord(mp.synthetic_batch(G, gen, "cuda"), mesh)
    model = create_model(mp.MODEL, device="cuda", seed=1,
                         encoder_depth=DEPTH[0], decoder_depth=DEPTH[1])
    with mock.patch.object(mesh_lib, "sections_of", lambda name: 1):
        res = mp.pretrain_steps(model, _pretrain_cfg(len(batch["clip"]),
                                                     "float32"),
                                batch, 1, mesh=mesh)
    return res["loss"][0]


def _join(out_dir: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init_distributed_mode(
        verbose=False, device="cuda", backend="gloo",
        init_method=f"file://{os.path.join(out_dir, 'store')}")


def _step(out_dir: str) -> None:
    _join(out_dir)
    rank = distributed.process_index()
    try:
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(*SHAPE))
        t0 = time.perf_counter()
        out = mesh_runs(mesh)
        out["seconds"] = time.perf_counter() - t0
        out["coord"] = mesh.coord
        out["contiguous_qkv_loss"] = contiguous_qkv_step(mesh)
    finally:
        distributed.destroy()
    reference = torch.load(os.path.join(out_dir, "reference.pt"))
    for run, want in reference.items():
        got = out[run].pop("params")
        out[run]["params_max_abs_err"] = max(
            (got[n] - v).abs().max().item() for n, v in want.items())
    torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))


def memory_run(mesh, depth: tuple) -> dict:
    """MEMORY_STEPS bf16 steps of ViT-L cut to `depth` (encoder, decoder)
    Blocks on this rank's coordinate (PRETRAIN_B a device): the bytes of
    its parameters, gradients and AdamW moments, those of one process
    (the full tensors) and the share spec_for_param gives a rank, the peak
    memory and the step times."""
    G = PRETRAIN_B * WORLD
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _coord(mp.synthetic_batch(G, gen, "cuda"), mesh)
    model = create_model(LARGE, device="cuda", seed=1, dtype=torch.bfloat16,
                         encoder_depth=depth[0], decoder_depth=depth[1])
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sharding = mesh_lib.shard_model(model, mesh)
    analytic = sum(int(np.prod(sharding.local_shape(n, s)))
                   for n, s in full.items())
    lrs = np.full(MEMORY_STEPS, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lrs, betas=(0.9, 0.95),
                                sharding=sharding)
    state = TrainState.create(model, tx)
    cfg = PretrainConfig(model=LARGE, batch_size=len(batch["clip"]),
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True)
    step = make_pretrain_step(model, tx, cfg, lrs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ms, losses = [], []
    for s in range(MEMORY_STEPS):
        gen.manual_seed(s)
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, 0.5)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    params = list(model.parameters())
    return {
        "depth": depth, "coord": mesh.coord,
        "param_bytes": _nbytes(params),
        "grad_bytes": _nbytes(p.grad for p in params if p.grad is not None),
        "moment_bytes": _nbytes(list(state.opt_state.mu.values())
                                + list(state.opt_state.nu.values())),
        "one_process_param_bytes": 4 * sum(int(np.prod(s))
                                           for s in full.values()),
        "analytic_param_bytes": 4 * analytic,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "step_ms": ms, "loss": losses,
        "launches": dict(fa.launch_counts),
    }


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _memory(out_dir: str, depth: tuple) -> None:
    _join(out_dir)
    rank = distributed.process_index()
    try:
        out = memory_run(mesh_lib.build_mesh(mesh_lib.MeshConfig(*SHAPE)),
                         depth)
    finally:
        distributed.destroy()
    torch.save(out, os.path.join(out_dir, f"memory-{rank}.pt"))


def _cli(out_dir: str, runner: str, argv: list) -> None:
    import importlib

    _join(out_dir)
    counts_path = os.path.join(out_dir,
                               f"counts-{distributed.process_index()}.json")
    cli = importlib.import_module(f"mofo_tpu_torch.cli.{runner}")
    kw = {"pretrain_mofo": {"mofo_defaults": True},
          "finetune_mofo": {"bb_defaults": True}}[runner]
    fa.reset_launch_counts()
    try:
        cli.main(cli.get_args(argv, **kw))
    finally:
        distributed.destroy()
    with open(counts_path, "w") as f:
        json.dump(fa.launch_counts, f)


def coord_order(coords: int, rows: int):
    """A ShardedSampler class for one process whose epoch 0 yields, batch
    by batch, `coords` batch coordinates' batches of `rows` side by side
    (the mesh run's global batches); later epochs are its own."""
    base = P.ShardedSampler

    class CoordOrder(base):
        def indices(self) -> np.ndarray:
            if self.epoch != 0:
                return super().indices()
            shards = []
            for b in range(coords):
                s = base(self.n, b, coords, self.shuffle, self.seed)
                s.set_epoch(self.epoch)
                shards.append(s.indices())
            return np.concatenate([shard[i * rows:(i + 1) * rows]
                                   for i in range(len(shards[0]) // rows)
                                   for shard in shards])

    return CoordOrder


def tp_selftest(rank: int) -> dict:
    """copy_to, reduce_from, gather_from (model axis of (1, 1, 2)) and
    gather_fsdp (fsdp axis of (1, 2, 1)) on CUDA tensors, forward and
    backward, against what they are defined to compute; every rank's
    inputs come from seeds, so each rank knows the other's. Returns the
    largest error of each."""
    def t(seed, *shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(*shape, generator=g).cuda()

    errs = {}
    model = mesh_lib.build_mesh(mesh_lib.MeshConfig(1, 1, 2)).model
    fsdp = mesh_lib.build_mesh(mesh_lib.MeshConfig(1, 2, 1)).fsdp
    x = t(0, 4, 6).requires_grad_(True)
    tp.copy_to(x, model).backward(t(10 + rank, 4, 6))
    errs["copy_to_bwd"] = (x.grad - (t(10, 4, 6) + t(11, 4, 6))).abs().max()
    x = t(20 + rank, 4, 6).requires_grad_(True)
    y = tp.reduce_from(x, model)
    y.backward(t(30, 4, 6))
    errs["reduce_from_fwd"] = (y - (t(20, 4, 6) + t(21, 4, 6))).abs().max()
    errs["reduce_from_bwd"] = (x.grad - t(30, 4, 6)).abs().max()
    x = t(40 + rank, 4, 3).requires_grad_(True)
    y = tp.gather_from(x, model)
    g = t(50, 4, 6)
    y.backward(g)
    errs["gather_from_fwd"] = (y - torch.cat([t(40, 4, 3), t(41, 4, 3)],
                                             -1)).abs().max()
    errs["gather_from_bwd"] = (x.grad - g[:, 3 * rank:3 * rank + 3]
                               ).abs().max()
    p = t(60 + rank, 3, 5).requires_grad_(True)
    y = tp.gather_fsdp(p, fsdp, 0)
    y.backward(t(70 + rank, 6, 5))
    errs["gather_fsdp_fwd"] = (y - torch.cat([t(60, 3, 5), t(61, 3, 5)])
                               ).abs().max()
    want = (t(70, 6, 5) + t(71, 6, 5))[3 * rank:3 * rank + 3]
    errs["gather_fsdp_bwd"] = (p.grad - want).abs().max()
    return {k: float(v) for k, v in errs.items()}


def _tp(out_dir: str) -> None:
    _join(out_dir)
    rank = distributed.process_index()
    try:
        out = tp_selftest(rank)
    finally:
        distributed.destroy()
    with open(os.path.join(out_dir, f"tp-{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "step":
        _step(sys.argv[2])
    elif mode == "memory":
        _memory(sys.argv[2], (int(sys.argv[3]), int(sys.argv[4])))
    elif mode == "cli":
        _cli(sys.argv[2], sys.argv[3], sys.argv[4:])
    elif mode == "tp":
        _tp(sys.argv[2])
    elif mode == "zoo":
        _compared(sys.argv[2], zoo_runs)
    elif mode == "adahessian":
        _compared(sys.argv[2], adahessian_runs)
    else:
        raise SystemExit(f"unknown mode {mode!r}: step, memory, cli, tp, "
                         "zoo or adahessian")
