"""Data-parallel training across processes (mofo_tpu_torch/parallel/ddp.py)
on the CPU: W ranks over gloo, spawned as tests/torch_ddp_worker.py (which
imports no JAX), against one port process on the global batch G' and
against mofo_tpu at G'.

The contract: W ranks with local batch B and update_freq k, seeded alike,
compute what one process computes on G', whose microbatch i is the ranks'
microbatches i side by side. Both worlds (W = 2 and W = 3, odd, where the
middle rank is its own mixup partner) start together in one fixture; the
single-process references run here. The pretrain steps with G''s masks
injected are also held against mofo_tpu's jitted step at G' (the masks are
the ones it draws), within the bounds of tests/test_torch_step.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from mofo_tpu.core.config import MaskingConfig as JaxMaskingConfig
from mofo_tpu.core.config import PretrainConfig as JaxPretrainConfig
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train.checkpoint import (
    import_torch_pretrain,
    load_torch_checkpoint,
)
from mofo_tpu.train.pretrain_step import generate_mask as jax_generate_mask
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_make_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.eval.multiview import MultiViewAggregator
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.train import metrics as M


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


TASKS = {2: "pretrain,finetune,collectives,checkpoint,loss_scale",
         3: "pretrain,finetune,collectives"}
JAX_RNG = 2


def jax_cfg(G, k):
    return JaxPretrainConfig(
        input_size=32, num_frames=4, batch_size=G, dtype="float32",
        update_freq=k, motion_loss_weight=True,
        masking=JaxMaskingConfig(mask_type="tube_bb", mask_ratio=0.5))


def jax_masks(G, k, steps=W.STEPS):
    """The masks mofo_tpu's step draws at G' for each step (fold_in(rng,
    step), split into k microbatch keys, split(., 3)[0]), (steps, G, N)."""
    batch = W.pretrain_batch(G)
    cfg, rng = jax_cfg(G, k), jax.random.PRNGKey(JAX_RNG)
    out = []
    for s in range(steps):
        key = jax.random.fold_in(rng, s)
        keys = [key] if k == 1 else list(jax.random.split(key, k))
        m = G // k
        out.append(np.concatenate([np.asarray(jax_generate_mask(
            jax.random.split(mkey, 3)[0],
            {n: jnp.asarray(v[i * m:(i + 1) * m].numpy())
             for n, v in batch.items()}, cfg))
            for i, mkey in enumerate(keys)]))
    return torch.from_numpy(np.stack(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' rank results, {world: {task: [rank results]}}."""
    dirs, procs = {}, {}
    for world, tasks in TASKS.items():
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        B, k = W.PRETRAIN_BK[world]
        torch.save(jax_masks(world * B, k), os.path.join(d, "masks.pt"))
        dirs[world], procs[world] = d, W.spawn(tasks, world, d)
    for world in TASKS:
        W.wait(procs[world])
    return {world: {task: [torch.load(os.path.join(dirs[world],
                                                   f"{task}-{r}.pt"),
                                      weights_only=False)
                           for r in range(world)]
                    for task in TASKS[world].split(",")}
            for world in TASKS}, dirs


def _close(got: dict, want: dict, rtol: float, params_atol: float):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                   err_msg=key)
    for n, v in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(),
                                   atol=params_atol, rtol=0, err_msg=n)


# --- the layout, with no process group ------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2])
def test_global_rows(world, k):
    B = 4
    rows = [ddp.global_rows(r, world, B, k) for r in range(world)]
    np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                  np.arange(world * B))
    m = B // k
    for r in range(world):
        for j in range(B):  # local row j of microbatch i = j // m
            assert rows[r][j] == (j // m) * world * m + r * m + j % m
    # G''s microbatch i is the ranks' microbatches i side by side
    G = {"x": torch.arange(world * B)}
    parts = [mp.rank_batch(G, r, world, k) for r in range(world)]
    for r in range(world):
        np.testing.assert_array_equal(parts[r]["x"].numpy(), rows[r])
    assert torch.equal(mp.global_batch(parts, k)["x"], G["x"])
    with pytest.raises(ValueError, match="does not split"):
        ddp.global_rows(0, world, 3, 2)


@pytest.mark.parametrize("world,k", [(2, 1), (3, 2)])
def test_per_sample_draws_the_global_batchs_rows(world, k):
    def draw(shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(7))

    assert torch.equal(ddp.per_sample(draw, (4, 3)), draw((4, 3)))
    full = draw((world * 4, 3))
    for r in range(world):
        with ddp.global_draws(r, world, k):
            assert ddp.layout() == (r, world, k)
            got = ddp.per_sample(draw, (4, 3))
        rows = torch.from_numpy(ddp.global_rows(r, world, 4, k))
        assert torch.equal(got, full[rows])
    assert ddp.layout() is None
    with ddp.global_draws(0, 1):
        assert ddp.layout() is None


def test_launcher_conventions_give_the_local_rank(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID",
                "SLURM_NTASKS", "SLURM_LOCALID", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.local_rank() == 0
    assert not distributed.init_distributed_mode(verbose=False)
    for env, want in (({"SLURM_PROCID": "5", "SLURM_NTASKS": "8",
                        "SLURM_LOCALID": "1"}, (5, 8, 1)),
                      ({"OMPI_COMM_WORLD_RANK": "3",
                        "OMPI_COMM_WORLD_SIZE": "4",
                        "OMPI_COMM_WORLD_LOCAL_RANK": "3"}, (3, 4, 3)),
                      ({"RANK": "1", "WORLD_SIZE": "1",
                        "LOCAL_RANK": "0"}, (1, 1, 0))):
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        assert (*distributed.launcher_world(),
                distributed.local_rank()) == want
        assert distributed.run_device("cuda") == f"cuda:{want[2]}"
        assert distributed.run_device("cpu") == "cpu"
        for var in env:
            monkeypatch.delenv(var)
    assert (distributed.process_index(), distributed.process_count()) == (
        0, 1)
    distributed.barrier()  # a no-op for one process


# --- the ranks against one process at G' -----------------------------------


@pytest.mark.parametrize("world", [2, 3])
def test_pretrain_step_equals_one_process_at_global_batch(runs, world):
    """Motion-weighted loss, update_freq 2, 3 steps: with G''s masks
    injected, and with the augmentation and masks drawn in the step."""
    results, _ = runs
    B, k = W.PRETRAIN_BK[world]
    G = world * B
    cfg = W.pretrain_cfg(G, k)
    masks = jax_masks(G, k)
    want = {"injected": mp.pretrain_steps(
        W.pretrain_model(), cfg, W.pretrain_batch(G), W.STEPS,
        masks=list(masks)),
        "drawn": mp.pretrain_steps(W.pretrain_model(), cfg, W.u8_batch(G),
                                   W.STEPS, augment=True)}
    for rank_out in results[world]["pretrain"]:
        for kind in ("injected", "drawn"):
            _close(rank_out[kind], want[kind], 1e-6, 1e-6)


def test_pretrain_step_equals_mofo_tpu_at_global_batch(runs):
    """The W = 2 ranks with G''s masks injected against mofo_tpu's jitted
    step on G' (the same weights, through import_torch_pretrain)."""
    results, _ = runs
    B, k = W.PRETRAIN_BK[2]
    G = 2 * B
    jcfg = jax_cfg(G, k)
    lr = np.full(W.STEPS, mp.STEPS_LR, np.float32)
    jmodel = jax_create_model(W.PRETRAIN, **W.PRETRAIN_GEO)
    params = import_torch_pretrain(W.pretrain_model().state_dict())
    jtx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                     betas=(0.9, 0.95), weight_decay=0.05)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_make_pretrain_step(jmodel, jtx, jcfg, lr))
    jbatch = {n: jnp.asarray(v.numpy())
              for n, v in W.pretrain_batch(G).items()}
    losses, norms = [], []
    for _ in range(W.STEPS):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(JAX_RNG), 0.5)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for rank_out in results[2]["pretrain"]:
        got = rank_out["injected"]
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-4)
        ours = import_torch_pretrain(got["params"])
        for a, b in zip(jax.tree.leaves(ours),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 3])
def test_bb_mca_finetune_step_equals_one_process(runs, world):
    """RandAugment, crop, flip, erasing, mixup elem + cutmix (the partner
    from rank W-1-r; for W = 3 rank 1 is its own) and drop path 0.1, 3
    steps; then one validation pass and the multi-view merge."""
    results, _ = runs
    B, k = W.FINETUNE_BK[world]
    want = mp.finetune_steps(
        W.finetune_model(), W.finetune_cfg(world * B, k),
        W.u8_batch(world * B, labels=True), W.STEPS, augment=True,
        eval_batch=W.eval_batch(world * 4))
    for rank, got in enumerate(results[world]["finetune"]):
        # parameters at 1e-5 (3% of the largest move of 3 steps at lr
        # 1e-4): AdamW's m / sqrt(v) turns the reduction order's rounding
        # of a near-zero gradient into up to one lr of move (one MCA kv
        # weight moves 1.6e-6 apart); the losses and gradient norms, which
        # a wrong draw, partner or reduction moves, stay at 1e-6
        _close(got, want, 1e-6, 1e-5)
        for key, v in want["eval"].items():
            assert got["eval"][key] == pytest.approx(v, rel=1e-6), key
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want["logits"][rows].numpy(), atol=1e-5,
                                   rtol=0)
        assert got["multiview"] == want["multiview"]


# --- the collectives, the checkpoint and the loss scale ---------------------


@pytest.mark.parametrize("world", [2, 3])
def test_epoch_stats_sync_and_flipped_exchange(runs, world):
    results, _ = runs
    one = M.MetricLogger()
    for r in range(world):
        for n, loss, acc1 in W.meter_updates(r):
            one.update_weighted(n, loss=loss, acc1=acc1)
    want = one.epoch_stats()
    x = torch.arange(3 * world, dtype=torch.float32).reshape(world, 3)
    G = torch.cat([x[r:r + 1].repeat(2, 1) + torch.tensor([[0.0], [0.5]])
                   for r in range(world)])
    flipped = torch.flip(G, dims=[0])
    for rank, got in enumerate(results[world]["collectives"]):
        assert got["stats"] == pytest.approx(want, rel=1e-12)
        assert torch.equal(got["flipped"], flipped[2 * rank:2 * rank + 2])


def test_gather_across_processes_merges_every_ranks_views(runs):
    """Each rank's merged views equal one aggregator of every rank's rows
    in rank order: the duplicate (video, chunk, split) row is dropped and
    the padded rows never enter."""
    results, _ = runs
    outs = results[2]["finetune"]
    ev = W.eval_batch(8)
    keep = ev["valid"].numpy()
    logits = torch.cat([got["logits"] for got in outs]).numpy()
    agg = MultiViewAggregator()
    agg.add(ev["video_idx"].numpy()[keep], ev["chunk_nb"].numpy()[keep],
            ev["split_nb"].numpy()[keep], logits[keep],
            ev["label"].numpy()[keep])
    feats, _ = agg.merge_feats()
    assert len(feats) == 3 and keep.sum() == 6  # 6 rows, 1 a duplicate
    top1, top5, _ = agg.finalize()
    for got in outs:
        assert got["multiview"] == {"acc1": top1, "acc5": top5}


def test_checkpoint_written_once_resumed_on_every_rank(runs):
    results, dirs = runs
    outs = results[2]["checkpoint"]
    for got in outs:
        assert got["files"] == ["checkpoint-0.pth"]  # no rank's temp file
        assert got["epoch"] == 0 and got["same"] and got["moments"]
        assert (got["step"], got["count"]) == (1, 1)
        assert got["path"] == outs[0]["path"]
    sd = load_torch_checkpoint(outs[0]["path"])
    assert not any(n.startswith("module.") for n in sd)
    params = import_torch_pretrain(sd)
    ref = import_torch_pretrain(W.pretrain_model().state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(ref)


def test_fp16_skip_is_decided_by_every_rank_together(runs):
    """Rank 1's clip holds an inf; DDP's reduction carries it into every
    rank's gradients, so both skip the step and back the scale off
    together, with no second reduction; the next, finite step updates."""
    results, _ = runs
    for got in results[2]["loss_scale"]:
        assert got["skipped"] == [1.0, 0.0]
        assert got["scale"] == [64.0, 64.0]
        assert got["kept"] and got["moved"]
