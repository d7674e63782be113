"""The optimizers that read a tensor's layout on the fsdp and model axes of
a mesh: Adafactor, AdamP, SGDP and AdaHessian's Hutchinson probe
(mofo_tpu_torch/train/optim.py, parallel/mesh.py, parallel/
tensor_parallel.py) on the CPU. 4 ranks over gloo, laid out on (1, 2, 2)
and then on (2, 2, 1), spawned once as tests/torch_ddp_worker.py's zoo_*
tasks (which import no JAX), each held against one port process at the
global batch G'; the (1, 2, 2) Adafactor ranks also against mofo_tpu's
jitted step on a (1, 2, 2) mesh of 4 CPU devices; four planted faults,
each of which must miss its bound by more than 10x; and the Adafactor and
AdaHessian states carried across meshes by the checkpoints.
"""

import contextlib
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.parallel import mesh as jax_mesh
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train.checkpoint import import_torch_pretrain
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_make_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.cli import pretrain_mofo
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.tools import mesh_ranks
from test_torch_ddp import JAX_RNG, jax_cfg, jax_masks

G = W.MESH_G
WORLDS = {"122": ("zoo_pretrain", "zoo_project", "zoo_adafactor",
                  "zoo_adahessian", "zoo_checkpoint", "zoo_cli"),
          "221": ("zoo_pretrain", "zoo_project", "zoo_adafactor",
                  "zoo_adahessian")}
# f32, the ranks against one process: losses and gradient norms (rtol),
# gathered parameters (atol)
RTOL = ATOL = 1e-5
# adahessian: parameters (atol) and each probe tensor relative to its own
# largest magnitude, as tests/test_torch_second_order.py holds its probe
# (two backward passes summed in another order)
PROBE_BOUND = 1e-4
# a planted fault must miss its bound by more than this
FAULT_FACTOR = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The references are tiny models: one thread each, as the ranks run,
    so that the module does not oversubscribe the cores beside them."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """Both meshes' rank results, {shape: {task: [rank results]}}, and
    the ranks' directory (one process's step-0 checkpoints written there
    first)."""
    d = str(tmp_path_factory.mktemp("zoo"))
    torch.save(jax_masks(G, 1, W.STEPS), os.path.join(d, "masks.pt"))
    for opt in W.ZOO_CKPT:
        W.ckpt_run(opt, None, [0], save=os.path.join(d, f"one_{opt}"))
    tasks = [f"{t}@{shape}" for shape, ts in WORLDS.items() for t in ts]
    W.wait(W.spawn(",".join(tasks), 4, d))
    return {shape: {t: [torch.load(os.path.join(d, f"{t}@{shape}-{r}.pt"),
                                   weights_only=False) for r in range(4)]
                    for t in ts}
            for shape, ts in WORLDS.items()}, d


# one process at G', computed once for both meshes
@functools.lru_cache(maxsize=None)
def _pretrain(opt):
    steps = W.ZOO_PRETRAIN.get(opt, W.MESH_STEPS)
    return W.zoo_pretrain(opt, steps)


@functools.lru_cache(maxsize=None)
def _finetune(opt):
    return W.zoo_finetune(opt)


@functools.lru_cache(maxsize=None)
def _adamp_updates(opt):
    return W.adamp_updates(opt)


def _max_err(got, want):
    return max(float((got[n] - v).abs().max()) for n, v in want.items())


def _probe_err(got, want):
    """The largest probe error over the steps and tensors, relative to the
    tensor's own largest magnitude."""
    assert len(got) == len(want)
    return max(float((g[n] - v).abs().max())
               / max(float(v.abs().max()), 1e-30)
               for g, w in zip(got, want) for n, v in w.items())


def _close(got, want, params_atol):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=0,
                                   err_msg=key)
    for n, v in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(),
                                   atol=params_atol, rtol=0, err_msg=n)


# --- the entries against one process ----------------------------------------


@pytest.mark.parametrize("shape", ["122", "221"])
def test_adamp_sgdp_lookahead_pretrain_equal_one_process(runs, shape):
    """adamp, sgdp (2 steps) and lookahead_adamp (7: its k = 6 sync runs)
    in the tiny pretrain step, masks drawn in the step."""
    results, _ = runs
    for got in results[shape]["zoo_pretrain"]:
        for opt in W.ZOO_PRETRAIN:
            _close(got[opt], _pretrain(opt), ATOL)


@pytest.mark.parametrize("shape", ["122", "221"])
def test_adamp_sgdp_project_as_one_process(runs, shape):
    """Two updates of the BB-MCA weights, the second from gradients
    orthogonal to each weight in every channel row: the gathered weights
    equal one process's; every rank makes the same (use_ch, use_ly) choice
    for every parameter it cuts, and the channel view projects."""
    results, _ = runs
    outs = results[shape]["zoo_project"]
    for opt in ("adamp", "sgdp"):
        want = _adamp_updates(opt)
        for got in outs:
            assert _max_err(got[opt], want) <= ATOL, opt
        choices = [got[f"{opt}_choices"] for got in outs]
        assert all(c == choices[0] for c in choices[1:]), opt
        assert len(choices[0]) == 2 and choices[0][1]
        assert any(ch for ch, _ in choices[0][1].values()), opt


@pytest.mark.parametrize("shape", ["122", "221"])
def test_adafactor_finetune_equals_one_process(runs, shape):
    """adafactor in the BB-MCA finetune step at BB_GEO's width 128, whose
    fc1, qkv, proj and fc2 factor on their full shape."""
    results, _ = runs
    for got in results[shape]["zoo_adafactor"]:
        _close(got["finetune"], _finetune("adafactor"), ATOL)


def test_adafactor_equals_one_process_and_mofo_tpu_on_its_mesh(runs):
    """The wide pretrain step (width 128) with G''s masks injected: the
    (1, 2, 2) ranks against one process, and against mofo_tpu's jitted
    step on build_mesh(MeshConfig(1, 2, 2)) of 4 CPU devices from the same
    weights (tests/test_train_step.py:276-284's bounds)."""
    results, d = runs
    masks = torch.load(os.path.join(d, "masks.pt"))
    want = W.zoo_pretrain("adafactor", W.STEPS, None, masks, W.wide_model())
    lr = np.full(W.STEPS, mp.STEPS_LR, np.float32)
    jmodel = jax_create_model(W.PRETRAIN, **W.WIDE_GEO)
    params = import_torch_pretrain(W.wide_model().state_dict())
    jtx = jax_optim.create_optimizer(params, opt="adafactor",
                                     lr_schedule=lr, betas=(0.9, 0.95),
                                     weight_decay=0.05)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(1, 2, 2),
                               devices=jax.devices()[:4])
    jstate = JaxTrainState.create(jax_mesh.shard_params(params, mesh), jtx)
    jstep = jax.jit(jax_make_pretrain_step(jmodel, jtx, jax_cfg(G, 1), lr))
    bsh = jax_mesh.batch_sharding(mesh)
    jbatch = {n: jax.device_put(jnp.asarray(v.numpy()), bsh)
              for n, v in W.pretrain_batch(G).items()}
    losses = []
    for _ in range(W.STEPS):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(JAX_RNG), 0.5)
        losses.append(float(m["loss"]))
    for out in results["122"]["zoo_adafactor"]:
        got = out["wide"]
        _close(got, want, ATOL)
        np.testing.assert_allclose(got["loss"], losses, rtol=2e-5)
        ours = import_torch_pretrain(got["params"])
        for a, b in zip(jax.tree.leaves(ours),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("step", ["pretrain", "finetune"])
@pytest.mark.parametrize("shape", ["122", "221"])
def test_adahessian_equals_one_process(runs, shape, step):
    """2 adahessian steps (the plain attention route, eps 1e-3, z drawn in
    the step; the pretrain at update_freq 2, the BB-MCA finetune with its
    augmentations, mixup and drop path): losses and gradient norms within
    rtol 1e-5, the probes the optimizer gets and the parameters within
    1e-4."""
    results, _ = runs
    want = _pretrain("adahessian") if step == "pretrain" else \
        _finetune("adahessian")
    assert len(want["probes"]) == W.MESH_STEPS
    for out in results[shape]["zoo_adahessian"]:
        got = out[step]
        _close(got, want, PROBE_BOUND)
        assert _probe_err(got["probes"], want["probes"]) <= PROBE_BOUND


# --- the planted faults ------------------------------------------------------


@pytest.mark.parametrize("fault", ["factored_dims_of_the_shard",
                                   "cosines_not_summed_over_model",
                                   "z_on_the_shards_shapes",
                                   "probe_reduced_over_the_world"])
def test_planted_faults_fail(runs, fault):
    """Each fault, on the (1, 2, 2) ranks, misses its bound by more than
    FAULT_FACTOR on every rank."""
    results, _ = runs
    ranks = results["122"]
    if fault == "factored_dims_of_the_shard":
        want, bound = _finetune("adafactor")["params"], ATOL
        errs = [_max_err(got["fault"]["params"], want)
                for got in ranks["zoo_adafactor"]]
    elif fault == "cosines_not_summed_over_model":
        want, bound = _adamp_updates("adamp"), ATOL
        errs = [_max_err(got["fault"], want) for got in ranks["zoo_project"]]
    else:
        key = "local_z" if fault == "z_on_the_shards_shapes" else \
            "world_reduce"
        want, bound = _pretrain("adahessian"), PROBE_BOUND
        errs = [max(_max_err(got[key]["params"], want["params"]),
                    _probe_err(got[key]["probes"], want["probes"]))
                for got in ranks["zoo_adahessian"]]
    assert min(errs) > FAULT_FACTOR * bound, errs


# --- checkpoints across meshes -----------------------------------------------


def _shapes(path):
    """The file's model and optimizer-state keys and shapes."""
    ck = torch.load(path, weights_only=True)
    names = ck["optimizer"]["param_groups"][0]["param_names"]
    return ({n: tuple(v.shape) for n, v in ck["model"].items()},
            {names[i]: {k: tuple(v.shape) for k, v in s.items()}
             for i, s in ck["optimizer"]["state"].items()}), ck


@pytest.mark.parametrize("opt", W.ZOO_CKPT)
def test_checkpoints_carry_the_state_across_meshes(runs, opt):
    """Step 0 written on (1, 2, 2) holds the keys and shapes (and, within
    the bound, the values) of one process's; resumed in one process, and
    one process's resumed on the mesh, step 1 then equals the
    uninterrupted run."""
    results, d = runs
    bound = PROBE_BOUND if opt == "adahessian" else ATOL
    mesh_file = os.path.join(d, f"mesh_{opt}", "checkpoint-0.pth")
    one_file = os.path.join(d, f"one_{opt}", "checkpoint-0.pth")
    (got, got_ck), (want, want_ck) = _shapes(mesh_file), _shapes(one_file)
    assert got == want
    if opt == "adafactor":  # factored moments: vectors in mofo_tpu's layout
        assert any(len(s["v_row"]) == 1 and s["v_row"][0] > 1
                   for s in want[1].values())
    for i, s in want_ck["optimizer"]["state"].items():
        for k, v in s.items():
            np.testing.assert_allclose(
                got_ck["optimizer"]["state"][i][k].numpy(), v.numpy(),
                atol=bound, rtol=1e-5, err_msg=f"{i} {k}")
    whole = W.ckpt_run(opt, None, [0, 1])
    resumed = W.ckpt_run(opt, None, [1], resume=os.path.dirname(mesh_file))
    assert _max_err(resumed, whole) <= bound
    for got_ranks in results["122"]["zoo_checkpoint"]:
        assert _max_err(got_ranks[opt], whole) <= bound


# --- the runners -------------------------------------------------------------


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_runners_take_the_zoo_on_the_mesh(runs, tmp_path, monkeypatch):
    """cli.pretrain_mofo --opt adahessian on the (1, 2, 2) ranks for an
    epoch against one process fed the same global batches; cli.finetune_mofo
    --opt lookahead_adafactor on the mesh validates and prints one final
    test."""
    results, out = runs
    printed = results["122"]["zoo_cli"]
    monkeypatch.setattr(P, "ShardedSampler", mesh_ranks.coord_order(2, 2))
    one = str(tmp_path / "one")
    with contextlib.redirect_stdout(io.StringIO()):
        pretrain_mofo.main(pretrain_mofo.get_args(
            W.pretrain_argv(one, 4, epochs=1) + W.CONSTANT_LR
            + W.ZOO_CLI_PRETRAIN, mofo_defaults=True))
    got, want = _log(os.path.join(out, "zoo_pt")), _log(one)
    assert [x["epoch"] for x in got] == [0]
    for key in ("train_loss", "train_grad_norm"):
        np.testing.assert_allclose([x[key] for x in got],
                                   [x[key] for x in want], rtol=RTOL,
                                   err_msg=key)
    assert "attention routed through XLA" in printed[0]["pretrain"]
    assert printed[0]["finetune"].count("Final test: Acc@1") == 1
    log = _log(os.path.join(out, "zoo_ft"))
    assert [x["epoch"] for x in log] == [0]
    assert np.isfinite(log[0]["train_loss"]) and "val_acc1" in log[0]
