"""The fsdp and model axes of a mesh (mofo_tpu_torch/parallel/mesh.py) on
the CPU: 4 ranks over gloo, laid out on (1, 2, 2) and then on (2, 2, 1),
spawned once as tests/torch_ddp_worker.py's mesh_* tasks (which import no
JAX), each held
against one port process at the global batch G'; the (1, 2, 2) pretrain
steps also against mofo_tpu's jitted step on a (1, 2, 2) mesh of 4 CPU
devices; the layout rules against mofo_tpu's param_sharding_rules and
MeshConfig.resolve.
"""

import contextlib
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
from mofo_tpu.train.checkpoint import (
    import_torch_pretrain,
    load_torch_checkpoint,
)
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_make_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.cli import pretrain_mofo
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.models import create_model, registry
from mofo_tpu_torch.models.layers import Attention
from mofo_tpu_torch.parallel import mesh as mesh_lib
from mofo_tpu_torch.parallel.tensor_parallel import Axis
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.tools import mesh_ranks
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.checkpoint import _layout, _name
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState
from test_torch_ddp import JAX_RNG, jax_cfg, jax_masks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


G = W.MESH_G
# the tasks of each mesh, all run by one set of 4 ranks
WORLDS = {"122": ("mesh_pretrain", "mesh_finetune", "mesh_checkpoint",
                  "mesh_loss_scale", "mesh_optim", "mesh_cli"),
          "221": ("mesh_pretrain", "mesh_finetune")}


def _meta(name, **kw):
    """The port's model `name` with its parameters on the meta device
    (shapes and names only)."""
    with torch.device("meta"):
        return registry._REGISTRY[name](generator=torch.Generator(), **kw)


def _one_process_checkpoint(d):
    """One process's tiny pretrain step and its checkpoint-0.pth in d."""
    model = W.pretrain_model()
    lrs = np.full(2, mp.STEPS_LR, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lrs)
    state = TrainState.create(model, tx, use_ema=True)
    step = make_pretrain_step(model, tx, W.pretrain_cfg(G, 1), lrs,
                              device="cpu")
    state, _ = step(state, W.pretrain_batch(G),
                    torch.Generator().manual_seed(0), 0.5)
    ckpt.save_checkpoint(d, model, state, 0)
    return model, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' rank results, {shape: {task: [rank results]}}, and
    the ranks' directory."""
    d = str(tmp_path_factory.mktemp("mesh"))
    torch.save(jax_masks(G, 1, W.STEPS), os.path.join(d, "masks.pt"))
    _one_process_checkpoint(os.path.join(d, "one"))
    tasks = [f"{t}@{shape}" for shape, ts in WORLDS.items() for t in ts]
    W.wait(W.spawn(",".join(tasks), 4, d))
    return {shape: {t: [torch.load(os.path.join(d, f"{t}@{shape}-{r}.pt"),
                                   weights_only=False) for r in range(4)]
                    for t in ts}
            for shape, ts in WORLDS.items()}, d


def _close(got, want, rtol, params_atol):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                   err_msg=key)
    for n, v in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(),
                                   atol=params_atol, rtol=0, err_msg=n)


# --- (a) the mesh shapes -----------------------------------------------------


@pytest.mark.parametrize("world", range(1, 9))
def test_resolve_accepts_what_mofo_tpu_accepts(world):
    for data in (-1, 0, 1, 2, 3, 4, 8):
        for fsdp in (1, 2, 3, 4):
            for model in (1, 2, 4, 8):
                try:
                    want = jax_mesh.MeshConfig(data, fsdp, model).resolve(
                        world)
                except AssertionError:
                    want = None
                port = mesh_lib.MeshConfig(data, fsdp, model)
                if want is None:
                    with pytest.raises(ValueError):
                        port.resolve(world)
                else:
                    assert port.resolve(world) == want
    with pytest.raises(ValueError, match="at least one"):
        mesh_lib.MeshConfig(-1, 0, 1).resolve(world)


def test_mesh_coordinates_and_axes():
    """Rank r of (2, 2, 2) sits at (d, f, m), r = (d * 2 + f) * 2 + m, as
    mofo_tpu's reshape of the device list; its batch axis is the ranks of
    its m in (d, f) order."""
    for rank in range(8):
        mesh = mesh_lib.Mesh((2, 2, 2), rank)
        d, f, m = mesh.coord
        assert rank == (d * 2 + f) * 2 + m
        assert mesh.batch.ranks == tuple(b * 2 + m for b in range(4))
        assert mesh.batch.index == d * 2 + f
        assert mesh.model.ranks == (rank - m, rank - m + 1)
        assert mesh.fsdp.ranks == tuple((d * 2 + i) * 2 + m
                                        for i in range(2))
    devices = np.arange(8).reshape(2, 2, 2)
    for rank in range(8):
        assert tuple(np.argwhere(devices == rank)[0]) == \
            mesh_lib.Mesh((2, 2, 2), rank).coord


# --- (b) the sharding rules against mofo_tpu's ------------------------------


def _jax_specs(name, **kw):
    """mofo_tpu's param_sharding_rules on (1, 2, 2) for every leaf of the
    model, by the port's parameter name: per JAX dim, the axis or None."""
    model = jax_create_model(name, **kw)
    if "pretrain" in name:
        x = jnp.zeros((1, 1568, 1536))
        vis = jnp.zeros((1, 160), jnp.int32)
        masked = jnp.zeros((1, 1408), jnp.int32)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, vis,
                                masked)["params"]
    else:
        clip = jnp.zeros((1, 16, 224, 224, 3))
        boxes = jnp.zeros((1, 16, 4))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), clip,
                                boxes)["params"]
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(1, 2, 2),
                               devices=jax.devices()[:4])
    rules = jax_mesh.param_sharding_rules(shapes, mesh)
    out = {}
    for (path, leaf), (_, rule) in zip(
            jax.tree_util.tree_leaves_with_path(shapes),
            jax.tree_util.tree_leaves_with_path(rules)):
        keys = tuple(k.key for k in path)
        torch_name, _ = _name(keys, np.zeros(leaf.shape, np.float32), 3, 2)
        spec = tuple(rule.spec) + (None,) * (len(leaf.shape)
                                            - len(rule.spec))
        out[torch_name] = spec
    return out


def _port_spec_in_jax_layout(name, shape):
    lay = mesh_lib.layout_for(name, shape, (1, 2, 2))
    axes = [None] * len(shape)
    for axis in ("fsdp", "model"):
        if getattr(lay, axis) is not None:
            axes[getattr(lay, axis)] = axis
    transposed, permuted = _layout(name)
    if permuted:  # (D, C, t, p, p) -> (t*p*p*C, D)
        return (None, axes[0])
    return tuple(reversed(axes)) if transposed else tuple(axes)


@pytest.mark.parametrize("name,jax_kw", [
    ("pretrain_videomae_base_patch16_224", {}),
    ("vit_base_patch16_224_BB_focused", {"fusing_method": "MCA",
                                         "num_classes": 174}),
])
def test_spec_for_param_matches_param_sharding_rules(name, jax_kw):
    """Every leaf of ViT-B and of the BB-focused model, read through the
    packages' layout map: the same mesh axes on the same weight axes (the
    heads rule aside, which has its own case)."""
    want = _jax_specs(name, **jax_kw)
    model = _meta(name, **jax_kw)
    got = {n: _port_spec_in_jax_layout(n, tuple(p.shape))
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert got == want
    assert any("model" in s for s in got.values())
    assert any("fsdp" in s for s in got.values())


def test_fused_qkv_rows_split_by_heads_inside_q_k_v():
    """The documented difference: rank m's rows of the (3A, D) qkv weight
    are [q_m; k_m; v_m] (mofo_tpu's P('fsdp', 'model') would hand it a
    contiguous third of 3A, across the q/k/v boundary); the MCA's kv alike
    with [k_m; v_m]; full() puts the reference's order back."""
    A, D, M = 8, 4, 2
    full = torch.arange(3 * A * D, dtype=torch.float32).reshape(3 * A, D)
    name = "encoder.blocks.0.attn.qkv.weight"
    lay = mesh_lib.layout_for(name, full.shape, (1, 1, M))
    assert (lay.model, lay.fsdp, lay.sections) == (0, None, 3)
    shards = []
    for m in range(M):
        sh = mesh_lib.Sharding(mesh_lib.Mesh((1, 1, M), m), {name: lay})
        shards.append(sh.shard(name, full))
        h = A // M
        want = torch.cat([full[s * A + m * h:s * A + (m + 1) * h]
                          for s in range(3)])
        assert torch.equal(shards[-1], want)
        assert not torch.equal(shards[-1], full.chunk(M)[m])
    assert torch.equal(mesh_lib._join(shards, 0, 3), full)
    kv = "local_MCA.0.attn.kv.weight"
    assert mesh_lib.layout_for(kv, (2 * A, D), (1, 1, M)).sections == 2


# --- (g) the heads rule and the route --------------------------------------


def test_heads_that_do_not_divide_stay_replicated():
    """The ViT-B MCA's 3 x 256 at model 2, the ViT-S decoder's 3 x 64 and
    the tiny BB model's 2 x 32 at model 4 compute whole on every model
    rank; their MLPs still split."""
    bb = _meta("vit_base_patch16_224_BB_focused", fusing_method="MCA")
    splits = mesh_lib._model_axis_modules(bb, 2)
    assert splits["local_MCA.0.attn"] is False
    assert splits["local_MCA.0.mlp"] is True
    assert splits["backbone.blocks.0.attn"] is True
    vits = _meta("pretrain_videomae_small_patch16_224")
    splits = mesh_lib._model_axis_modules(vits, 2)
    assert splits["decoder.blocks.0.attn"] is False
    assert splits["encoder.blocks.0.attn"] is True
    tiny = _meta("vit_tiny_debug_BB_focused", fusing_method="MCA")
    assert mesh_lib._model_axis_modules(tiny, 4)["local_MCA.0.attn"] is False
    lay = mesh_lib.layout_for("local_MCA.0.attn.kv.weight", (512, 256),
                              (1, 2, 2), model_ok=False)
    assert (lay.model, lay.fsdp) == (None, 1)


@pytest.mark.parametrize("heads,flat", [(6, True), (16, True), (2, False)])
def test_route_is_chosen_from_the_unsharded_width(heads, flat):
    """At model 2 the ViT-B decoder's 6 x 64 heads (A = 192 a rank) keep
    the flat K1/K2 route of A = 384 with 3 heads a rank, as ViT-L's 16 x 64
    with 8; the tiny 2 x 32 stays head-major."""
    attn = Attention(heads * (64 if heads > 2 else 32), heads,
                     qkv_bias=True)
    attn.set_model_axis(Axis("model", 2, 1, (0, 1)))
    assert attn.local_heads == heads // 2
    assert attn.uses_flat(1568) is flat
    assert attn.head_range() == (heads // 2, heads)


# --- (c), (e) the ranks against one process at G' ---------------------------


@pytest.mark.parametrize("shape", ["122", "221"])
def test_pretrain_step_equals_one_process(runs, shape):
    results, _ = runs
    masks = jax_masks(G, 1, W.STEPS)
    want = {"injected": mp.pretrain_steps(
        W.pretrain_model(), W.pretrain_cfg(G, 1), W.pretrain_batch(G),
        W.STEPS, masks=list(masks)),
        "drawn": mp.pretrain_steps(
            W.pretrain_model(), W.pretrain_cfg(G, W.MESH_K), W.u8_batch(G),
            W.STEPS, augment=True)}
    coords = [out["coord"] for out in results[shape]["mesh_pretrain"]]
    assert coords == [(r // 4, r // 2 % 2, r % 2) if shape == "122"
                      else (r // 2, r % 2, 0) for r in range(4)]
    for out in results[shape]["mesh_pretrain"]:
        for kind in ("injected", "drawn"):
            _close(out[kind], want[kind], 1e-5, 1e-6)


def test_pretrain_step_equals_mofo_tpu_on_its_mesh(runs):
    """The (1, 2, 2) ranks with G''s masks injected against mofo_tpu's
    jitted step on build_mesh(MeshConfig(1, 2, 2)) of 4 CPU devices, the
    same weights: tests/test_train_step.py:276-284's bounds."""
    results, _ = runs
    jcfg = jax_cfg(G, 1)
    lr = np.full(W.STEPS, mp.STEPS_LR, np.float32)
    jmodel = jax_create_model(W.PRETRAIN, **W.PRETRAIN_GEO)
    params = import_torch_pretrain(W.pretrain_model().state_dict())
    jtx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                     betas=(0.9, 0.95), weight_decay=0.05)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(1, 2, 2),
                               devices=jax.devices()[:4])
    jstate = JaxTrainState.create(jax_mesh.shard_params(params, mesh), jtx)
    jstep = jax.jit(jax_make_pretrain_step(jmodel, jtx, jcfg, lr))
    bsh = jax_mesh.batch_sharding(mesh)
    jbatch = {n: jax.device_put(jnp.asarray(v.numpy()), bsh)
              for n, v in W.pretrain_batch(G).items()}
    losses = []
    for _ in range(W.STEPS):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(JAX_RNG), 0.5)
        losses.append(float(m["loss"]))
    for out in results["122"]["mesh_pretrain"]:
        got = out["injected"]
        np.testing.assert_allclose(got["loss"], losses, rtol=2e-5)
        ours = import_torch_pretrain(got["params"])
        for a, b in zip(jax.tree.leaves(ours),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("shape", ["122", "221"])
def test_bb_mca_finetune_step_equals_one_process(runs, shape):
    """RandAugment, crop, flip, erasing, mixup elem + cutmix (the partner
    rows from batch coordinate W-1-b), drop path, dropout and attention
    dropout (a head-sharded module's slice of the full draw); then one
    validation pass (sums over the batch axis) and the multi-view merge."""
    results, _ = runs
    want = mp.finetune_steps(
        W.mesh_finetune_model(), W.mesh_finetune_cfg(G),
        W.u8_batch(G, labels=True), W.MESH_STEPS, augment=True,
        eval_batch=W.eval_batch(G))
    nb = 2 if shape == "122" else 4
    for rank, got in enumerate(results[shape]["mesh_finetune"]):
        _close(got, want, 1e-5, 1e-5)
        for key, v in want["eval"].items():
            assert got["eval"][key] == pytest.approx(v, rel=1e-5), key
        b = rank // 2 if shape == "122" else rank
        rows = torch.from_numpy(__import__(
            "mofo_tpu_torch.parallel.ddp", fromlist=["x"]).global_rows(
                b, nb, G // nb))
        np.testing.assert_allclose(got["logits"].numpy(),
                                   want["logits"][rows].numpy(), atol=1e-5,
                                   rtol=0)
        assert got["multiview"] == want["multiview"]


def test_fp16_skip_is_decided_by_every_rank_together(runs):
    """The inf in batch coordinate 1's clips reaches every rank's gradient
    norm through the reductions: all four skip and back the scale off, and
    the next, finite step updates everywhere."""
    results, _ = runs
    for got in results["122"]["mesh_loss_scale"]:
        assert got["skipped"] == [1.0, 0.0]
        assert got["scale"] == [64.0, 64.0]
        assert got["kept"] and got["moved"]


# --- (f) checkpoints across meshes ------------------------------------------


def test_checkpoint_written_on_the_mesh_resumes_in_one_process(runs):
    results, out = runs
    outs = results["122"]["mesh_checkpoint"]
    for got in outs:
        assert got["files"] == ["checkpoint-0.pth"]
        assert got["path"] == outs[0]["path"]
    sd = torch.load(outs[0]["path"], weights_only=True)["model"]
    assert not any(n.startswith("module.") for n in sd)
    one, _ = _one_process_checkpoint(os.path.join(out, "ref"))
    for n, v in one.state_dict().items():
        np.testing.assert_allclose(sd[n].numpy(), v.numpy(), atol=1e-6,
                                   rtol=0, err_msg=n)
    params = import_torch_pretrain(load_torch_checkpoint(outs[0]["path"]))
    ref = import_torch_pretrain(W.pretrain_model().state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    model = create_model(W.PRETRAIN, device="cpu", seed=9, **W.PRETRAIN_GEO)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=np.ones(2, np.float32))
    state = TrainState.create(model, tx, use_ema=True)
    assert ckpt.auto_resume(os.path.dirname(outs[0]["path"]), model,
                            state) == 0
    assert (state.step, state.opt_state.count) == (1, 1)
    for n, v in sd.items():
        assert torch.equal(model.state_dict()[n], v)


def test_one_process_checkpoint_resumes_on_the_mesh(runs):
    """A file written by one process, auto-resumed into a sharded model of
    another seed on every rank: gathered back, every weight, moment and EMA
    is the file's, bit for bit."""
    results, out = runs
    path = os.path.join(out, "one", "checkpoint-0.pth")
    saved = torch.load(path, weights_only=True)
    names = saved["optimizer"]["param_groups"][0]["param_names"]
    mu = {names[i]: s["exp_avg"]
          for i, s in saved["optimizer"]["state"].items()}
    for got in results["122"]["mesh_checkpoint"]:
        assert got["epoch"] == 0 and (got["step"], got["count"]) == (1, 1)
        for n, v in saved["model"].items():
            assert torch.equal(got["resumed"][n], v), n
        for n, v in mu.items():
            assert torch.equal(got["mu"][n], v), n
        for n, v in saved["model_ema"].items():
            assert torch.equal(got["ema"][n], v), n


# --- (h) the optimizers -----------------------------------------------------


def test_optimizers_on_the_mesh_equal_one_process(runs):
    """AdamW, LAMB (whole-tensor trust ratios over the shards) and every
    elementwise zoo entry, clipped at 0.5, against one process; and
    create_optimizer builds every one of the zoo's 30 names on the sharded
    model (the layout-reading entries are held against one process in
    tests/test_torch_mesh_zoo.py)."""
    results, _ = runs
    outs = results["122"]["mesh_optim"]
    for opt in W.MESH_OPTS:
        want = mp.pretrain_steps(
            W.pretrain_model(), W.pretrain_cfg(G, 1), W.pretrain_batch(G),
            W.MESH_OPT_STEPS, opt=opt, clip_grad=0.5)
        # sign-based and normalized updates turn the reduction order's
        # rounding of a near-zero element into up to 2 lr of move
        atol = 2 * mp.STEPS_LR if opt in ("lion", "adagrad") else 1e-5
        for got in outs:
            _close(got["runs"][opt], want, 1e-5, atol)
    assert len(set(W.ZOO_NAMES)) == 30
    for got in outs:
        assert set(got["built"]) == set(W.ZOO_NAMES)
        for opt, stages in got["built"].items():
            assert isinstance(stages, list) and stages, (opt, stages)


# --- the runners -------------------------------------------------------------


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_runners_on_the_mesh(runs, tmp_path, monkeypatch):
    """cli.pretrain_mofo --mesh_fsdp 2 --mesh_model 2 on 4 ranks for epoch
    0, resumed for epoch 1 in one process, against both epochs in one
    process fed the same global batches; rank 0 alone writes log.txt and
    the checkpoints, whose names are the reference's. cli.finetune_mofo on
    the mesh validates and prints one final test."""
    results, out = runs
    printed = results["122"]["mesh_cli"]
    pt = os.path.join(out, "mesh_pt")
    assert [x["epoch"] for x in _log(pt)] == [0]
    assert sorted(os.listdir(pt)) == ["checkpoint-0.pth", "log.txt"]
    assert all(all(text == "" for text in out.values())
               for out in printed[1:])
    names = torch.load(os.path.join(pt, "checkpoint-0.pth"),
                       weights_only=True)["model"]
    assert set(names) == set(_meta("pretrain_videomae_tiny_debug",
                                   decoder_depth=1).state_dict())
    argv = W.pretrain_argv(pt, 4, epochs=2) + W.CONSTANT_LR
    with contextlib.redirect_stdout(io.StringIO()) as text:
        pretrain_mofo.main(pretrain_mofo.get_args(argv, mofo_defaults=True))
    assert "auto-resumed at epoch 1" in text.getvalue()
    monkeypatch.setattr(P, "ShardedSampler", mesh_ranks.coord_order(2, 2))
    one = str(tmp_path / "one")
    with contextlib.redirect_stdout(io.StringIO()):
        pretrain_mofo.main(pretrain_mofo.get_args(
            W.pretrain_argv(one, 4, epochs=2) + W.CONSTANT_LR,
            mofo_defaults=True))
    got, want = _log(pt), _log(one)
    for key in ("train_loss", "train_grad_norm"):
        np.testing.assert_allclose([x[key] for x in got],
                                   [x[key] for x in want], rtol=1e-5,
                                   err_msg=key)
    ft = os.path.join(out, "mesh_ft")
    assert printed[0]["finetune"].count("Final test: Acc@1") == 1
    assert "mesh (data, fsdp, model) = (1, 2, 2)" in printed[0]["finetune"]
    log = _log(ft)
    assert [x["epoch"] for x in log] == [0]
    assert np.isfinite(log[0]["train_loss"]) and "val_acc1" in log[0]
