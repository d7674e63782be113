"""The port's optimizer zoo (mofo_tpu_torch.train.optim) against
mofo_tpu.train.optim.create_optimizer.

Every one of the 29 first-order names of tests/test_optim.py (TestZoo) and
adahessian (fed a seeded Hessian estimate) takes three updates with seeded
gradients (seven for lookahead_* and radam, so that the lookahead syncs and
RAdam's rectified branch runs) on pretrain_videomae_tiny_debug's parameters, carried across by
params_from_jax, plain and with every option on (--only_finetune_last's
trainable, layer decay, a clip that fires and a WD schedule). Parameters
agree within atol 1e-6, rtol 1e-5 (f32 rounding of differently ordered
sums; a skipped stage or a wrong axis moves them by lr ~ 1e-3).

The tiny model has no parameter whose channel view or factored axes depend
on the layout (no two axes of 128 or more, and its gradients are not
scale-invariant), so AdamP, SGDP and Adafactor are held again on a tree of
non-square kernels with gradients orthogonal to the weights channel by
channel (after a first step with a radial part); there the planted
mistake, AdamP's channel view on the port's own axis 0, must fail the same
bound by 10x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.train import optim as jax_optim
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.checkpoint import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


# tests/test_optim.py:199-205
FIRST_ORDER = [
    "adamw", "adam", "sgd", "nesterov", "momentum", "lamb",
    "adafactor", "rmsprop", "adadelta", "lars", "lion", "nadam",
    "radam", "novograd", "adamax", "adagrad", "adabelief",
    "yogi", "fusedadam", "fusedadamw", "fusedsgd", "fusedlamb",
    "fusednovograd", "nvnovograd", "fusedmomentum",
    "adamp", "sgdp", "lookahead_adamw", "lookahead_sgd",
]
ATOL, RTOL = 1e-6, 1e-5
LOOKAHEAD_K = 6  # mofo_tpu/train/optim.py's lookahead sync period
LR = np.array([1e-3, 8e-4, 6e-4, 4e-4], np.float32)
WD = np.array([0.05, 0.04, 0.03, 0.02], np.float32)


def _tiny_params():
    model = jax_create_model("pretrain_videomae_tiny_debug", img_size=32,
                             num_frames=4, decoder_depth=1)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)),
                      jnp.zeros((1, 4), jnp.int32),
                      jnp.zeros((1, 4), jnp.int32))["params"]


@pytest.fixture(scope="module")
def tiny():
    return jax.tree.map(np.asarray, _tiny_params())


def _draws(params, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (scale * rng.randn(*np.shape(p))).astype(np.float32),
        params)


def _port(tree):
    return {n: t.clone() for n, t in params_from_jax(tree).items()}


def _run_both(params, opt, *, grads, hess=None, **kw):
    """One update per entry of `grads` in both packages; returns (JAX
    params as port names, port params, port optimizer state)."""
    jkw = dict(kw)
    pkw = dict(kw)
    if "trainable" in kw:
        jkw["trainable"] = lambda path, leaf: (
            jax_optim.path_names(path)[0] == "decoder")
        pkw["trainable"] = lambda name, t: name.startswith("decoder.")
    jtx = jax_optim.create_optimizer(params, opt=opt, **jkw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jtx.init(jp)
    ours = _port(params)
    tx = optim.create_optimizer(ours, opt=opt, **pkw)
    st = tx.init(ours)
    for s in range(len(grads)):
        extra = {}
        if hess is not None:
            extra = {"hessian_diag": jax.tree.map(jnp.asarray, hess[s])}
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, grads[s]), jst, jp,
                              **extra)
        jp = optax.apply_updates(jp, upd)
        tx.update(params_from_jax(grads[s]), st, ours,
                  hessian_diag=(None if hess is None
                                else params_from_jax(hess[s])))
    return params_from_jax(jax.tree.map(np.asarray, jp)), ours, st


def _steps(opt):
    """3 updates; 7 where a branch starts later: the lookahead syncs at
    update LOOKAHEAD_K, RAdam rectifies from rho_t >= 5 (rho_t ~ t)."""
    return 7 if opt.startswith("lookahead_") or opt == "radam" else 3


def _radam_rho(t, b2=0.999):
    """optax.scale_by_radam's rho_t (transform.py:773) at update t."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    return ro_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)


def _close(ref, ours):
    for n, want in ref.items():
        np.testing.assert_allclose(ours[n].numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=n)


@pytest.mark.parametrize("options", [False, True])
@pytest.mark.parametrize("opt", FIRST_ORDER + ["adahessian",
                                               "lookahead_adahessian"])
def test_every_zoo_name_matches_mofo_tpu(tiny, opt, options):
    # clip 1.0 fires: the seeded gradients' global norm is ~600
    kw = dict(lr_schedule=LR, weight_decay=0.05)
    if options:
        kw.update(wd_schedule=WD, layer_decay=0.75, clip_grad=1.0,
                  trainable=True)
    steps = _steps(opt)
    grads = [_draws(tiny, s) for s in range(steps)]
    hess = None
    if optim.is_second_order(opt):
        hess = [_draws(tiny, 10 + s) for s in range(steps)]
    ref, ours, st = _run_both(tiny, opt, grads=grads, hess=hess, **kw)
    _close(ref, ours)
    before = params_from_jax(tiny)
    moved = [n for n in ours if not torch.equal(ours[n], before[n])]
    if options:  # only the decoder trains
        assert moved and all(n.startswith("decoder.") for n in moved)
        full = opt.split("_")[-1] in ("adamp", "sgdp", "adahessian")
        for field, per_name in st.buffers.items():
            assert (set(per_name) == set(ours)) == full, field
    else:
        assert len(moved) > len(ours) // 2, opt
    assert st.count == steps
    if opt.startswith("lookahead_"):
        assert st.slow and all(s.data_ptr() != ours[n].data_ptr()
                               for n, s in st.slow.items())
        # a sync happened: the slow weights left their start
        assert st.count >= LOOKAHEAD_K
        assert any(not torch.equal(s, before[n]) for n, s in st.slow.items())
    if opt == "radam":  # the rectified branch ran, not only mu_hat
        assert _radam_rho(steps) >= 5.0 > _radam_rho(3)


def test_unknown_name_raises_as_mofo_tpu_does():
    with pytest.raises(ValueError, match="Unknown optimizer: shampoo"):
        jax_optim.create_optimizer({"w": jnp.ones((2,))},
                                   lr_schedule=np.array([0.1]),
                                   opt="shampoo")
    with pytest.raises(ValueError, match="Unknown optimizer: shampoo"):
        optim.create_optimizer({"w": torch.ones(2)},
                               lr_schedule=np.array([0.1]), opt="shampoo")


def test_is_second_order_matches_mofo_tpu():
    for name in FIRST_ORDER + ["adahessian", "lookahead_adahessian",
                               "LookAhead_AdaHessian"]:
        assert optim.is_second_order(name) == jax_optim.is_second_order(
            name), name


def test_adahessian_needs_the_probe():
    p = {"w": torch.ones(2, 2)}
    tx = optim.create_optimizer(p, opt="adahessian",
                                lr_schedule=np.array([0.1]))
    with pytest.raises(ValueError, match="hessian_diag"):
        tx.update({"w": torch.ones(2, 2)}, tx.init(p), p)


def _one_leaf(path, leaf):
    tree = leaf
    for key in reversed(path):
        tree = {key: tree}
    return tree


def test_jax_layout_gives_mofo_tpu_leaves(tiny):
    """jax_layout maps every port parameter to its JAX leaf, value for
    value, and torch_layout back (the pretrain model here, the BB-focused
    model in test_torch_second_order.py's step)."""
    leaves = jax.tree_util.tree_leaves_with_path(tiny)
    assert len(leaves) == len(params_from_jax(tiny))
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        (name, t), = params_from_jax(_one_leaf(keys, leaf)).items()
        np.testing.assert_array_equal(optim.jax_layout(name, t).numpy(),
                                      np.asarray(leaf), err_msg=name)
        back = optim.torch_layout(name, optim.jax_layout(name, t), t.shape)
        assert torch.equal(back, t), name


# --- where the layout matters ---------------------------------------------


def _layout_tree():
    """Kernels whose channel view (axis 0 in JAX's layout) and factored
    axes differ from the port's: an fc1 of (in 128, out 384), a square proj
    (a tie in the factored axes) and a patch embedding of (t*p*p*C =
    384, D = 128)."""
    rng = np.random.RandomState(3)
    f = lambda *s: (0.1 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return {"encoder": {
        "patch_embed": {"kernel": f(384, 128), "bias": f(128)},
        "blocks_0": {"mlp": {"fc1": {"kernel": f(128, 384),
                                     "bias": f(384)}},
                     "attn": {"proj_kernel": f(256, 256),
                              "proj_bias": f(256)}}}}


def _orthogonal_grads(tree, seed):
    """Gradients orthogonal to the weights in every row of JAX's channel
    view (scale-invariant in the channel view, so AdamP projects there)."""
    rng = np.random.RandomState(seed)

    def leaf(p):
        g = rng.randn(*p.shape).astype(np.float32)
        if p.ndim < 2:
            return g
        pm = p.reshape(p.shape[0], -1).astype(np.float64)
        gm = g.reshape(p.shape[0], -1).astype(np.float64)
        gm -= pm * (gm * pm).sum(1, keepdims=True) / (pm * pm).sum(
            1, keepdims=True)
        return gm.reshape(p.shape).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("opt", ["adamp", "sgdp", "lookahead_adamp"])
def test_adamp_sgdp_channel_view_is_mofo_tpus(opt, monkeypatch):
    tree = _layout_tree()
    # a first gradient with a radial part, which SGDP's momentum carries
    # into the projected steps
    grads = [_draws(tree, 0)] + [_orthogonal_grads(tree, s)
                                 for s in (1, 2)]
    kw = dict(lr_schedule=LR, wd_schedule=WD)
    ref, ours, _ = _run_both(tree, opt, grads=grads, **kw)
    _close(ref, ours)
    # the planted mistake: the channel view on the port's own axis 0
    monkeypatch.setattr(optim, "jax_layout", lambda name, t: t)
    monkeypatch.setattr(optim, "torch_layout", lambda name, t, shape: t)
    _, wrong, _ = _run_both(tree, opt, grads=grads, **kw)
    name = "encoder.blocks.0.mlp.fc1.weight"
    err = (wrong[name] - ref[name]).abs().max().item()
    assert err > 10 * (ATOL + RTOL * ref[name].abs().max().item()), err


def test_adafactor_factors_the_same_semantic_axes():
    """The row and column moments are mofo_tpu's, value for value: the
    factored axes are picked on JAX's shape (the port's fc1 weight is
    (384, 128), the patch embedding (128, 3, 2, 8, 8))."""
    tree = _layout_tree()
    grads = [_draws(tree, s) for s in range(3)]
    jtx = jax_optim.create_optimizer(tree, opt="adafactor", lr_schedule=LR)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jtx.init(jp)
    ours = _port(tree)
    tx = optim.create_optimizer(ours, opt="adafactor", lr_schedule=LR)
    st = tx.init(ours)
    for s in range(3):
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, grads[s]), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(params_from_jax(grads[s]), st, ours)
    factored = jst[0]
    for jname, name in (
            (("blocks_0", "mlp", "fc1", "kernel"),
             "encoder.blocks.0.mlp.fc1.weight"),
            (("blocks_0", "attn", "proj_kernel"),
             "encoder.blocks.0.attn.proj.weight"),
            (("patch_embed", "kernel"), "encoder.patch_embed.proj.weight")):
        for field in ("v_row", "v_col"):
            want = getattr(factored, field)["encoder"]
            for key in jname:
                want = want[key]
            got = st.buffers[field][name]
            assert got.shape == want.shape, (name, field)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, err_msg=f"{name} {field}")
    _close(params_from_jax(jax.tree.map(np.asarray, jp)), ours)
