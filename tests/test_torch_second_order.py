"""AdaHessian's second-order training in the port against mofo_tpu, and the
rest of the optimizer zoo's plumbing: checkpoints, the CLIs' --opt, the
evaluation loss, the version and the wandb shim.

The second-order steps run beside mofo_tpu's (jitted, attn_impl="xla" on
both sides: the plain attention math) from the same weights, with the JAX
step's masks, mixup draws and Rademacher probes z (fold_in(key, 0x5EED),
split per leaf, optim.py:470-497) rebuilt with the JAX package's helpers
and injected. A recording optimizer on each side keeps the gradients and
the probe z * Hz the step hands it; loss, gradients and probe agree within
rtol 1e-4, relative to each tensor's largest magnitude (f32 sums of two
backward passes taken in another order). Three real adahessian steps then
hold the parameters within atol 1e-5 (at eps 1e-3; see the test).

The kernel routes refuse a double backward: each of the three autograd
functions of ops/flash_attention.py raises under create_graph=True on the
CPU (through its plain backward; tests/test_torch_gpu.py holds the card).
"""

import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ddp_worker as W
from mofo_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from mofo_tpu.core.config import MaskingConfig as JaxMaskingConfig
from mofo_tpu.core.config import PretrainConfig as JaxPretrainConfig
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import mixup as jax_mixup
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train import wandb_compat as jax_wandb
from mofo_tpu.train.finetune_step import (
    make_finetune_step as jax_finetune_step,
)
from mofo_tpu.train.loss_scale import DynamicLossScale as JaxLossScale
from mofo_tpu.train.pretrain_step import generate_mask as jax_generate_mask
from mofo_tpu.train.pretrain_step import make_eval_loss_fn as jax_eval_loss
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu.version import __version__ as jax_version
import mofo_tpu_torch
from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops.mixup import MixupParams
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.checkpoint import params_from_jax
from mofo_tpu_torch.train.finetune_step import make_finetune_step
from mofo_tpu_torch.train.loss_scale import DynamicLossScale
from mofo_tpu_torch.train.pretrain_step import (
    make_eval_loss_fn,
    make_pretrain_step,
)
from mofo_tpu_torch.train.train_state import TrainState
from mofo_tpu_torch.train.wandb_compat import WandbLogger


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


PRETRAIN = "pretrain_videomae_base_patch16_224"
PT_GEO = dict(img_size=32, num_frames=4, encoder_embed_dim=64,
              encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=32,
              decoder_depth=1, decoder_num_heads=2, decoder_num_classes=1536)
BB = "vit_base_patch16_224_BB_focused"
NC = 7
BB_GEO = dict(img_size=32, all_frames=4, embed_dim=128, depth=2,
              num_heads=2, num_classes=NC, init_scale=1.0,
              fusing_method="MCA", mca_num_heads=2)
B = 4
RTOL = 1e-4
PARAMS_ATOL = 1e-5
ADAHESSIAN_EPS = 1e-3
LR = np.array([1e-3, 8e-4, 6e-4, 4e-4], np.float32)
SEED_KEY = 0x5EED


def _close_rel(got, want, msg=""):
    """max |got - want| <= RTOL * max |want| (the tensor's own scale)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{msg}: {err} > {RTOL} * {scale}"


def _jax_z(params, key):
    """The probe mofo_tpu's hutchinson_diag draws from `key` (the step's
    microbatch key), as the port's names."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.fold_in(key, SEED_KEY), len(leaves))
    z = [np.asarray(jax.random.rademacher(k, np.shape(x), jnp.float32))
         for k, x in zip(keys, leaves)]
    return params_from_jax(jax.tree.unflatten(treedef, z))


def _micro_keys(rng, step, k):
    key = jax.random.fold_in(rng, step)
    return [key] if k == 1 else list(jax.random.split(key, k))


def _jax_recorder():
    """An optax transformation that applies nothing and keeps the
    gradients and the probe in its state."""
    def init(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        return (zeros, zeros)

    def update(updates, state, params=None, *, hessian_diag=None, **extra):
        del params, extra
        return jax.tree.map(jnp.zeros_like, updates), (updates,
                                                       hessian_diag)

    return optax.GradientTransformationExtraArgs(init, update)


class Recorder:
    """The port's counterpart: keeps what the step hands the optimizer."""

    def init(self, params):
        return None

    def update(self, grads, state, params, hessian_diag=None):
        self.grads = {n: g.clone() for n, g in grads.items()}
        self.hess = {n: h.clone() for n, h in hessian_diag.items()}


def _compare_recorded(rec, jstate, msg):
    jg, jh = (params_from_jax(jax.tree.map(np.asarray, t))
              for t in jstate.opt_state)
    for n in jg:
        _close_rel(rec.grads[n].numpy(), jg[n].numpy(), f"{msg} grad {n}")
        _close_rel(rec.hess[n].numpy(), jh[n].numpy(), f"{msg} probe {n}")


# --- the pretrain step ----------------------------------------------------


def _pt_batch():
    rng = np.random.RandomState(0)
    clip = rng.randn(B, 4, 32, 32, 3).astype(np.float32)
    xy1 = rng.uniform(0, 12, (B, 4, 2))
    boxes = np.concatenate([xy1, xy1 + rng.uniform(6, 18, (B, 4, 2))], -1)
    return {"clip": clip, "boxes": boxes.astype(np.float32)}


def _pt_cfgs(k):
    kw = dict(input_size=32, num_frames=4, batch_size=B, dtype="float32",
              update_freq=k, motion_loss_weight=True)
    return (JaxPretrainConfig(masking=JaxMaskingConfig(
                mask_type="tube_bb", mask_ratio=0.5), **kw),
            PretrainConfig(masking=MaskingConfig(mask_type="tube_bb",
                                                 mask_ratio=0.5), **kw))


def _pt_pair():
    batch = _pt_batch()
    jmodel = jax_create_model(PRETRAIN, attn_impl="xla", **PT_GEO)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["clip"]),
                         jnp.zeros((B, 4), jnp.int32),
                         jnp.zeros((B, 4), jnp.int32))["params"]
    model = create_model(PRETRAIN, device="cpu", attn_impl="xla", **PT_GEO)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model, batch


def _pt_masks_and_z(rng, s, batch, jcfg, params):
    k = jcfg.update_freq
    mb = B // k
    masks, zs = [], []
    for i, key in enumerate(_micro_keys(rng, s, k)):
        micro = {n: jnp.asarray(v[i * mb:(i + 1) * mb])
                 for n, v in batch.items()}
        masks.append(np.asarray(jax_generate_mask(
            jax.random.split(key, 3)[0], micro, jcfg)))
        zs.append(_jax_z(params, key))
    return torch.from_numpy(np.concatenate(masks)), zs


@pytest.mark.parametrize("update_freq", [1, 2])
def test_pretrain_probe_and_steps_match_mofo_tpu(update_freq):
    jcfg, cfg = _pt_cfgs(update_freq)
    jmodel, params, model, batch = _pt_pair()
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    jbatch = {n: jnp.asarray(v) for n, v in batch.items()}
    rng = jax.random.PRNGKey(2)
    # the gradients and the probe the step hands the optimizer
    jrec = _jax_recorder()
    jstate, jm = jax.jit(jax_pretrain_step(
        jmodel, jrec, jcfg, LR, second_order=True))(
        JaxTrainState.create(params, jrec), jbatch, rng, 0.5)
    rec = Recorder()
    mask, zs = _pt_masks_and_z(rng, 0, batch, jcfg, params)
    step = make_pretrain_step(model, rec, cfg, LR, device="cpu",
                              second_order=True)
    _, m = step(TrainState.create(model, rec), tbatch, None, 0.5,
                mask=mask, probe_z=zs)
    _close_rel(float(m["loss"]), float(jm["loss"]), "loss")
    _close_rel(float(m["grad_norm"]), float(jm["grad_norm"]), "grad_norm")
    _compare_recorded(rec, jstate, "pretrain")
    # three adahessian steps, at eps 1e-3: the probe's rounding (1e-4 of
    # its largest element) exceeds its smallest elements (1e-8), which at
    # eps 1e-8 would swing single updates by 1e4 lr in either package
    jtx = jax_optim.create_optimizer(params, opt="adahessian",
                                     lr_schedule=LR, eps=ADAHESSIAN_EPS)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_pretrain_step(jmodel, jtx, jcfg, LR,
                                      second_order=True))
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                opt="adahessian", lr_schedule=LR,
                                eps=ADAHESSIAN_EPS)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, tx, cfg, LR, device="cpu",
                              second_order=True)
    for s in range(3):
        mask, zs = _pt_masks_and_z(rng, s, batch, jcfg, params)
        jstate, jm = jstep(jstate, jbatch, rng, 0.5)
        state, m = step(state, tbatch, None, 0.5, mask=mask, probe_z=zs)
        _close_rel(float(m["loss"]), float(jm["loss"]), f"loss {s}")
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[n].numpy(),
                                   atol=PARAMS_ATOL, rtol=0, err_msg=n)


def test_eval_loss_fn_matches_mofo_tpu():
    jcfg, cfg = _pt_cfgs(1)
    jmodel, params, model, batch = _pt_pair()
    key = jax.random.PRNGKey(4)
    mask = np.asarray(jax_generate_mask(
        jax.random.split(key, 3)[0],
        {n: jnp.asarray(v) for n, v in batch.items()}, jcfg))
    want = jax_eval_loss(jmodel, jcfg)(
        params, {n: jnp.asarray(v) for n, v in batch.items()}, key)
    got = make_eval_loss_fn(model, cfg)(
        {n: torch.from_numpy(v) for n, v in batch.items()},
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert model.training  # the train mode comes back


# --- the finetune step ----------------------------------------------------


def _ft_batch():
    rng = np.random.RandomState(0)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[0] = [3.0, 5.0, 14.0, 12.0]
    boxes[1] = [100.0, 100.0, 120.0, 120.0]  # no in-box token
    boxes[2] = [0.0, 0.0, 32.0, 32.0]  # no out-box token
    boxes[3] = [10.0, 2.0, 30.0, 20.0]
    return {"clip": rng.randn(B, 4, 32, 32, 3).astype(np.float32),
            "label": np.array([1, 5, 0, 3], np.int32), "boxes": boxes}


def _jax_mixup_draws(jm, key, count, H, W):
    r_params, r_box = jax.random.split(key)
    lam, use_cutmix = jm._sample_params(r_params, count)
    box = jax_mixup._rand_bbox(r_box, H, W, lam, count)
    return MixupParams(np.asarray(lam), np.asarray(use_cutmix),
                       tuple(np.asarray(c) for c in box))


@pytest.mark.parametrize("update_freq,scaled", [(1, False), (2, False),
                                                (2, True)])
def test_finetune_probe_matches_mofo_tpu(update_freq, scaled):
    """BB-MCA with mixup (batch mode), f32; `scaled` runs under the loss
    scale (2^7), whose scaled-loss probe is divided by k * scale."""
    kw = dict(input_size=32, num_frames=4, batch_size=B, nb_classes=NC,
              dtype="float32", drop_path=0.0, update_freq=update_freq)
    jcfg, cfg = JaxFinetuneConfig(**kw), FinetuneConfig(**kw)
    batch = _ft_batch()
    jmodel = jax_create_model(BB, attn_impl="xla", **BB_GEO)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["clip"]),
                         jnp.asarray(batch["boxes"]))["params"]
    model = create_model(BB, device="cpu", attn_impl="xla", **BB_GEO)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    jrec, rec = _jax_recorder(), Recorder()
    jstate = JaxTrainState.create(
        params, jrec, loss_scale=JaxLossScale.create() if scaled else None)
    jstate, jm = jax.jit(jax_finetune_step(
        jmodel, jrec, jcfg, LR, bb_focused=True, second_order=True))(
        jstate, {n: jnp.asarray(v) for n, v in batch.items()},
        jax.random.PRNGKey(3))
    jmix = jax_mixup.Mixup(mode="batch", num_classes=NC)
    draws, zs = [], []
    for key in _micro_keys(jax.random.PRNGKey(3), 0, update_freq):
        draws.append(_jax_mixup_draws(jmix, jax.random.split(key, 3)[0], 1,
                                      32, 32))
        zs.append(_jax_z(params, key))
    state = TrainState.create(
        model, rec, loss_scale=DynamicLossScale.create() if scaled else None)
    step = make_finetune_step(model, rec, cfg, LR, bb_focused=True,
                              device="cpu", second_order=True)
    _, m = step(state, {n: torch.from_numpy(v) for n, v in batch.items()},
                None, draws, probe_z=zs)
    _close_rel(float(m["loss"]), float(jm["loss"]), "loss")
    _compare_recorded(rec, jstate, "finetune")
    if scaled:
        assert float(m["loss_scale"]) == float(jm["loss_scale"]) == 128.0


def test_finetune_adahessian_fp16_step_is_finite():
    """An fp16 BB-MCA adahessian step under the loss scale on the CPU:
    finite loss, gradient norm and parameters, nothing skipped."""
    cfg = FinetuneConfig(input_size=32, num_frames=4, batch_size=B,
                         nb_classes=NC, dtype="float16", drop_path=0.1)
    model = create_model(BB, device="cpu", attn_impl="xla",
                         dtype=torch.float16, drop_path_rate=0.1, **BB_GEO)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                opt="adahessian", lr_schedule=LR)
    state = TrainState.create(model, tx,
                              loss_scale=DynamicLossScale.create())
    step = make_finetune_step(model, tx, cfg, LR, bb_focused=True,
                              device="cpu", second_order=True)
    batch = {n: torch.from_numpy(v) for n, v in _ft_batch().items()}
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    assert float(m["skipped"]) == 0.0 and state.opt_state.count == 1
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert all(torch.isfinite(h).all()
               for h in state.opt_state.nu.values())


# --- the probe and the kernel routes --------------------------------------


def test_hutchinson_exact_on_quadratic():
    """z * Hz is exact on a quadratic with a diagonal H for any z
    (tests/test_optim.py:503)."""
    a = {"w": torch.arange(1.0, 13.0).reshape(3, 4),
         "b": torch.arange(1.0, 5.0)}
    params = {n: torch.ones_like(t, requires_grad=True)
              for n, t in a.items()}

    def grad_fn(p):
        loss = 0.5 * sum((a[n] * p[n] ** 2).sum() for n in p)
        g = torch.autograd.grad(loss, list(p.values()), create_graph=True)
        return dict(zip(p, g))

    for seed in (0, 1, 7):
        hd = optim.hutchinson_diag(grad_fn, params,
                                   generator=torch.Generator().manual_seed(
                                       seed))
        for n in a:
            np.testing.assert_allclose(hd[n].detach().numpy(),
                                       a[n].numpy(), rtol=1e-6)


def _qkv_route():
    qkv = torch.randn(2, 16, 3 * 2 * 64, requires_grad=True)
    return qkv, fa.flash_attention_qkv(qkv, scale=0.125, num_heads=2)


def _mh_route():
    q, k, v = (torch.randn(2, 16, 2 * 64, requires_grad=True)
               for _ in range(3))
    out = fa.flash_attention_mh(q, k, v, scale=0.125, num_heads=2,
                                kv_bias=torch.zeros(2, 16))
    return q, out


def _hm_route():
    q, k, v = (torch.randn(2, 2, 16, 32, requires_grad=True)
               for _ in range(3))
    return q, fa.flash_attention(q, k, v, scale=32 ** -0.5)


@pytest.mark.parametrize("route", [_qkv_route, _mh_route, _hm_route])
def test_kernel_routes_refuse_a_double_backward(route):
    x, out = route()
    w = torch.randn(out.shape[-1], requires_grad=True)
    loss = ((out * w).sum(-1) ** 2).sum()
    g = torch.autograd.grad(loss, [x, w])  # first order runs
    assert all(torch.isfinite(t).all() for t in g)
    x, out = route()
    loss = ((out * w).sum(-1) ** 2).sum()
    with pytest.raises(RuntimeError, match="first-order only"):
        torch.autograd.grad(loss, [x, w], create_graph=True)


def test_second_order_step_on_a_kernel_route_raises():
    """No silent switch: a model left on the kernel routes ("pallas", whose
    CPU run is the kernels' plain backward) refuses the second-order step."""
    cfg = _pt_cfgs(1)[1]
    model = create_model(PRETRAIN, device="cpu", attn_impl="pallas",
                         **PT_GEO)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                opt="adahessian", lr_schedule=LR)
    step = make_pretrain_step(model, tx, cfg, LR, device="cpu",
                              second_order=True)
    batch = {n: torch.from_numpy(v) for n, v in _pt_batch().items()}
    with pytest.raises(RuntimeError, match="first-order only"):
        step(TrainState.create(model, tx), batch,
             torch.Generator().manual_seed(0), 0.5)


# --- data parallel ----------------------------------------------------------


def test_two_gloo_ranks_equal_one_process_with_adahessian(tmp_path):
    """Two ranks (update_freq 2, the probe's z drawn in the step from the
    generator every rank shares) against one process on G': the probe of
    the global mean loss is the ranks' mean probe. Bounds: losses and
    gradient norms within rtol 1e-6, parameters within 1e-6 (as
    tests/test_torch_ddp.py's), at adahessian's eps 1e-3 (the worker's
    ADAHESSIAN_EPS)."""
    world = 2
    Bl, k = W.PRETRAIN_BK[world]
    W.wait(W.spawn("adahessian", world, str(tmp_path)))
    got = [torch.load(tmp_path / f"adahessian-{r}.pt", weights_only=False)
           for r in range(world)]
    want = mp.pretrain_steps(
        W.pretrain_model(attn_impl="xla"), W.pretrain_cfg(world * Bl, k),
        W.pretrain_batch(world * Bl), W.STEPS, opt="adahessian",
        eps=W.ADAHESSIAN_EPS)
    for out in got:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(out[key], want[key], rtol=1e-6,
                                       err_msg=key)
        for n, v in want["params"].items():
            np.testing.assert_allclose(out["params"][n].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)


# --- checkpoints and the CLIs ---------------------------------------------

ZOO = ["adamw", "adam", "sgd", "momentum", "lamb", "adafactor", "rmsprop",
       "adadelta", "lars", "lion", "nadam", "radam", "novograd", "adamax",
       "adagrad", "adabelief", "yogi", "adamp", "sgdp", "adahessian",
       "lookahead_adamp", "lookahead_sgd"]


@pytest.mark.parametrize("opt", ZOO)
def test_each_zoo_state_round_trips(opt, tmp_path):
    """Two updates, a save, a load into a model of another seed: the
    parameters, every buffer (timm's names where it has them) and the
    count come back."""
    def build(seed):
        model = create_model("pretrain_videomae_tiny_debug", device="cpu",
                             seed=seed, decoder_depth=1)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, opt=opt, lr_schedule=LR)
        return model, named, tx, TrainState.create(model, tx)

    model, named, tx, state = build(1)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in named.items()}
        hd = ({n: torch.rand(p.shape, generator=g) for n, p in named.items()}
              if optim.is_second_order(opt) else None)
        tx.update(grads, state.opt_state, named, hessian_diag=hd)
    path = ckpt.save_checkpoint(str(tmp_path), model, state, 0)
    saved = torch.load(path, weights_only=True)["optimizer"]
    keys = set(saved["state"][0]) - {"step"}
    timm = {"adamw": {"exp_avg", "exp_avg_sq"}, "adamp": {"exp_avg",
            "exp_avg_sq"}, "sgd": {"momentum_buffer"},
            "sgdp": {"momentum_buffer"},
            "adahessian": {"exp_avg", "exp_hessian_diag_sq"},
            "lookahead_adamp": {"exp_avg", "exp_avg_sq", "slow_buffer"},
            "adafactor": {"v_row", "v_col", "v"}}
    if opt in timm:
        assert keys == timm[opt]
    if opt.startswith("lookahead_"):
        assert saved["param_groups"][0]["lookahead_step"] == 2
    fresh, _, _, restored = build(9)
    assert ckpt.load_checkpoint(path, fresh, restored) == 0
    assert restored.opt_state.count == 2
    for n, p in fresh.state_dict().items():
        assert torch.equal(p, model.state_dict()[n]), n
    for f, buf in state.opt_state.buffers.items():
        for n, t in buf.items():
            assert torch.equal(restored.opt_state.buffers[f][n], t), (f, n)
    for n, t in (state.opt_state.slow or {}).items():
        assert torch.equal(restored.opt_state.slow[n], t), n
    other = TrainState.create(fresh, optim.create_optimizer(
        dict(fresh.named_parameters()),
        opt="adagrad" if opt != "adagrad" else "adamw", lr_schedule=LR))
    with pytest.raises(ValueError, match="another optimizer"):
        ckpt.load_checkpoint(path, fresh, other)


TINY = ["--model", "pretrain_videomae_tiny_debug", "--decoder_depth", "1",
        "--synthetic", "8", "--batch_size", "2", "--input_size", "32",
        "--num_frames", "4", "--warmup_epochs", "0", "--save_ckpt_freq",
        "1", "--decode_height", "48", "--decode_width", "64", "--dtype",
        "float32", "--device", "cpu", "--mask_type", "tube_bb"]


def test_resumed_lookahead_adamp_run_equals_the_uninterrupted_one(
        tmp_path):
    """8 steps of --opt lookahead_adamp, cut after step 4: the lookahead
    syncs at step 6, after the resume, from the restored slow weights."""
    argv = TINY + ["--epochs", "2", "--opt", "lookahead_adamp"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    PT.main(PT.get_args(argv + ["--output_dir", str(whole)]))
    cut.mkdir()
    shutil.copy(whole / "checkpoint-0.pth", cut)
    state = PT.main(PT.get_args(argv + ["--output_dir", str(cut)]))
    assert state.step == 8 and state.opt_state.count == 8
    a = torch.load(whole / "checkpoint-1.pth", weights_only=True)
    b = torch.load(cut / "checkpoint-1.pth", weights_only=True)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        assert set(s) == {"step", "exp_avg", "exp_avg_sq", "slow_buffer"}
        for key, t in s.items():
            assert torch.equal(t, b["optimizer"]["state"][i][key]), (i, key)
    assert a["optimizer"]["param_groups"][0]["lookahead_step"] == 8
    log_a = [json.loads(x)
             for x in (whole / "log.txt").read_text().splitlines()]
    log_b = [json.loads(x)
             for x in (cut / "log.txt").read_text().splitlines()]
    assert log_b[0]["train_loss"] == log_a[1]["train_loss"]


def test_the_clis_run_adahessian_on_the_plain_route(tmp_path, capsys):
    state = PT.main(PT.get_args(TINY + ["--epochs", "1", "--opt",
                                        "adahessian", "--output_dir",
                                        str(tmp_path / "pt")]))
    assert state.step == 4 and state.opt_state.count == 4
    ft = FT.main(FT.get_args([
        "--model", "vit_tiny_debug_BB_focused", "--synthetic", "4",
        "--batch_size", "2", "--input_size", "32", "--num_frames", "4",
        "--nb_classes", "3", "--epochs", "1", "--warmup_epochs", "0",
        "--decode_height", "48", "--decode_width", "64", "--dtype",
        "float32", "--device", "cpu", "--opt", "adahessian",
        "--output_dir", str(tmp_path / "ft")], bb_defaults=True))
    assert ft.opt_state.count == 2
    out = capsys.readouterr().out
    assert out.count("second-order optimizer: attention routed through "
                     "XLA") == 2
    for run in ("pt", "ft"):
        stats = json.loads((tmp_path / run / "log.txt").read_text()
                           .splitlines()[-1])
        assert np.isfinite(stats["train_loss"])


@pytest.mark.parametrize("cli", [PT, FT])
def test_every_zoo_name_reaches_the_clis_optimizer(cli):
    """build_config takes every one of mofo_tpu's 30 names and the runner's
    create_optimizer call builds it; shampoo fails as mofo_tpu's does."""
    names = ["adamw", "adam", "sgd", "nesterov", "momentum", "lamb",
             "adafactor", "rmsprop", "adadelta", "lars", "lion", "nadam",
             "radam", "novograd", "adamax", "adagrad", "adabelief", "yogi",
             "fusedadam", "fusedadamw", "fusedsgd", "fusedlamb",
             "fusednovograd", "nvnovograd", "fusedmomentum", "adamp",
             "sgdp", "lookahead_adamw", "lookahead_sgd", "adahessian"]
    params = {"w": torch.ones(3, 2), "bias": torch.zeros(3)}
    for name in names + ["shampoo"]:
        cfg = cli.build_config(cli.get_args(["--opt", name]))
        assert cfg.optimizer.opt == name
        if name == "shampoo":
            with pytest.raises(ValueError, match="Unknown optimizer"):
                optim.create_optimizer(params, opt=name,
                                       lr_schedule=np.ones(1))
        else:
            optim.create_optimizer(params, opt=name, lr_schedule=np.ones(1))


def test_version_and_the_wandb_shim(monkeypatch, capsys):
    assert mofo_tpu_torch.__version__ == jax_version == "0.1.0"
    # no project: nothing is imported or started, as mofo_tpu's shim
    for cls in (WandbLogger, jax_wandb.WandbLogger):
        log = cls(project=None, config={"a": 1})
        log.log({"loss": 1.0}, step=0)
        log.finish()
    # a project but no wandb package: a printed notice, then no-ops
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = WandbLogger(project="p", group="g", name="n", config={})
    assert "[wandb] disabled" in capsys.readouterr().out
    log.log({"loss": 1.0}, step=0)
    log.finish()
