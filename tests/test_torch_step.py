"""The port's pretrain step and AdamW against the JAX package.

Three f32 steps of mofo_tpu_torch.train.pretrain_step.make_pretrain_step run
beside mofo_tpu's (jitted, with optim.create_optimizer) from the same
weights and the same masks. The JAX step draws its mask inside the step
(fold_in(rng, step), then split(., 3)[0], pretrain_step.py:76-78, :157);
the test rebuilds it with mofo_tpu.train.pretrain_step.generate_mask and
hands it to the port's step through its `mask` argument.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofo_tpu.core.config import MaskingConfig as JaxMaskingConfig
from mofo_tpu.core.config import PretrainConfig as JaxPretrainConfig
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train import schedules as jax_schedules
from mofo_tpu.train.checkpoint import import_torch_pretrain
from mofo_tpu.train.pretrain_step import generate_mask as jax_generate_mask
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_make_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.checkpoint import params_from_jax
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState, ema_update


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


NAME = "pretrain_videomae_base_patch16_224"
GEO = dict(img_size=32, num_frames=4, encoder_embed_dim=64, encoder_depth=2,
           encoder_num_heads=2, decoder_embed_dim=32, decoder_depth=1,
           decoder_num_heads=2, decoder_num_classes=1536)
B = 4
LOSS_WEIGHT = 0.5


def _cfgs(update_freq):
    kw = dict(input_size=32, num_frames=4, batch_size=B, dtype="float32",
              update_freq=update_freq, motion_loss_weight=True)
    return (
        JaxPretrainConfig(masking=JaxMaskingConfig(mask_type="tube_bb",
                                                   mask_ratio=0.5), **kw),
        PretrainConfig(masking=MaskingConfig(mask_type="tube_bb",
                                             mask_ratio=0.5), **kw),
    )


def _batch():
    rng = np.random.RandomState(0)
    clip = rng.randn(B, 4, 32, 32, 3).astype(np.float32)
    xy1 = rng.uniform(0, 12, (B, 4, 2))
    boxes = np.concatenate([xy1, xy1 + rng.uniform(6, 18, (B, 4, 2))], -1)
    return {"clip": clip, "boxes": boxes.astype(np.float32)}


def _jax_masks(rng, step, batch, cfg):
    """The masks the JAX step draws at `step`, microbatch by microbatch."""
    key = jax.random.fold_in(rng, step)
    k = cfg.update_freq
    keys = [key] if k == 1 else list(jax.random.split(key, k))
    mb = B // k
    masks = []
    for i, mkey in enumerate(keys):
        micro = {n: jnp.asarray(v[i * mb:(i + 1) * mb])
                 for n, v in batch.items()}
        masks.append(np.asarray(
            jax_generate_mask(jax.random.split(mkey, 3)[0], micro, cfg)
        ))
    return np.concatenate(masks)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_three_steps_match_jax(update_freq):
    jcfg, cfg = _cfgs(update_freq)
    batch = _batch()
    lr = jax_schedules.cosine_schedule(1e-3, 1e-5, 2, 4, 1)
    np.testing.assert_array_equal(
        schedules.cosine_schedule(1e-3, 1e-5, 2, 4, 1), lr
    )

    jmodel = jax_create_model(NAME, **GEO)
    n_vis = cfg.num_tokens - cfg.num_masked
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["clip"]),
        jnp.zeros((B, n_vis), jnp.int32),
        jnp.zeros((B, cfg.num_masked), jnp.int32),
    )["params"]
    jtx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                     betas=(0.9, 0.95), weight_decay=0.05)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_make_pretrain_step(jmodel, jtx, jcfg, lr))

    model = create_model(NAME, device="cpu", **GEO)
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params))
    )
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, tx, cfg, lr, device="cpu")
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}

    rng = jax.random.PRNGKey(2)
    jbatch = {n: jnp.asarray(v) for n, v in batch.items()}
    for s in range(3):
        mask = _jax_masks(rng, s, batch, jcfg)
        jstate, jmetrics = jstep(jstate, jbatch, rng, LOSS_WEIGHT)
        state, metrics = step(state, tbatch, None, LOSS_WEIGHT,
                              mask=torch.from_numpy(mask))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        assert float(metrics["lr"]) == float(jmetrics["lr"])
        ours = import_torch_pretrain(model.state_dict())
        for a, b in zip(jax.tree.leaves(ours),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    assert state.step == 3 and state.opt_state.count == 3


def _tree():
    rng = np.random.RandomState(1)
    return {
        "w": rng.randn(4, 3).astype(np.float32),
        "mask_token": rng.randn(1, 1, 3).astype(np.float32),
        "norm_scale": rng.randn(3).astype(np.float32),
    }


@pytest.mark.parametrize("clip_grad,wd_schedule", [
    (None, None), (0.5, np.linspace(0.04, 0.06, 5).astype(np.float32)),
])
def test_adamw_matches_optax_chain(clip_grad, wd_schedule):
    init = _tree()
    lr = np.linspace(1e-2, 1e-3, 5).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jtx = jax_optim.create_optimizer(
        jparams, lr_schedule=lr, wd_schedule=wd_schedule,
        betas=(0.9, 0.95), weight_decay=0.05, clip_grad=clip_grad,
    )
    jopt = jtx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tx = optim.create_optimizer(params, lr_schedule=lr,
                                wd_schedule=wd_schedule, betas=(0.9, 0.95),
                                weight_decay=0.05, clip_grad=clip_grad)
    opt = tx.init(params)
    rng = np.random.RandomState(2)
    for _ in range(6):  # runs past the end of the schedules
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in init.items()}
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.update({k: torch.from_numpy(v) for k, v in g.items()}, opt,
                  params)
        for k in init:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-7,
                                       rtol=1e-6)


def test_decay_mask_matches_jax():
    model = create_model(NAME, device="cpu", **GEO)
    named = dict(model.named_parameters())
    ours = optim.decay_mask(named)
    jtree = import_torch_pretrain(
        {n: p.detach() for n, p in named.items()}
    )
    jmask = jax_optim.decay_mask(jtree)
    # carry the JAX mask to torch names as arrays of 1.0 (decay) / 0.0
    back = params_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, float(m), np.float32), jmask, jtree
    ))
    assert set(back) == set(ours)
    for name, decays in ours.items():
        assert decays == bool(back[name].flatten()[0]), name
    assert not ours["mask_token"] and ours["encoder.blocks.0.attn.qkv.weight"]


def test_global_norm_and_ema_update():
    tensors = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    assert float(optim.global_norm(tensors)) == 5.0
    ema = {"a": torch.ones(2)}
    ema_update(ema, {"a": torch.zeros(2)}, 0.75)
    assert torch.equal(ema["a"], torch.full((2,), 0.75))


def test_step_draws_its_own_masks_and_moves_every_parameter():
    _, cfg = _cfgs(1)
    cfg = dataclasses.replace(cfg, motion_loss_weight=False,
                              masking=MaskingConfig(mask_type="tube",
                                                    mask_ratio=0.5))
    model = create_model(NAME, device="cpu", **GEO)
    lr = np.full(4, 1e-3, np.float32)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    tx = optim.create_optimizer(named, lr_schedule=lr)
    state = TrainState.create(model, tx, use_ema=True)
    step = make_pretrain_step(model, tx, cfg, lr, device="cpu")
    batch = {"clip": torch.from_numpy(_batch()["clip"])}
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, metrics = step(state, batch, g, 0.0)
        assert torch.isfinite(metrics["loss"])
    for n, p in named.items():
        assert not torch.equal(p.detach(), before[n]), n
    assert not torch.equal(state.ema_params["mask_token"],
                           named["mask_token"].detach())
