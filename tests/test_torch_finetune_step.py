"""The port's finetune path against the JAX package: losses, Mixup, layer
decay, the BB-focused MCA train step and the eval step; and the port's
drop path, which draws from an explicit generator.

The step runs 3 f32 steps beside mofo_tpu.train.finetune_step's (jitted,
attn_impl="pallas": interpret-mode K1/K2 in the Blocks and K3 in the MCA
block) from the same weights, with drop path at 0 (JAX and torch draw
different bits). With mixup on, the test rebuilds the JAX step's draws
(fold_in(rng, step), split(., 3)[0], then split into the parameter and box
keys, finetune_step.py:88-91 and mixup.py:155-169) with the JAX package's
own helpers and hands them to the port through `mixup_params`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import mixup as jax_mixup
from mofo_tpu.train import losses as jax_losses
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train.finetune_step import make_eval_step as jax_eval_step
from mofo_tpu.train.finetune_step import (
    make_finetune_step as jax_finetune_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.core.config import FinetuneConfig
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.models.layers import DropPath, drop_path
from mofo_tpu_torch.ops.mixup import Mixup, MixupParams, one_hot_smooth
from mofo_tpu_torch.train import losses, optim
from mofo_tpu_torch.train.checkpoint import params_from_jax
from mofo_tpu_torch.train.finetune_step import (
    make_eval_step,
    make_finetune_step,
)
from mofo_tpu_torch.train.train_state import TrainState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


BB = "vit_base_patch16_224_BB_focused"
NC = 7
GEO = dict(img_size=32, all_frames=4, embed_dim=128, depth=2, num_heads=2,
           num_classes=NC, init_scale=1.0, fusing_method="MCA",
           mca_num_heads=2)
B = 4


def _logits_targets(seed=0):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(6, NC)).astype(np.float32)
    labels = rng.randint(0, NC, 6)
    return logits, labels


@pytest.mark.parametrize("name", ["soft_target_cross_entropy",
                                  "label_smoothing_cross_entropy",
                                  "cross_entropy",
                                  "cross_entropy_per_sample", "accuracy",
                                  "topk_hits"])
def test_losses_match_jax(name):
    logits, labels = _logits_targets()
    if name == "soft_target_cross_entropy":
        soft = np.asarray(jax_mixup.one_hot_smooth(jnp.asarray(labels), NC,
                                                   0.1))
        np.testing.assert_allclose(
            one_hot_smooth(torch.from_numpy(labels), NC, 0.1).numpy(), soft,
            atol=1e-7)
        args = (logits, soft)
    else:
        args = (logits, labels)
    kw = {"topk": (1, 3)} if name in ("accuracy", "topk_hits") else {}
    ours = getattr(losses, name)(*map(torch.from_numpy, args), **kw)
    ref = getattr(jax_losses, name)(*map(jnp.asarray, args), **kw)
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def _jax_draws(jm, key, count, H, W):
    """The raw draws JAX's Mixup.__call__ makes from `key`."""
    r_params, r_box = jax.random.split(key)
    lam, use_cutmix = jm._sample_params(r_params, count)
    if jm.cutmix_minmax is not None:
        box = jax_mixup._rand_bbox_minmax(r_box, H, W, jm.cutmix_minmax,
                                          count)
    else:
        box = jax_mixup._rand_bbox(r_box, H, W, lam, count)
    return MixupParams(np.asarray(lam), np.asarray(use_cutmix),
                       tuple(np.asarray(c) for c in box))


@pytest.mark.parametrize("mode,kw", [
    ("batch", {}), ("elem", {}), ("pair", {}),
    ("elem", {"cutmix_minmax": (0.3, 0.8)}),
    ("elem", {"correct_lam": False, "prob": 0.6}),
])
def test_mixup_matches_jax_with_injected_draws(mode, kw):
    jm = jax_mixup.Mixup(mode=mode, num_classes=NC, **kw)
    pm = Mixup(mode=mode, num_classes=NC, **kw)
    clips = np.random.RandomState(1).randn(6, 2, 16, 16, 3).astype(
        np.float32)
    labels = np.arange(6) % NC
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_mixed, j_soft = jm(key, jnp.asarray(clips), jnp.asarray(labels))
        draws = _jax_draws(jm, key, pm.count(6), 16, 16)
        mixed, soft = pm(torch.from_numpy(clips), torch.from_numpy(labels),
                         params=draws)
        np.testing.assert_array_equal(mixed.numpy(), np.asarray(j_mixed))
        np.testing.assert_allclose(soft.numpy(), np.asarray(j_soft),
                                   atol=1e-7)


def test_mixup_draws_from_its_generator():
    pm = Mixup(mode="elem", num_classes=NC)
    clips = torch.randn(4, 2, 16, 16, 3)
    labels = torch.arange(4)
    a = pm(clips, labels, np.random.default_rng(5))
    b = pm(clips, labels, np.random.default_rng(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], clips)
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="np.random.Generator"):
        pm(clips, labels)


def _jax_pair(geo=GEO):
    jmodel = jax_create_model(BB, attn_impl="pallas", **geo)
    clip, boxes = _batch()["clip"], _batch()["boxes"]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clip),
                         jnp.asarray(boxes))["params"]
    port = create_model(BB, device="cpu", **geo)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, port


def test_layer_decay_scales_match_jax():
    _, params, port = _jax_pair()
    named = dict(port.named_parameters())
    assert optim.infer_depth(named) == jax_optim.infer_depth(params) == 2
    ours = optim.layer_decay_scales(named, 2, 0.75)
    jscales = jax_optim.layer_decay_scales(params, 2, 0.75)
    back = params_from_jax(jax.tree.map(
        lambda s, p: np.full(np.shape(p), s, np.float32), jscales, params))
    assert set(back) == set(ours)
    for name, scale in ours.items():
        assert np.float32(scale) == back[name].flatten()[0], name
    assert ours["backbone.patch_embed.proj.weight"] == 0.75 ** 3
    assert ours["backbone.blocks.1.attn.qkv.weight"] == 0.75
    assert ours["local_MCA.0.attn.q.weight"] == ours["head.bias"] == 1.0


def _batch():
    rng = np.random.RandomState(0)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[0] = [3.0, 5.0, 14.0, 12.0]
    boxes[1] = [100.0, 100.0, 120.0, 120.0]  # no in-box token
    boxes[2] = [0.0, 0.0, 32.0, 32.0]  # no out-box token
    boxes[3] = [10.0, 2.0, 30.0, 20.0]
    return {"clip": rng.randn(B, 4, 32, 32, 3).astype(np.float32),
            "label": np.array([1, 5, 0, 3], np.int32), "boxes": boxes}


def _cfgs(**kw):
    kw = dict(input_size=32, num_frames=4, batch_size=B, nb_classes=NC,
              dtype="float32", drop_path=0.0, **kw)
    return JaxFinetuneConfig(**kw), FinetuneConfig(**kw)


@pytest.mark.parametrize("mixup,update_freq", [(False, 1), (True, 1),
                                               (False, 2)])
def test_three_bb_mca_steps_match_jax(mixup, update_freq):
    extra = {} if mixup else {"mixup": 0.0, "cutmix": 0.0}
    jcfg, cfg = _cfgs(update_freq=update_freq, **extra)
    jmodel, params, model = _jax_pair()
    # AdamW's first update is g / (|g| + eps): where |g| is near eps (some
    # gradients here are 5e-9 with 3e-9 of f32 summation noise) it turns
    # that noise into up to 0.3 lr. eps = 1e-6 bounds it by
    # 3e-9 / eps * lr = 1.5e-7; a skipped update (lr) or a wrong layer-decay
    # scale (>= lr / 4) stays 10x beyond atol 1e-6.
    lr = np.array([5e-5, 4e-5, 3e-5, 2e-5], np.float32)
    kw = dict(lr_schedule=lr, betas=(0.9, 0.999), weight_decay=0.05,
              layer_decay=0.75, eps=1e-6)
    jtx = jax_optim.create_optimizer(params, **kw)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_finetune_step(jmodel, jtx, jcfg, lr,
                                      bb_focused=True))
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, **kw)
    state = TrainState.create(model, tx)
    step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                              device="cpu")
    batch = _batch()
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    jbatch = {n: jnp.asarray(v) for n, v in batch.items()}
    jm = jax_mixup.Mixup(mode="batch", num_classes=NC)
    rng = jax.random.PRNGKey(3)
    for s in range(3):
        draws = None
        if mixup:
            mix_key = jax.random.split(jax.random.fold_in(rng, s), 3)[0]
            draws = _jax_draws(jm, mix_key, 1, 32, 32)
        jstate, jm_ = jstep(jstate, jbatch, rng)
        state, m = step(state, tbatch, None, draws)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        assert float(m["lr"]) == float(jm_["lr"])
        ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
    assert state.step == 3


def test_eval_step_matches_jax():
    jcfg, cfg = _cfgs()
    jmodel, params, model = _jax_pair()
    batch = dict(_batch(), valid=np.array([1, 1, 0, 1], bool))
    ref = jax.jit(jax_eval_step(jmodel, jcfg, bb_focused=True))(
        params, {n: jnp.asarray(v) for n, v in batch.items()})
    ours = make_eval_step(model, cfg, bb_focused=True, device="cpu")(
        {n: torch.from_numpy(v) for n, v in batch.items()})
    for key in ("loss", "acc1", "acc5", "n_valid"):
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(ours["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=1e-4)
    assert float(ours["n_valid"]) == 3.0


def test_step_moves_parameters_and_refuses_what_is_not_ported():
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, drop_path=0.3)
    model = create_model(BB, device="cpu", drop_path_rate=0.3, **GEO)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    tx = optim.create_optimizer(named, lr_schedule=np.full(2, 1e-3,
                                                           np.float32))
    state = TrainState.create(model, tx, use_ema=True)
    step = make_finetune_step(model, tx, cfg, bb_focused=True, device="cpu")
    tbatch = {n: torch.from_numpy(v) for n, v in _batch().items()}
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        step(state, tbatch, None)
    state, m = step(state, tbatch, torch.Generator().manual_seed(0))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    for n in ("backbone.blocks.0.attn.qkv.weight",
              "local_MCA.0.attn.q.weight", "head.weight"):
        assert not torch.equal(named[n].detach(), before[n]), n
    # in-step augmentation, fp16 (test_torch_finetune_cli.py,
    # test_torch_finetune_augment.py) and adahessian's second-order step
    # (test_torch_second_order.py) are ported; a second-order step refuses a
    # model on the kernel routes instead of switching routes
    so_step = make_finetune_step(model, tx, cfg, bb_focused=True,
                                 device="cpu", second_order=True)
    with pytest.raises(RuntimeError, match="first-order only"):
        so_step(state, tbatch, torch.Generator().manual_seed(0))
    make_finetune_step(model, tx, dataclasses.replace(cfg, dtype="float16"),
                       device="cpu", augment_fn=lambda g, b: b)


def test_drop_path_same_generator_seed_same_mask():
    x = torch.ones(64, 3, 5)
    outs = [drop_path(x, 0.5, True, torch.Generator().manual_seed(11))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    other = drop_path(x, 0.5, True, torch.Generator().manual_seed(12))
    assert not torch.equal(outs[0], other)
    module = DropPath(0.5)
    module.eval()
    assert module(x) is x  # no draw, no generator needed
    assert drop_path(x, 0.0, True) is x


def test_drop_path_keep_share_and_scaling():
    """At rate 0.5 over many samples, the keep share is 0.5 and kept
    samples are scaled by 1/keep (JAX's bernoulli draws other bits, so
    this compares statistics with mofo_tpu's drop_path)."""
    from mofo_tpu.models.layers import drop_path as jax_drop_path

    n = 20000
    x = torch.full((n, 2), 3.0)
    out = drop_path(x, 0.5, True, torch.Generator().manual_seed(0))
    jout = np.asarray(jax_drop_path(jnp.full((n, 2), 3.0), 0.5, False,
                                    jax.random.PRNGKey(0)))
    for o in (out.numpy(), jout):
        kept = o[:, 0] != 0
        assert set(np.unique(o)) == {0.0, 6.0}
        assert np.all(o[:, 0] == o[:, 1])  # one draw per sample
        assert abs(kept.mean() - 0.5) < 0.02  # 5.7 sigma at n = 20000
    assert abs((out.numpy()[:, 0] != 0).mean() - (jout[:, 0] != 0).mean()) \
        < 0.03
