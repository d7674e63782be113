"""The port's finetune augmentation against the JAX package: each of the 15
RandAugment ops, rotate_box, RandAugment of whole clips with boxes, the
image ops (random resized crop, centre and three-crop windows, short-side
scale, flip, erasing) and the three pipelines (finetune_augment,
eval_augment, test_view_augment).

The port draws from torch generators, the JAX package from keys, so each
test rebuilds the JAX functions' own draws (the same jax.random.split and
samplers as mofo_tpu/ops/{rand_augment,image,augment}.py) and injects them
into the port. Tolerances, on clips on [0, 255] (RandAugment) or
normalized (pipelines): pointwise ops within 1e-3 absolute; equalize and
posterize exactly; the geometric ops at least 99.9% of pixels within 1e-3,
because a pixel whose source coordinate lies within f32 rounding of an
integer may sample across it (on these inputs every pixel agrees).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops import augment as jax_augment
from mofo_tpu.ops import image as jax_image
from mofo_tpu.ops import rand_augment as jax_ra
from mofo_tpu_torch.ops import augment, image
from mofo_tpu_torch.ops import rand_augment as ra


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


AA = "rand-m7-n4-mstd0.5-inc1"
HW = (40, 48)
OUT = 32
GEOMETRIC_SHARE = 0.999


def _clips(B=3, T=2, hw=HW, seed=0):
    rng = np.random.RandomState(seed)
    clips = rng.randint(0, 256, (B, T) + hw + (3,)).astype(np.uint8)
    clips[1] //= 4  # a low-contrast clip: equalize and autocontrast stretch
    return clips


def _boxes(B=3, T=2, hw=HW, seed=1):
    rng = np.random.RandomState(seed)
    H, W = hw
    xy = rng.uniform(0, W / 2, (B, T, 2))
    wh = rng.uniform(4, W / 2, (B, T, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _within(got, want, atol):
    return float(np.mean(np.abs(got - want) <= atol))


def _jax_rand_augment_draws(key, B, config_str):
    """The per-clip, per-layer draws of mofo_tpu's rand_augment_batch
    (rand_augment.py:407-428 under split(key, B))."""
    cfg = jax_ra.parse_rand_augment_config(config_str)
    out = {k: [] for k in ("op", "apply", "magnitude", "neg", "interp")}
    for rng in jax.random.split(key, B):
        row = {k: [] for k in out}
        for _ in range(cfg["num_layers"]):
            rng, r_op, r_apply, r_mag, r_neg, r_interp = jax.random.split(
                rng, 6)
            row["op"].append(int(jax.random.randint(r_op, (), 0, 15)))
            row["apply"].append(bool(jax.random.bernoulli(r_apply,
                                                          cfg["prob"])))
            mag = cfg["magnitude"] + cfg["magnitude_std"] * jax.random.normal(
                r_mag)
            row["magnitude"].append(np.float32(jnp.clip(mag, 0.0, 10.0)))
            row["neg"].append(np.float32(jnp.where(
                jax.random.bernoulli(r_neg, 0.5), -1.0, 1.0)))
            row["interp"].append(int(jax.random.randint(r_interp, (), 0, 2)))
        for k in out:
            out[k].append(row[k])
    return ra.RandAugmentDraws(
        torch.tensor(out["op"]), torch.tensor(out["apply"]),
        torch.tensor(np.array(out["magnitude"], np.float32)),
        torch.tensor(np.array(out["neg"], np.float32)),
        torch.tensor(out["interp"]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_crop_draws(key, B):
    """random_resized_crop_boxes' draws (image.py:127-148)."""
    r_area, r_ratio, r_i, r_j = jax.random.split(key, 4)
    return image.CropDraws(
        _t(jax.random.uniform(r_area, (B, 10), minval=0.08, maxval=1.0)),
        _t(jax.random.uniform(r_ratio, (B, 10), minval=np.log(3 / 4),
                              maxval=np.log(4 / 3))),
        _t(jax.random.uniform(r_i, (B,))), _t(jax.random.uniform(r_j, (B,))))


def _jax_erasing_draws(key, shape, prob=0.25):
    """random_erasing's draws (image.py:309-338, pixel mode, cube)."""
    B, _, H, W, C = shape
    r_apply, r_area, r_ratio, r_y, r_x, r_fill = jax.random.split(key, 6)
    return image.ErasingDraws(
        _t(jax.random.bernoulli(r_apply, prob, (B,))),
        _t(jax.random.uniform(r_area, (B,), minval=0.02, maxval=1 / 3)),
        _t(jax.random.uniform(r_ratio, (B,), minval=np.log(0.3),
                              maxval=np.log(10 / 3))),
        _t(jax.random.uniform(r_y, (B,))), _t(jax.random.uniform(r_x, (B,))),
        _t(jax.random.normal(r_fill, (B, 1, H, W, C), jnp.float32)))


def _jax_finetune_draws(key, shape, aa=AA, flip=True, reprob=0.25,
                        out=OUT):
    """finetune_augment's draws (augment.py:97): split(key, 4) into the
    RandAugment, crop, flip and erasing keys."""
    r_aa, r_crop, r_flip, r_erase = jax.random.split(key, 4)
    B, T, _, _, C = shape
    return augment.FinetuneDraws(
        _jax_rand_augment_draws(r_aa, B, aa) if aa else None,
        _jax_crop_draws(r_crop, B),
        _t(jax.random.bernoulli(r_flip, 0.5, (B,))) if flip else None,
        (_jax_erasing_draws(r_erase, (B, T, out, out, C), reprob)
         if reprob > 0 else None))


OP_CASES = [(i, interp) for i in range(len(ra.TRANSFORMS))
            for interp in ((0, 1) if i in ra.GEOMETRIC else (0,))]


@pytest.mark.parametrize(
    "op,interp", OP_CASES,
    ids=[f"{ra.TRANSFORMS[i]}-{'bicubic' if b else 'bilinear'}"
         for i, b in OP_CASES])
def test_rand_augment_op_matches_jax(op, interp):
    assert ra.TRANSFORMS == jax_ra.TRANSFORMS
    clips = _clips().astype(np.float32)
    levels = np.array([7.3, 3.1, 10.0], np.float32)
    negs = np.array([1.0, -1.0, 1.0], np.float32)
    want = np.stack([np.asarray(jax_ra._OPS[op](
        jnp.asarray(c), jnp.float32(lv), jnp.float32(ng), interp))
        for c, lv, ng in zip(clips, levels, negs)])
    got = ra.OPS[op](torch.from_numpy(clips), torch.from_numpy(levels),
                     torch.from_numpy(negs), bool(interp)).numpy()
    name = ra.TRANSFORMS[op]
    if op in ra.GEOMETRIC:
        assert _within(got, want, 1e-3) >= GEOMETRIC_SHARE, name
    elif name in ("Equalize", "PosterizeIncreasing"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert not np.array_equal(got, clips) or name == "Equalize"


def test_parse_config_and_rotate_box_match_jax():
    for s in (AA, "rand-m9-n2", "rand-m5-n3-mstd1.0-inc0-p0.7"):
        assert ra.parse_rand_augment_config(s) == \
            jax_ra.parse_rand_augment_config(s)
    boxes = _boxes()
    levels = np.array([7.3, 0.0, 10.0], np.float32)
    negs = np.array([1.0, -1.0, -1.0], np.float32)
    want = np.stack([np.asarray(jax_ra.rotate_box(
        jnp.asarray(b), jnp.float32(lv), jnp.float32(ng), HW))
        for b, lv, ng in zip(boxes, levels, negs)])
    got = ra.rotate_box(torch.from_numpy(boxes), torch.from_numpy(levels),
                        torch.from_numpy(negs), HW).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_boxes", [True, False])
def test_rand_augment_batch_matches_jax(with_boxes):
    """Four layers per clip drawn by the JAX key, every op group applied
    once per layer; boxes rotate only with Rotate."""
    B = 6
    clips = _clips(B=B).astype(np.float32)
    boxes = _boxes(B=B)
    key = jax.random.PRNGKey(11)  # rotates one clip, both interpolations
    draws = _jax_rand_augment_draws(key, B, AA)
    kw = {"boxes": jnp.asarray(boxes)} if with_boxes else {}
    want = jax_ra.rand_augment_batch(key, jnp.asarray(clips), AA, **kw)
    got = ra.rand_augment_batch(
        None, torch.from_numpy(clips), AA,
        boxes=torch.from_numpy(boxes) if with_boxes else None, draws=draws)
    if with_boxes:
        (want, want_boxes), (got, got_boxes) = want, got
        np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes),
                                   atol=1e-3, rtol=0)
        turned = (draws.apply & (draws.op == ra.ROTATE)).any(dim=1)
        assert turned.any() and not turned.all()
        np.testing.assert_array_equal(got_boxes.numpy()[~turned.numpy()],
                                      boxes[~turned.numpy()])
    assert _within(got.numpy(), np.asarray(want), 1e-3) >= GEOMETRIC_SHARE
    assert draws.apply.any()


def test_rand_augment_draws_come_from_the_generator():
    clips = torch.from_numpy(_clips(B=4).astype(np.float32))
    a = ra.rand_augment_batch(torch.Generator().manual_seed(3), clips)
    b = ra.rand_augment_batch(torch.Generator().manual_seed(3), clips)
    assert torch.equal(a, b) and not torch.equal(a, clips)
    d = ra.sample_rand_augment_draws(torch.Generator().manual_seed(0), 4000,
                                     AA)
    assert d.op.shape == (4000, 4) and set(d.op.unique().tolist()) == set(
        range(15))
    assert abs(d.apply.float().mean().item() - 0.5) < 0.01
    assert 0.0 <= d.magnitude.min() and d.magnitude.max() <= 10.0
    assert set(d.neg.unique().tolist()) == {-1.0, 1.0}


@pytest.mark.parametrize("hw,scale", [
    (HW, (0.08, 1.0)), ((20, 80), (0.9, 1.0)), ((80, 20), (0.9, 1.0)),
    ((40, 40), (1.0, 1.0))])
def test_random_resized_crop_boxes_match_jax(hw, scale):
    """Ten tries, first fit, and torchvision's central fallback (the last
    three geometries fail every try)."""
    key = jax.random.PRNGKey(5)
    B = 64
    want = np.asarray(jax_image.random_resized_crop_boxes(key, B, hw, scale))
    r_area, r_ratio, r_i, r_j = jax.random.split(key, 4)
    draws = image.CropDraws(
        _t(jax.random.uniform(r_area, (B, 10), minval=scale[0],
                              maxval=scale[1])),
        _t(jax.random.uniform(r_ratio, (B, 10), minval=np.log(3 / 4),
                              maxval=np.log(4 / 3))),
        _t(jax.random.uniform(r_i, (B,))), _t(jax.random.uniform(r_j, (B,))))
    got = image.random_resized_crop_boxes(None, B, hw, scale,
                                          draws=draws).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_fixed_windows_match_jax():
    for B, hw, crop in ((3, (256, 298), (224, 224)), (2, (40, 48), (32, 32))):
        np.testing.assert_array_equal(
            image.center_crop_boxes(B, hw, crop).numpy(),
            np.asarray(jax_image.center_crop_boxes(B, hw, crop)))
    for hw in ((224, 280), (300, 224), (224, 224)):
        for split in range(3):
            assert image.three_crop_boxes(hw, 224, split) == \
                jax_image.three_crop_boxes(hw, 224, split)
        assert image.three_crop_boxes(hw, 224, 1, num_crops=1) == \
            jax_image.three_crop_boxes(hw, 224, 1, num_crops=1)
    for h, w in ((256, 320), (320, 256), (240, 240), (37, 91)):
        assert image.short_side_scale_size(h, w, 224) == \
            jax_image.short_side_scale_size(h, w, 224)


def test_flip_and_erasing_match_jax():
    x = np.random.RandomState(2).randn(8, 2, 16, 20, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax_image.horizontal_flip(key, jnp.asarray(x)))
    flip = _t(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < flip.sum() < 8
    got = image.horizontal_flip(None, torch.from_numpy(x), flip=flip)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax_image.random_erasing(key, jnp.asarray(x), prob=0.6))
    draws = _jax_erasing_draws(key, x.shape, prob=0.6)
    assert 0 < draws.apply.sum() < 8
    got = image.random_erasing(None, torch.from_numpy(x), prob=0.6,
                               draws=draws).numpy()
    np.testing.assert_array_equal(got, want)
    erased = (got != x).any(axis=(1, 4))  # (B, H, W): one box per clip
    assert np.array_equal(erased.any(axis=(1, 2)), draws.apply.numpy())
    assert (got == x).all(axis=1).any()  # the same box in every frame


@pytest.mark.parametrize("with_boxes,flip,reprob", [(True, True, 0.25),
                                                    (False, False, 0.0),
                                                    (True, False, 1.0)])
def test_finetune_augment_matches_jax(with_boxes, flip, reprob):
    B = 4
    clips, boxes = _clips(B=B), _boxes(B=B)
    key = jax.random.PRNGKey(7)
    kw = dict(out_size=OUT, aa=AA, flip=flip, reprob=reprob)
    want, want_boxes = jax_augment.finetune_augment(
        key, jnp.asarray(clips),
        boxes=jnp.asarray(boxes) if with_boxes else None, **kw)
    draws = _jax_finetune_draws(key, clips.shape, flip=flip, reprob=reprob)
    got, got_boxes = augment.finetune_augment(
        None, torch.from_numpy(clips),
        boxes=torch.from_numpy(boxes) if with_boxes else None, draws=draws,
        **kw)
    assert got.shape == (B, 2, OUT, OUT, 3) and got.dtype == torch.float32
    assert _within(got.numpy(), np.asarray(want), 1e-3) >= GEOMETRIC_SHARE
    if with_boxes:
        np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes),
                                   atol=1e-3, rtol=0)
    else:
        assert got_boxes is None and want_boxes is None


def test_finetune_augment_draws_come_from_the_generator():
    clips = torch.from_numpy(_clips(B=2))
    runs = [augment.finetune_augment(torch.Generator().manual_seed(9), clips,
                                     out_size=OUT)[0] for _ in range(2)]
    assert torch.equal(*runs)
    other = augment.finetune_augment(torch.Generator().manual_seed(10), clips,
                                     out_size=OUT)[0]
    assert not torch.equal(runs[0], other)


@pytest.mark.parametrize("hw", [(40, 48), (48, 40)])
def test_eval_augment_matches_jax(hw):
    clips, boxes = _clips(hw=hw), _boxes(hw=hw)
    want, want_boxes = jax_augment.eval_augment(
        jnp.asarray(clips), out_size=OUT, short_side=OUT,
        boxes=jnp.asarray(boxes))
    got, got_boxes = augment.eval_augment(
        torch.from_numpy(clips), out_size=OUT, short_side=OUT,
        boxes=torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("split", [0, 1, 2])
@pytest.mark.parametrize("hw", [(40, 48), (48, 40)])
def test_test_view_augment_matches_jax(split, hw):
    clips, boxes = _clips(hw=hw), _boxes(hw=hw)
    want, want_boxes = jax_augment.test_view_augment(
        jnp.asarray(clips), split, out_size=OUT, short_side=OUT,
        boxes=jnp.asarray(boxes))
    got, got_boxes = augment.test_view_augment(
        torch.from_numpy(clips), split, out_size=OUT, short_side=OUT,
        boxes=torch.from_numpy(boxes))
    assert got.shape == (3, 2, OUT, OUT, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes),
                               atol=1e-5, rtol=0)


def test_three_bb_mca_steps_with_augment_fn_match_jax():
    """uint8 clips and boxes enter both BB-focused MCA steps, which augment
    them inside the step (RandAugment, crop, flip, erasing), mix them and
    train (AdamW with layer decay): the JAX step with its folded key's
    draws, the port with the same draws injected. The bounds of
    test_torch_finetune_step.py: loss rel 1e-5, gradient norm rel 1e-4,
    parameters 1e-6."""
    from mofo_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
    from mofo_tpu.models import create_model as jax_create_model
    from mofo_tpu.ops import mixup as jax_mixup
    from mofo_tpu.train import optim as jax_optim
    from mofo_tpu.train.finetune_step import (
        make_finetune_step as jax_finetune_step,
    )
    from mofo_tpu.train.train_state import TrainState as JaxTrainState
    from mofo_tpu_torch.core.config import FinetuneConfig
    from mofo_tpu_torch.models import create_model
    from mofo_tpu_torch.ops.mixup import MixupParams
    from mofo_tpu_torch.train import optim
    from mofo_tpu_torch.train.checkpoint import params_from_jax
    from mofo_tpu_torch.train.finetune_step import make_finetune_step
    from mofo_tpu_torch.train.train_state import TrainState

    bb, B, nc = "vit_base_patch16_224_BB_focused", 4, 7
    geo = dict(img_size=OUT, all_frames=4, embed_dim=128, depth=2,
               num_heads=2, num_classes=nc, init_scale=1.0,
               fusing_method="MCA", mca_num_heads=2)
    kw = dict(input_size=OUT, num_frames=4, batch_size=B, nb_classes=nc,
              dtype="float32", drop_path=0.0)
    jcfg, cfg = JaxFinetuneConfig(**kw), FinetuneConfig(**kw)
    clips, boxes = _clips(B=B, T=4), _boxes(B=B, T=4)
    labels = np.array([1, 5, 0, 3], np.int32)

    jmodel = jax_create_model(bb, attn_impl="pallas", **geo)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 4, OUT, OUT, 3)),
                         jnp.zeros((1, 4, 4)))["params"]
    model = create_model(bb, device="cpu", **geo)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    lr = np.array([5e-5, 4e-5, 3e-5, 2e-5], np.float32)
    okw = dict(lr_schedule=lr, betas=(0.9, 0.999), weight_decay=0.05,
               layer_decay=0.75, eps=1e-6)  # eps: test_torch_finetune_step

    def jax_aug(key, b):
        x, bx = jax_augment.finetune_augment(key, b["clip"], OUT, AA,
                                             boxes=b["boxes"])
        return {"clip": x, "label": b["label"], "boxes": bx}

    draws = {}

    def port_aug(generator, b):
        x, bx = augment.finetune_augment(generator, b["clip"], OUT, AA,
                                         boxes=b["boxes"], draws=draws["aug"])
        return {"clip": x, "label": b["label"], "boxes": bx}

    jtx = jax_optim.create_optimizer(params, **okw)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_finetune_step(jmodel, jtx, jcfg, lr, bb_focused=True,
                                      augment_fn=jax_aug))
    tx = optim.create_optimizer(dict(model.named_parameters()), **okw)
    state = TrainState.create(model, tx)
    step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                              augment_fn=port_aug, device="cpu")
    jm = jax_mixup.Mixup(mode="batch", num_classes=nc)
    batch = {"clip": clips, "boxes": boxes, "label": labels}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(3)
    for s in range(3):
        # finetune_step.py:103-106, then micro_loss's split (:88)
        aug_key, rest = jax.random.split(jax.random.fold_in(rng, s))
        draws["aug"] = _jax_finetune_draws(aug_key, clips.shape)
        r_params, r_box = jax.random.split(jax.random.split(rest, 3)[0])
        lam, use_cutmix = jm._sample_params(r_params, 1)
        box = jax_mixup._rand_bbox(r_box, OUT, OUT, lam, 1)
        mix = MixupParams(np.asarray(lam), np.asarray(use_cutmix),
                          tuple(np.asarray(c) for c in box))
        jstate, jmetrics = jstep(jstate, jbatch, rng)
        state, metrics = step(state, tbatch, None, mix)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
    assert state.step == 3


def test_forced_draws_apply_every_op_in_both_interpolations():
    """main_path.forced_draws, which chip_smoke.py and the GPU tests hold
    the card against the CPU with: every op applied, each geometric op in
    both interpolations, at any output size; too few clips raise."""
    from mofo_tpu_torch.tools.main_path import forced_draws, synthetic_clips_u8

    draws = forced_draws(8, HW, out_size=OUT)
    d = draws.rand_augment
    assert d.apply.all() and set(d.op.flatten().tolist()) == set(range(15))
    for op in ra.GEOMETRIC:
        assert set(d.interp[d.op == op].tolist()) == {0, 1}
    batch = synthetic_clips_u8(8, torch.Generator().manual_seed(1), "cpu",
                               hw=HW)
    x, boxes = augment.finetune_augment(None, batch["clip"], OUT,
                                        boxes=batch["boxes"], draws=draws)
    assert x.shape == (8, 16, OUT, OUT, 3) and boxes.shape == (8, 16, 4)
    assert torch.isfinite(x).all()
    with pytest.raises(ValueError, match="too few"):
        forced_draws(7, HW, out_size=OUT)
