"""The port's pretrain augmentation and host data path against the JAX
package.

ops.image / ops.augment are held against mofo_tpu.ops.image /
mofo_tpu.ops.augment on the same inputs; the crop draws come from a
torch.Generator in the port and from a JAX key in the reference, so the
tests rebuild the JAX draws (multi_scale_crop_boxes: split the key, randint
the pair and the offset) and hand them to the port. The sampler and the
synthetic dataset must equal the JAX ones; the prefetching loader is
checked for drop_last, the valid mask and error propagation. Last, three
pretrain steps that augment uint8 clips inside the step (augment_fn) run
beside the JAX step with the same draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.core.config import MaskingConfig as JaxMaskingConfig
from mofo_tpu.core.config import PretrainConfig as JaxPretrainConfig
from mofo_tpu.data import pipeline as jax_pipeline
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import augment as jax_augment
from mofo_tpu.ops import image as jax_image
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train.pretrain_step import generate_mask as jax_generate_mask
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_make_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.data import pipeline
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment, image
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.checkpoint import params_from_jax
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
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



def _jax_draws(key, batch, hw, out_size):
    """The (pair_idx, off_idx) that mofo_tpu.ops.image.multi_scale_crop_boxes
    draws from `key` (image.py:220-226)."""
    n_pairs = len(jax_image._msc_size_pairs(min(hw), out_size))
    r_pair, r_off = jax.random.split(key)
    return (torch.from_numpy(np.array(
                jax.random.randint(r_pair, (batch,), 0, n_pairs))),
            torch.from_numpy(np.array(
                jax.random.randint(r_off, (batch,), 0, 13))))


def _boxes(rng, B, T, H, W):
    xy = rng.uniform(-10, max(H, W), (B, T, 2))
    wh = rng.uniform(-5, 60, (B, T, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("out_size", [(16, 16), (24, 10)])
def test_crop_and_resize_matches_jax(out_size):
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 2, 20, 24, 3).astype(np.float32)
    # inside, partly outside (clamped to the edge) and upscaling boxes
    boxes = np.array([[2.0, 3.0, 18.0, 20.0], [-4.0, -2.0, 25.0, 30.0],
                      [5.5, 6.25, 9.0, 11.0]], np.float32)
    want = np.asarray(jax_image.crop_and_resize(jnp.asarray(imgs),
                                                jnp.asarray(boxes), out_size))
    got = image.crop_and_resize(torch.from_numpy(imgs),
                                torch.from_numpy(boxes), out_size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(jax_image.resize(jnp.asarray(imgs), out_size))
    got = image.resize(torch.from_numpy(imgs), out_size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,base", [((256, 320), 224), ((40, 48), 32),
                                     ((240, 240), 224)])
def test_multi_scale_crop_boxes_match_jax_with_the_same_draws(hw, base):
    np.testing.assert_array_equal(image._msc_size_pairs(min(hw), base),
                                  jax_image._msc_size_pairs(min(hw), base))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_image.multi_scale_crop_boxes(key, 64, hw, base))
    pair_idx, off_idx = _jax_draws(key, 64, hw, base)
    got = image.multi_scale_crop_boxes(None, 64, hw, base,
                                       pair_idx=pair_idx, off_idx=off_idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_draws_come_from_the_generator():
    g = torch.Generator().manual_seed(5)
    a = image.multi_scale_crop_boxes(g, 500, (256, 320), 224)
    g.manual_seed(5)
    b = image.multi_scale_crop_boxes(g, 500, (256, 320), 224)
    assert torch.equal(a, b)
    y1, x1, y2, x2 = a.unbind(1)
    assert (y1 >= 0).all() and (x1 >= 0).all()
    assert (y2 <= 256).all() and (x2 <= 320).all()
    # every one of the 10 size pairs of the max-distort-1 grid is drawn
    pairs = set(zip((y2 - y1).tolist(), (x2 - x1).tolist()))
    assert pairs == set(map(tuple, image._msc_size_pairs(256, 224).tolist()))
    assert len(pairs) == 10


def test_box_mapping_is_exact_with_the_empty_box_fallback():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 4, 3, 40, 48)
    boxes[0, 0] = [100.0, 100.0, 120.0, 130.0]  # outside the crop: empty
    boxes[1, 1] = [10.0, 10.0, 10.5, 30.0]  # thinner than one pixel
    crop = np.array([[0, 0, 40, 48], [2, 3, 34, 38], [8, 0, 40, 35],
                     [4.25, 6.5, 30.25, 40.5]], np.float32)
    want = np.asarray(jax_augment._map_boxes_through_crop(
        jnp.asarray(boxes), jnp.asarray(crop), 32))
    got = augment._map_boxes_through_crop(
        torch.from_numpy(boxes), torch.from_numpy(crop), 32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [0.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(got[1, 1], [0.0, 0.0, 1.0, 1.0])


def test_pretrain_augment_matches_jax_on_uint8_clips():
    rng = np.random.RandomState(2)
    clips = rng.randint(0, 256, (3, 4, 40, 48, 3)).astype(np.uint8)
    boxes = _boxes(rng, 3, 4, 40, 48)
    key = jax.random.PRNGKey(7)
    want, want_boxes = jax_augment.pretrain_augment(
        key, jnp.asarray(clips), out_size=32, boxes=jnp.asarray(boxes))
    pair_idx, off_idx = _jax_draws(key, 3, (40, 48), 32)
    got, got_boxes = augment.pretrain_augment(
        None, torch.from_numpy(clips), out_size=32,
        boxes=torch.from_numpy(boxes), pair_idx=pair_idx, off_idx=off_idx)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(want_boxes))
    plain, none = augment.pretrain_augment(
        None, torch.from_numpy(clips), out_size=32, pair_idx=pair_idx,
        off_idx=off_idx)
    assert none is None and torch.equal(plain, got)


@pytest.mark.parametrize("n,world,shuffle", [(10, 1, True), (10, 3, True),
                                             (7, 4, False)])
def test_sharded_sampler_equals_jax(n, world, shuffle):
    for rank in range(world):
        ours = pipeline.ShardedSampler(n, rank, world, shuffle, seed=4)
        ref = jax_pipeline.ShardedSampler(n, rank, world, shuffle, seed=4)
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(ours.indices(), ref.indices())


def test_synthetic_dataset_equals_jax():
    kw = dict(n=5, num_frames=4, decode_size=(24, 32), with_boxes=True,
              seed=3)
    ours = pipeline.SyntheticClipDataset(**kw)
    ref = jax_pipeline.SyntheticClipDataset(**kw)
    assert len(ours) == len(ref) == 5
    for i in (0, 4):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("drop_last,num_workers", [(True, 1), (False, 1),
                                                   (False, 3)])
def test_prefetch_loader_batches(drop_last, num_workers):
    ds = pipeline.SyntheticClipDataset(n=7, num_frames=2,
                                       decode_size=(8, 8))
    loader = pipeline.PrefetchLoader(ds, batch_size=3, device="cpu",
                                     drop_last=drop_last,
                                     num_workers=num_workers)
    batches = list(loader)
    assert len(batches) == len(loader) == (2 if drop_last else 3)
    idx = np.concatenate([b["video_idx"].numpy() for b in batches])
    if drop_last:
        np.testing.assert_array_equal(idx, np.arange(6))
        assert "valid" not in batches[0]
    else:  # the last batch wraps to the front and flags the padding
        np.testing.assert_array_equal(idx, [0, 1, 2, 3, 4, 5, 6, 0, 1])
        assert batches[-1]["valid"].tolist() == [True, False, False]
    b = batches[0]
    assert b["clip"].dtype == torch.uint8 and b["clip"].shape == (3, 2, 8,
                                                                  8, 3)
    np.testing.assert_array_equal(b["clip"][1].numpy(), ds[1]["clip"])


def test_prefetch_loader_raises_a_fetch_error():
    class Broken(pipeline.SyntheticClipDataset):
        def __getitem__(self, i):
            if i == 4:
                raise OSError("cannot decode sample 4")
            return super().__getitem__(i)

    loader = pipeline.PrefetchLoader(Broken(n=8, num_frames=1,
                                            decode_size=(4, 4)),
                                     batch_size=2, device="cpu")
    seen = []
    with pytest.raises(OSError, match="sample 4"):
        for batch in loader:
            seen.append(batch["video_idx"].tolist())
    assert seen == [[0, 1], [2, 3]]


def test_prefetch_loader_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.PrefetchLoader(pipeline.SyntheticClipDataset(n=2), 1)


NAME = "pretrain_videomae_base_patch16_224"
GEO = dict(img_size=32, num_frames=4, encoder_embed_dim=64, encoder_depth=2,
           encoder_num_heads=2, decoder_embed_dim=32, decoder_depth=1,
           decoder_num_heads=2, decoder_num_classes=1536)
B, HW = 4, (40, 48)


def test_three_steps_with_augmentation_match_jax():
    """uint8 clips and boxes enter both steps; each augments inside the
    step (the JAX one with the draws of its folded key, the port with the
    same draws injected), then masks, trains and updates."""
    kw = dict(input_size=32, num_frames=4, batch_size=B, dtype="float32",
              motion_loss_weight=True)
    jcfg = JaxPretrainConfig(masking=JaxMaskingConfig(mask_type="tube_bb",
                                                      mask_ratio=0.5), **kw)
    cfg = PretrainConfig(masking=MaskingConfig(mask_type="tube_bb",
                                               mask_ratio=0.5), **kw)
    rng = np.random.RandomState(0)
    batch = {"clip": rng.randint(0, 256, (B, 4) + HW + (3,)).astype(np.uint8),
             "boxes": _boxes(rng, B, 4, *HW)}
    lr = np.linspace(1e-3, 5e-4, 3).astype(np.float32)

    def jax_aug(key, b):
        clips, boxes = jax_augment.pretrain_augment(key, b["clip"], 32,
                                                    b["boxes"])
        return {"clip": clips, "boxes": boxes}

    draws = {}

    def port_aug(generator, b):
        clips, boxes = augment.pretrain_augment(
            generator, b["clip"], 32, b["boxes"], pair_idx=draws["pair"],
            off_idx=draws["off"])
        return {"clip": clips, "boxes": boxes}

    jmodel = jax_create_model(NAME, **GEO)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)),
                         jnp.zeros((1, 8), jnp.int32),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    jtx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                     betas=(0.9, 0.95), weight_decay=0.05)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax.jit(jax_make_pretrain_step(jmodel, jtx, jcfg, lr,
                                           augment_fn=jax_aug))
    model = create_model(NAME, device="cpu", **GEO)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, tx, cfg, lr, device="cpu",
                              augment_fn=port_aug)

    key = jax.random.PRNGKey(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for s in range(3):
        aug_key, mask_key = jax.random.split(jax.random.fold_in(key, s))
        draws["pair"], draws["off"] = _jax_draws(aug_key, B, HW, 32)
        mask = jax_generate_mask(jax.random.split(mask_key, 3)[0],
                                 jax_aug(aug_key, jbatch), jcfg)
        jstate, jm = jstep(jstate, jbatch, key, 0.5)
        state, m = step(state, tbatch, None, 0.5,
                        mask=torch.from_numpy(np.array(mask)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == 3
