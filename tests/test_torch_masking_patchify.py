"""The port's masking and target construction against the JAX package.

JAX and torch draw different numbers from one seed, so the JAX uniforms are
rebuilt from their keys and injected into the port (`scores`, `r1`, `r2`):
the masks must then be bit-equal. Targets agree closely in f32 and within
bf16 rounding in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops import masking as jm
from mofo_tpu.ops import patchify as jp
from mofo_tpu_torch.ops import masking as tm
from mofo_tpu_torch.ops import patchify as tp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)



def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _boxes(B=6, T=16, size=224, seed=0):
    rng = np.random.RandomState(seed)
    xy1 = rng.uniform(0, size * 0.6, (B, T, 2))
    wh = rng.uniform(size * 0.1, size * 0.5, (B, T, 2))
    return np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)


def test_tube_mask_bit_equal_with_injected_scores():
    key = jax.random.PRNGKey(7)
    ref = jm.tube_mask(key, 5, temporal_positions=8, patches_per_frame=196,
                       mask_ratio=0.9)
    scores = jax.random.uniform(key, (5, 196))
    ours = tm.tube_mask(5, temporal_positions=8, patches_per_frame=196,
                        mask_ratio=0.9, scores=_t(scores))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bug_compat", [False, True])
@pytest.mark.parametrize("box_reduce", ["first", "union"])
def test_motion_tube_mask_bit_equal_with_injected_uniforms(bug_compat,
                                                           box_reduce):
    boxes = _boxes()
    key = jax.random.PRNGKey(11)
    kw = dict(temporal_positions=8, patches_per_side=14, patch_size=16,
              mask_ratio=0.9, mask_ratio_bb=0.75, bug_compat=bug_compat,
              box_reduce=box_reduce)
    ref = jm.motion_tube_mask(key, jnp.asarray(boxes), **kw)
    k1, k2 = jax.random.split(key)
    r1 = jax.random.uniform(k1, (6, 196))
    r2 = jax.random.uniform(k2, (6, 196))
    ours = tm.motion_tube_mask(_t(boxes), r1=_t(r1), r2=_t(r2), **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mask_type", ["tube", "tube_bb"])
def test_masks_hold_exactly_the_masked_budget(mask_type):
    g = torch.Generator().manual_seed(0)
    if mask_type == "tube":
        mask = tm.tube_mask(9, generator=g)
    else:
        mask = tm.motion_tube_mask(_t(_boxes(B=9)), generator=g)
    assert mask.shape == (9, 1568)
    per_frame = mask.reshape(9, 8, 196).sum(-1)
    assert (per_frame == int(0.9 * 196)).all()
    assert (mask.reshape(9, 8, 196) == mask.reshape(9, 8, 196)[:, :1]).all()


@pytest.mark.parametrize("edge,bug_compat", [
    ("inclusive", False), ("paint", False), ("inclusive", True)
])
def test_box_to_patch_map_bit_equal(edge, bug_compat):
    boxes = _boxes(B=4, T=3)
    boxes[0, 0] = [32.0, 48.0, 32.0, 80.0]  # empty box
    ref = jm.box_to_patch_map(jnp.asarray(boxes), edge=edge,
                              bug_compat=bug_compat)
    ours = tm.box_to_patch_map(_t(boxes), edge=edge, bug_compat=bug_compat)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_tokens_in_box_and_mask_to_indices_bit_equal():
    boxes = _boxes(B=4)
    mask = jm.tube_mask(jax.random.PRNGKey(3), 4)
    vis, msk = jm.mask_to_indices(mask, 8 * 176)
    t_vis, t_msk = tm.mask_to_indices(_t(mask), 8 * 176)
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(vis))
    np.testing.assert_array_equal(t_msk.numpy(), np.asarray(msk))
    ref = jm.tokens_in_box(jnp.asarray(boxes), msk)
    ours = tm.tokens_in_box(_t(boxes), t_msk)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < int(ours.sum()) < ours.numel()


def test_gather_tokens():
    tokens = np.random.RandomState(0).randn(2, 10, 3).astype(np.float32)
    idx = np.array([[1, 4, 9], [0, 2, 3]])
    ours = tm.gather_tokens(_t(tokens), _t(idx))
    np.testing.assert_array_equal(
        ours.numpy(), np.take_along_axis(tokens, idx[..., None], axis=1)
    )


def _clip(B=2, seed=0):
    return np.random.RandomState(seed).randn(B, 4, 32, 32, 3).astype(
        np.float32
    )


def test_patchify_flat_bit_equal():
    clip = _clip()
    np.testing.assert_array_equal(
        tp.patchify_flat(_t(clip)).numpy(),
        np.asarray(jp.patchify_flat(jnp.asarray(clip))),
    )


@pytest.mark.parametrize("normalize_target", [True, False])
def test_targets_f32_close(normalize_target):
    clip = _clip(seed=1)
    idx = np.array([[1, 3, 4, 6], [0, 2, 5, 7]])
    ref = jp.masked_normalized_targets(
        jp.patchify_flat(jnp.asarray(clip)), jnp.asarray(idx),
        normalize_target=normalize_target,
    )
    ours = tp.masked_normalized_targets(
        tp.patchify_flat(_t(clip)), _t(idx),
        normalize_target=normalize_target,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_targets_bf16_within_rounding():
    clip = _clip(seed=2)
    idx = np.array([[1, 3, 4, 6], [0, 2, 5, 7]])
    ref = jp.masked_normalized_targets(
        jp.patchify_flat(jnp.asarray(clip).astype(jnp.bfloat16)),
        jnp.asarray(idx), compute_dtype=jnp.bfloat16,
    )
    ours = tp.masked_normalized_targets(
        tp.patchify_flat(_t(clip).to(torch.bfloat16)), _t(idx),
        compute_dtype=torch.bfloat16,
    )
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    # one bf16 rounding step of the result (2^-8 relative) plus the f32
    # statistics' summation order
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_mse_loss(weighted):
    rng = np.random.RandomState(3)
    pred, target = rng.randn(2, 2, 4, 6).astype(np.float32)
    w = (1.0 + 0.5 * (rng.rand(2, 4) > 0.5)).astype(np.float32)
    ref = jp.masked_mse_loss(jnp.asarray(pred), jnp.asarray(target),
                             jnp.asarray(w) if weighted else None)
    ours = tp.masked_mse_loss(_t(pred), _t(target),
                              _t(w) if weighted else None)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
