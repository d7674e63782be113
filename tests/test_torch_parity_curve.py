"""The port's parity records against mofo_tpu's and the reference's.

- The numpy mask twins of mofo_tpu_torch/ops/masking.py are bit-equal to
  mofo_tpu's over sizes, ratios, seeds and both bug_compat forms, and give
  the golden masks (tests/golden/parity_seed0_reduced.json).
- mofo_tpu_torch/tools/parity_artifact.py's 25-step float64 curve, from
  mofo_tpu's PRNGKey(1) init carried across with params_from_jax, lies
  within CURVE_RTOL of the golden torch_losses (the f64 torch transcription
  of the reference engine) and of mofo_tpu's own ours_losses; AdamW that
  decays the biases and the 1-D parameters (a planted fault) misses it.
  mofo_tpu's init does not change under JAX_ENABLE_X64 (its parameters are
  f32 either way), so it is drawn in this process.
- The forward loss in f32 lies within LOSS_ATOL of the golden
  torch_loss_f64, and the f64 one within 1e-9.
- The plain attention math and the layer norm keep f64 in an f64 model.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import masking as jax_masking
from mofo_tpu_torch.models.layers import layer_norm
from mofo_tpu_torch.ops import attention, masking
from mofo_tpu_torch.tools import parity_artifact as PA
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


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CURVE_RTOL = 1e-6
LOSS_ATOL = 1e-4


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def params():
    """mofo_tpu's PRNGKey(1) init of the reduced geometry, in the port's
    names (tools/parity_artifact.py:202-217)."""
    g = PA.GEOMETRY
    model = jax_create_model(
        PA.MODEL, img_size=g["img"], num_frames=g["frames"],
        encoder_embed_dim=g["enc_dim"], encoder_depth=g["enc_depth"],
        encoder_num_heads=g["enc_heads"], decoder_embed_dim=g["dec_dim"],
        decoder_depth=g["dec_depth"], decoder_num_heads=g["dec_heads"],
        decoder_num_classes=PA.TUBELET * PA.PATCH * PA.PATCH * 3)
    masks, clips = PA.curve_inputs(1)
    mask0 = jnp.asarray(np.stack([masks[0]] * 2), jnp.bool_)
    vis0, msk0 = jax_masking.mask_to_indices(mask0, int(masks[0].sum()))
    tree = model.init(jax.random.PRNGKey(1), jnp.asarray(clips[0]), vis0,
                      msk0)["params"]
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("size,ratio", [((2, 2, 2), 0.9), ((2, 2, 2), 0.5),
                                        ((8, 14, 14), 0.9), ((4, 7, 5), 0.6)])
@pytest.mark.parametrize("seed", [0, 3])
def test_tube_twin_bit_equal(size, ratio, seed):
    np.random.seed(seed)
    want = [jax_masking.TubeMaskingGeneratorNumpy(size, ratio)()
            for _ in range(3)]
    want_next = np.random.rand()
    np.random.seed(seed)
    gen = masking.TubeMaskingGeneratorNumpy(size, ratio)
    got = [gen() for _ in range(3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.random.rand() == want_next
    assert gen.total_masks == int(ratio * size[1] * size[2]) * size[0]


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("size,box", [
    ((2, 2, 2), (32.0, 16.0, 96.0, 80.0)),
    ((8, 14, 14), (40.0, 60.0, 150.0, 130.0)),
    ((8, 14, 14), (0.0, 0.0, 224.0, 224.0)),
    ((4, 7, 5), (70.0, 20.0, 75.0, 100.0)),
])
@pytest.mark.parametrize("seed", [0, 5])
def test_motion_twin_bit_equal(bug_compat, size, box, seed):
    boxes = np.tile(np.asarray(box), (size[0], 1))
    boxes[1:] += 8.0  # later frames differ: bug_compat reads the first
    np.random.seed(seed)
    want = jax_masking.MotionTubeMaskingGeneratorNumpy(
        size, 0.9, 0.75, bug_compat=bug_compat)(boxes)
    want_next = np.random.rand()  # the same number of draws before it
    np.random.seed(seed)
    got = masking.MotionTubeMaskingGeneratorNumpy(
        size, 0.9, 0.75, bug_compat=bug_compat)(boxes)
    np.testing.assert_array_equal(got, want)
    assert np.random.rand() == want_next


def test_mask_and_frame_records_equal_the_golden():
    golden = _golden("parity_seed0_reduced.json")
    assert PA.mask_records(2, 2, 2) == golden["masks"]
    assert PA.frame_records() == golden["tsn_frames_pin_seed"]


def test_f64_curve_matches_the_reference_engine(params):
    golden = _golden("parity_curve_reduced.json")["loss_curve"]
    curve = PA.curve_record(params, device="cpu")
    assert curve["n_steps"] == golden["n_steps"] == 25
    assert PA.rel_diff(curve["losses"], golden["torch_losses"]) < CURVE_RTOL
    assert PA.rel_diff(curve["losses"], golden["ours_losses"]) < CURVE_RTOL


def test_planted_decay_grouping_fault_misses_the_curve(params, monkeypatch):
    """AdamW that decays every parameter (the biases, the norms' scales and
    the skip list too) must leave the reference's curve."""
    monkeypatch.setattr(optim, "decay_mask",
                        lambda named: dict.fromkeys(named, True))
    golden = _golden("parity_curve_reduced.json")["loss_curve"]
    curve = PA.curve_record(params, device="cpu")
    assert PA.rel_diff(curve["losses"], golden["torch_losses"]) > \
        10 * CURVE_RTOL


def test_forward_loss_matches_the_reference(params):
    golden = _golden("parity_seed0_reduced.json")["forward_loss"]
    rec = PA.loss_record(params, device="cpu")
    assert rec["n_masked"] == golden["n_masked"]
    assert abs(rec["loss_f32"] - golden["torch_loss_f64"]) < LOSS_ATOL
    np.testing.assert_allclose(rec["loss_f32"], golden["ours_loss_f32"],
                               rtol=1e-5)
    assert abs(rec["loss_f64"] - golden["torch_loss_f64"]) < 1e-9


def test_plain_attention_and_layer_norm_keep_f64():
    """The f64 curve's route: an f32 softmax or norm would round to 1e-7."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 8, 32)) for _ in range(3))
    out = attention.xla_attention(q, k, v, scale=32 ** -0.5)
    want = torch.softmax(q @ k.transpose(-1, -2) * 32 ** -0.5, -1) @ v
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, want, rtol=0, atol=1e-14)
    norm = torch.nn.LayerNorm(64).double()
    x = torch.from_numpy(rng.randn(3, 64) * 3 + 1)
    got = layer_norm(x, norm, torch.float64)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, norm(x), rtol=0, atol=0)
