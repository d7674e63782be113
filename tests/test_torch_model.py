"""The port's pretrain ViT against the JAX model with the same weights.

Weights go from the JAX tree to the port through params_from_jax and back
through mofo_tpu.train.checkpoint.import_torch_pretrain; both models get
the same vis_idx / masked_idx. f32 outputs agree within 1e-4 (the bound of
tests/test_parity_torch.py:81), once against JAX's XLA attention and once
with attn_impl="pallas", where the JAX side runs the TPU kernels K1/K2 in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import masking as jax_masking
from mofo_tpu.train.checkpoint import import_torch_pretrain
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.models.layers import (
    Mlp,
    get_sinusoid_encoding_table,
)
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


NAME = "pretrain_videomae_base_patch16_224"


def _geometry(enc, dec):
    return dict(img_size=32, num_frames=4, encoder_embed_dim=enc,
                encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=dec,
                decoder_depth=2, decoder_num_heads=2,
                decoder_num_classes=1536)


def _pair(attn_impl, enc, dec, B=2, seed=0):
    """(jax model, params, port model, clip, vis_idx, masked_idx)."""
    geo = _geometry(enc, dec)
    jmodel = jax_create_model(NAME, attn_impl=attn_impl, **geo)
    clip = np.random.RandomState(seed).randn(B, 4, 32, 32, 3).astype(
        np.float32
    )
    mask = jax_masking.tube_mask(jax.random.PRNGKey(seed), B,
                                 temporal_positions=2, patches_per_frame=4,
                                 mask_ratio=0.5)
    vis, msk = jax_masking.mask_to_indices(mask, 4)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(clip), vis,
                         msk)["params"]
    params = jax.tree.map(np.asarray, params)
    port = create_model(NAME, device="cpu", **geo)
    port.load_state_dict(params_from_jax(params), strict=True)
    return (jmodel, params, port, clip, np.array(vis), np.array(msk))


@pytest.mark.parametrize("attn_impl,enc,dec", [
    ("xla", 64, 32),      # JAX XLA attention, head dims 32 and 16
    ("xla", 128, 64),
    ("pallas", 128, 128),  # JAX runs K1/K2 (interpret) in every block
])
def test_forward_matches_jax(attn_impl, enc, dec):
    jmodel, params, port, clip, vis, msk = _pair(attn_impl, enc, dec)
    ours = port(torch.from_numpy(clip), torch.from_numpy(vis).long(),
                torch.from_numpy(msk).long()).detach().numpy()
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip),
                                  jnp.asarray(vis), jnp.asarray(msk)))
    assert ours.shape == (2, 4, 1536)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_weights_round_trip_exactly():
    _, params, port, *_ = _pair("xla", 64, 32)
    back = import_torch_pretrain(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_uses_reference_names_and_layouts():
    port = create_model(NAME, device="cpu", **_geometry(64, 32))
    sd = port.state_dict()
    assert sd["encoder.patch_embed.proj.weight"].shape == (64, 3, 2, 16, 16)
    assert sd["encoder.blocks.0.attn.qkv.weight"].shape == (192, 64)
    assert sd["decoder.head.weight"].shape == (1536, 32)
    assert sd["encoder_to_decoder.weight"].shape == (32, 64)
    assert sd["mask_token"].shape == (1, 1, 32)
    assert not any("pos_embed" in k for k in sd)  # frozen tables
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_same_seed_same_weights_and_bf16_forward():
    a = create_model(NAME, device="cpu", seed=3, **_geometry(64, 32))
    b = create_model(NAME, device="cpu", seed=3, dtype=torch.bfloat16,
                     **_geometry(64, 32))
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
    clip = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator()
                       .manual_seed(0))
    vis = torch.tensor([[0, 2, 4, 6]] * 2)
    msk = torch.tensor([[1, 3, 5, 7]] * 2)
    out = b(clip, vis, msk)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    ref = a(clip, vis, msk)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               ref.detach().numpy(), atol=0.1)


def test_sinusoid_table_matches_jax():
    from mofo_tpu.models.layers import get_sinusoid_encoding_table as jtab

    np.testing.assert_array_equal(get_sinusoid_encoding_table(1568, 384)
                                  .numpy(), np.asarray(jtab(1568, 384)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_gelu_form_matches_jax(dtype):
    from mofo_tpu.models.layers import Mlp as JaxMlp

    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = JaxMlp(hidden_features=64, out_features=16, dtype=jdt)
    p = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"])
    m = Mlp(16, 64, dtype=tdt)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(m, name).weight.copy_(torch.from_numpy(
                p[name]["kernel"].T.copy()))
            getattr(m, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
    ours = m(torch.from_numpy(x).to(tdt)).float().detach().numpy()
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x).astype(jdt))
                     .astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)
