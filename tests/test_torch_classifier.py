"""The port's finetune classifiers against the JAX models with the same
weights.

VisionTransformer and VisionTransformerBBFocused (all four fusing modes)
run in both packages on the same clips and boxes, weights carried by
params_from_jax. The JAX side runs attn_impl="pallas": its Blocks run the
TPU kernels K1/K2 and its MCA block K3, in interpret mode. f32 logits
agree within 1e-4. The boxes include a sample with no in-box token (the
plain-mean fallback) and one whose box covers the frame (no out-box token,
so the MCA attends to the in-box set).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.models.bb_focused import token_in_box_map as jax_in_box
from mofo_tpu.train.checkpoint import import_torch_finetune
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.models.bb_focused import token_in_box_map
from mofo_tpu_torch.train.checkpoint import (
    finetune_init_from_pretrain,
    params_from_jax,
)


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
VIT = "vit_base_patch16_224"
# embed 128 as 2 x 64 heads (K1/K2 at A = 128); the MCA as 2 x 64 or, at
# embed 256, 1 x 256 (the MCA's head dim)
GEO = dict(img_size=32, all_frames=4, embed_dim=128, depth=2, num_heads=2,
           num_classes=7, init_scale=1.0)
B = 3


def _clip(seed=0):
    return np.random.RandomState(seed).randn(B, 4, 32, 32, 3).astype(
        np.float32)


def _boxes():
    """Sample 0 a partial box, sample 1 no in-box token, sample 2 a box
    over the whole frame (no out-box token)."""
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[0] = [3.0, 5.0, 14.0, 12.0]
    boxes[0, 1:] += np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    boxes[1] = [100.0, 100.0, 120.0, 120.0]
    boxes[2] = [0.0, 0.0, 32.0, 32.0]
    return boxes


def _pair(name, geo, *args):
    jmodel = jax_create_model(name, attn_impl="pallas", **geo)
    params = jmodel.init(jax.random.PRNGKey(1),
                         *map(jnp.asarray, args))["params"]
    params = jax.tree.map(np.asarray, params)
    port = create_model(name, device="cpu", **geo)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, port


def test_vision_transformer_matches_jax():
    clip = _clip()
    jmodel, params, port = _pair(VIT, GEO, clip)
    x = torch.from_numpy(clip)
    for kw in ({}, {"return_features": True}, {"return_tokens": True}):
        ours = port(x, **kw).detach().numpy()
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip),
                                      **kw))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode,embed,mca_heads", [
    ("org", 128, 2), ("weighted_mean", 128, 2), ("soft_attn", 128, 2),
    ("MCA", 128, 2), ("MCA", 256, 1),
])
def test_bb_focused_matches_jax(mode, embed, mca_heads):
    geo = dict(GEO, embed_dim=embed, num_heads=embed // 64,
               fusing_method=mode, mca_num_heads=mca_heads)
    clip, boxes = _clip(1), _boxes()
    jmodel, params, port = _pair(BB, geo, clip, boxes)
    ours = port(torch.from_numpy(clip), torch.from_numpy(boxes))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip),
                                  jnp.asarray(boxes)))
    assert ours.shape == (B, 7)
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)


def test_bb_focused_fallbacks():
    """No in-box token: the fused feature is the plain token mean in every
    mode, so sample 1's logits agree across modes; the full-frame box
    attends to its own tokens and stays finite."""
    clip, boxes = torch.from_numpy(_clip(2)), torch.from_numpy(_boxes())
    logits, shared = {}, None
    for mode in ("org", "weighted_mean", "MCA"):
        m = create_model(BB, device="cpu", fusing_method=mode, seed=4,
                         **dict(GEO, mca_num_heads=2))
        if shared is None:
            shared = m.state_dict()  # backbone, fc_norm and head
        m.load_state_dict(shared, strict=False)
        logits[mode] = m(clip, boxes).detach()
        assert torch.isfinite(logits[mode]).all()
    torch.testing.assert_close(logits["MCA"][1], logits["org"][1])
    torch.testing.assert_close(logits["weighted_mean"][1], logits["org"][1])
    assert not torch.allclose(logits["MCA"][0], logits["org"][0])


def test_token_in_box_map_bit_equal():
    rng = np.random.RandomState(3)
    xy1 = rng.uniform(-8, 40, (4, 16, 2))
    boxes = np.concatenate([xy1, xy1 + rng.uniform(0, 30, (4, 16, 2))],
                           -1).astype(np.float32)
    boxes[0, :, :2] = boxes[0, :, 2:]  # empty boxes
    ours = token_in_box_map(torch.from_numpy(boxes), patches_per_side=4)
    ref = np.asarray(jax_in_box(jnp.asarray(boxes), patches_per_side=4))
    assert ours.dtype == torch.bool and ours.shape == (4, 8 * 16)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ref.any() and not ref.all()


def _jax_backbone_and_head(params):
    """The JAX tree as import_torch_finetune lays it out."""
    tree = dict(params.get("backbone", {}))
    tree.update({k: v for k, v in params.items()
                 if k in ("patch_embed", "fc_norm", "head", "norm")
                 or k.startswith("blocks_")})
    return tree


@pytest.mark.parametrize("name,geo", [
    (VIT, GEO), (VIT, dict(GEO, use_mean_pooling=False)),
    (BB, dict(GEO, fusing_method="MCA", mca_num_heads=2)),
])
def test_import_torch_finetune_reads_the_port(name, geo):
    args = (_clip(),) if name == VIT else (_clip(), _boxes())
    _, params, port = _pair(name, geo, *args)
    back = import_torch_finetune(port.state_dict())
    want = _jax_backbone_and_head(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["soft_attn", "MCA"])
def test_params_from_jax_maps_every_leaf(mode):
    geo = dict(GEO, fusing_method=mode, mca_num_heads=2, init_values=0.1)
    jmodel = jax_create_model(BB, attn_impl="pallas", **geo)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(_clip()),
                         jnp.asarray(_boxes()))["params"]
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert len(sd) == len(jax.tree.leaves(params))
    port = create_model(BB, device="cpu", **geo)
    assert set(sd) == set(port.state_dict())
    assert all(tuple(sd[k].shape) == tuple(v.shape)
               for k, v in port.state_dict().items())
    if mode == "MCA":
        assert sd["local_MCA.0.attn.kv.weight"].shape == (256, 128)
        assert "local_MCA.0.gamma_1" in sd
    else:
        assert sd["soft_att_local.weight"].shape == (128, 1)


def test_finetune_init_from_pretrain_copies_the_encoder():
    pre = create_model("pretrain_videomae_base_patch16_224", device="cpu",
                       seed=1, img_size=32, num_frames=4,
                       encoder_embed_dim=128, encoder_depth=2,
                       encoder_num_heads=2, decoder_embed_dim=64,
                       decoder_depth=1, decoder_num_heads=1)
    psd = pre.state_dict()
    for name, geo in ((BB, dict(GEO, fusing_method="MCA")), (VIT, GEO)):
        model = create_model(name, device="cpu", seed=2, **geo)
        head = model.head.weight.detach().clone()
        copied = finetune_init_from_pretrain(model, psd)
        target = getattr(model, "backbone", model).state_dict()
        assert "patch_embed.proj.weight" in copied
        assert set(copied) == {n for n in target
                               if n.startswith(("patch_embed.", "blocks."))}
        for n in copied:
            assert torch.equal(target[n], psd["encoder." + n]), n
        assert torch.equal(model.head.weight, head)
    with pytest.raises(ValueError, match="no encoder"):
        finetune_init_from_pretrain(model, {"decoder.norm.weight": 0})
