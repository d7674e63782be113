"""The registry's large geometries against the JAX package, on the CPU.

Each preset that chip_smoke.py's large_presets phase runs as whole steps on
the card keeps here its own width, heads and token grid, cut in depth to
one Block (the pretrain preset one encoder and one decoder Block), at B = 1
in f32; the 384 and 512 px presets take 2 frames (576 and 1024 tokens):

  pretrain_videomae_large_patch16_224  1024 x 16 heads on 160 visible of
                                       1568 tokens, decoder 512 x 8
  vit_large_patch16_224                1568 tokens, 1024 x 16
  vit_base_patch16_384                 576 tokens (24^2 grid), 768 x 12
  vit_base_patch16_224, 32 frames      3136 tokens, 768 x 12
  vit_large_patch16_384                576 tokens, 1024 x 16
  vit_large_patch16_512                1024 tokens (32^2 grid), 1024 x 16

The port's weights (from a seed) go to mofo_tpu through
mofo_tpu.train.checkpoint.import_torch_{pretrain,finetune}, and so do its
gradients, name by name. JAX runs its plain attention route
(attn_impl="xla"), the port its default one: every Block here takes the
flat K1/K2 route, whose plain versions run on the CPU. Loss: softmax
cross entropy on fixed labels (the classifiers), the mean squared error to
a fixed target on the masked tokens (the pretrain model). Bounds: the loss
within rtol 1e-5, each gradient within 1e-4 of its tensor's largest
entry (f32 sums over up to 3136 tokens taken in another order; measured:
at most 2.4e-7 and 1.6e-6; a fault in a positional table or the patch
grid moves them by O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import masking as jax_masking
from mofo_tpu.train.checkpoint import (
    import_torch_finetune,
    import_torch_pretrain,
)
from mofo_tpu_torch.models import create_model

N_CLASSES = 7
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
# name, frames, img, tokens
CLASSIFIERS = [
    ("vit_large_patch16_224", 16, 224, 1568),
    ("vit_base_patch16_384", 2, 384, 576),
    ("vit_base_patch16_224", 32, 224, 3136),
    ("vit_large_patch16_384", 2, 384, 576),
    ("vit_large_patch16_512", 2, 512, 1024),
]
PRETRAIN = "pretrain_videomae_large_patch16_224"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _grads_close(port_grads: dict, jax_grads, importer):
    """Every gradient of the port (carried into the JAX tree by `importer`)
    against JAX's, leaf by leaf."""
    ours = importer(port_grads)
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(jax_grads)[0])
    assert len(flat_ours) == len(flat_ref)
    for path, g in flat_ours:
        ref = np.asarray(flat_ref[path])
        assert g.shape == ref.shape, path
        err = np.abs(np.asarray(g) - ref).max()
        assert err <= GRAD_REL * np.abs(ref).max() + 1e-12, (
            jax.tree_util.keystr(path), err, np.abs(ref).max())


def _port_grads(model) -> dict:
    return {n: p.grad.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name,frames,img,tokens", CLASSIFIERS)
def test_classifier_preset_matches_jax(name, frames, img, tokens):
    geo = dict(num_classes=N_CLASSES, all_frames=frames, depth=1,
               init_scale=1.0)
    port = create_model(name, device="cpu", seed=3, **geo)
    assert port.patch_embed.num_patches == tokens
    assert port.blocks[0].attn.uses_flat(tokens)
    rng = np.random.RandomState(tokens)
    clip = rng.randn(1, frames, img, img, 3).astype(np.float32)
    label = np.array([rng.randint(N_CLASSES)])

    logits = port(torch.from_numpy(clip))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(label))
    loss.backward()

    jmodel = jax_create_model(name, attn_impl="xla", **geo)
    params = import_torch_finetune(port.state_dict())

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(clip))
        logp = jax.nn.log_softmax(out.astype(jnp.float32))
        return -jnp.take_along_axis(logp, jnp.asarray(label)[:, None],
                                    axis=-1).mean()

    ref, grads = jax.jit(jax.value_and_grad(jloss))(params)
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    _grads_close(_port_grads(port), grads, import_torch_finetune)


def test_pretrain_preset_matches_jax():
    geo = dict(encoder_depth=1, decoder_depth=1)
    port = create_model(PRETRAIN, device="cpu", seed=3, **geo)
    mask = jax_masking.tube_mask(jax.random.PRNGKey(0), 1,
                                 temporal_positions=8, patches_per_frame=196,
                                 mask_ratio=0.9)
    vis, msk = (np.array(a) for a in jax_masking.mask_to_indices(
        mask, 8 * 176))
    assert vis.shape == (1, 160) and port.encoder.blocks[0].attn.uses_flat(
        160) and port.decoder.blocks[0].attn.uses_flat(1568)
    rng = np.random.RandomState(5)
    clip = rng.randn(1, 16, 224, 224, 3).astype(np.float32)
    target = rng.randn(1, msk.shape[1], 1536).astype(np.float32)

    pred = port(torch.from_numpy(clip), torch.from_numpy(vis).long(),
                torch.from_numpy(msk).long())
    loss = ((pred - torch.from_numpy(target)) ** 2).mean()
    loss.backward()

    jmodel = jax_create_model(PRETRAIN, attn_impl="xla", **geo)
    params = import_torch_pretrain(port.state_dict())

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(clip),
                           jnp.asarray(vis), jnp.asarray(msk))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    ref, grads = jax.jit(jax.value_and_grad(jloss))(params)
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    _grads_close(_port_grads(port), grads, import_torch_pretrain)
