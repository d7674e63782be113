"""The model's last switches against mofo_tpu, on the CPU: attention bias,
dropout, attn_head_dim and prob sowing.

- ops.attention.xla_attention / dot_product_attention with a bias and with
  attention dropout against mofo_tpu.ops.attention, the keep mask that JAX
  draws handed to the port;
- models.layers.Attention's switches against mofo_tpu's Attention:
  attn_head_dim (A != dim) on the head-major route and on the flat K1/K2
  route (JAX through the interpret-mode TPU kernel), proj_drop and
  attn_drop in train mode, an attention bias, and sow_attn (the kept
  probabilities equal flax's intermediates);
- the classifier, the pretrain model and the BB-MCA model in train mode at
  drop_rate = attn_drop_rate = 0.1. JAX's keep masks are recorded by
  wrapping jax.random.bernoulli (flax's nn.Dropout and xla_attention both
  draw through it) in an un-jitted apply, and handed to the port in call
  order through ops.attention.keep_mask, where every port mask is drawn;
- the routes: which of K1/K2, K3, K4 or the plain math runs under a bias,
  active dropout, sowing and eval mode;
- data parallelism: 3 BB-MCA finetune steps at drop_rate = attn_drop_rate
  = 0.1 over W = 2 gloo ranks (tests/torch_ddp_worker.py's models and
  batches) equal one process on the global batch;
- the finetune CLI runs --drop and --attn_drop_rate above 0.
f32 throughout, atol = rtol = 1e-4 (tests/test_torch_classifier.py's).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.models.layers import Attention as JaxAttention
from mofo_tpu.ops import attention as jax_attention
from mofo_tpu.ops import masking as jax_masking
from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.models import create_model, layers
from mofo_tpu_torch.models.layers import Attention, CrossAttention, dropout
from mofo_tpu_torch.ops import attention
from mofo_tpu_torch.tools import main_path as mp
from mofo_tpu_torch.train.checkpoint import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
RATE = 0.1


def _record(monkeypatch) -> list:
    """Wraps jax.random.bernoulli; returns the list its masks (numpy bool)
    are appended to, in call order."""
    masks = []
    real = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None, **kw):
        mask = real(key, p, shape, **kw)
        masks.append(np.array(mask))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return masks


def _inject(monkeypatch, masks: list) -> list:
    """Serves `masks` in order from ops.attention.keep_mask; returns the
    list of shapes asked for."""
    it, asked = iter(masks), []

    def keep_mask(shape, rate, generator, device):
        mask = next(it)
        assert tuple(shape) == mask.shape and rate == RATE
        asked.append(tuple(shape))
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(attention, "keep_mask", keep_mask)
    return asked


def _close(ours: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.detach().numpy(), ref, **TOL)


# --- the attention math ----------------------------------------------------


def _qkv(B=2, H=2, N=16, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, N, D).astype(np.float32) for _ in range(3)]


def _bias(B=2, N=16, seed=1):
    """(B, 1, 1, N) additive f32: 0 or -inf per kv column (every row keeps
    one), as the MCA's head-major route builds it."""
    keep = np.random.RandomState(seed).rand(B, N) < 0.6
    keep[:, 0] = True
    return np.where(keep, 0.0, -np.inf).astype(np.float32)[:, None, None]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_xla_attention_matches_jax(with_bias, rate, monkeypatch):
    q, k, v = _qkv()
    bias = _bias() if with_bias else None
    masks = _record(monkeypatch)
    ref = jax_attention.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), scale=0.3,
        bias=None if bias is None else jnp.asarray(bias),
        dropout_rate=rate, dropout_rng=jax.random.PRNGKey(3),
        deterministic=False)
    assert len(masks) == (rate > 0)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    for fn in (attention.xla_attention, attention.dot_product_attention):
        asked = _inject(monkeypatch, masks)
        _close(fn(*t, scale=0.3, bias=tb, dropout_rate=rate,
                  deterministic=False), ref)
        assert len(asked) == len(masks)


def test_keep_mask_draws_from_the_generator():
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = attention.keep_mask((4, 3, 8), 0.25, g(), "cpu")
    assert a.dtype == torch.bool and a.shape == (4, 3, 8)
    assert torch.equal(a, torch.rand((4, 3, 8), generator=g()) < 0.75)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        attention.keep_mask((4,), 0.25, None, "cpu")
    x = torch.ones(4, 3, 8)
    # the flax formula; nothing drawn outside training or at rate 0
    out = dropout(x, 0.25, True, g())
    assert torch.equal(out, torch.where(a, x / 0.75, 0.0))
    assert dropout(x, 0.25, False) is x and dropout(x, 0.0, True) is x


def test_dispatch_routes_and_refusals(monkeypatch):
    """"auto" takes K4 from 128 tokens without a bias or active dropout,
    the plain math otherwise; "pallas" raises on either, with the
    reference's messages."""
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **k: calls.append("k4") or a[0])
    q = torch.zeros(1, 1, 128, 16)
    bias = torch.zeros(1, 1, 1, 128)
    g = torch.Generator().manual_seed(0)
    attention.dot_product_attention(q, q, q, scale=1.0)
    attention.dot_product_attention(q, q, q, scale=1.0, dropout_rate=RATE,
                                    deterministic=True)  # eval: inactive
    assert calls == ["k4", "k4"]
    attention.dot_product_attention(q, q, q, scale=1.0, bias=bias)
    attention.dot_product_attention(q, q, q, scale=1.0, dropout_rate=RATE,
                                    deterministic=False, generator=g)
    assert calls == ["k4", "k4"]
    with pytest.raises(ValueError, match="does not support an attention "
                                         "bias"):
        attention.dot_product_attention(q, q, q, scale=1.0, bias=bias,
                                        impl="pallas")
    with pytest.raises(ValueError, match="does not support attention "
                                         "dropout"):
        attention.dot_product_attention(q, q, q, scale=1.0,
                                        dropout_rate=RATE,
                                        deterministic=False, impl="pallas")


# --- Attention's switches ---------------------------------------------------


def _attention_pair(dim, heads, head_dim, N, *, attn_impl="auto",
                    **switches):
    """(JAX Attention, its params, the port's Attention with the same
    weights, x (2, N, dim) as numpy)."""
    x = np.random.RandomState(N).randn(2, N, dim).astype(np.float32)
    jmod = JaxAttention(dim=dim, num_heads=heads, qkv_bias=True,
                        attn_head_dim=head_dim, attn_impl=attn_impl,
                        **switches)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    rng = np.random.RandomState(7)  # the zero-initialized biases
    params = {n: (rng.randn(*np.shape(p)).astype(np.float32) * 0.1
                  if n.endswith("bias") else np.asarray(p))
              for n, p in params.items()}
    port = Attention(dim, heads, qkv_bias=True, attn_head_dim=head_dim,
                     attn_impl="auto", **switches)
    sd = params_from_jax({"blocks_0": {"attn": params}})
    port.load_state_dict({n[len("blocks.0.attn."):]: t
                          for n, t in sd.items()}, strict=True)
    return jmod, params, port, x


@pytest.mark.parametrize("dim,heads,head_dim,N,jax_impl,flat", [
    (64, 2, 48, 16, "auto", False),  # A = 96: head-major, plain math
    (32, 2, 64, 128, "pallas", True),  # A = 128: the flat K1/K2 route
])
def test_attn_head_dim_matches_jax(dim, heads, head_dim, N, jax_impl, flat):
    jmod, params, port, x = _attention_pair(dim, heads, head_dim, N,
                                            attn_impl=jax_impl)
    port.eval()
    assert port.all_head_dim == heads * head_dim != dim
    assert port.uses_flat(N) == flat
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out ** 2).sum().backward()

    def loss(xj):
        o = jmod.apply({"params": params}, xj)
        return jnp.sum(o ** 2), o

    (_, ref), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    _close(out, ref)
    _close(xt.grad, grad)


@pytest.mark.parametrize("attn_drop,proj_drop", [(0.0, RATE), (RATE, 0.0),
                                                 (RATE, RATE)])
def test_attention_dropout_matches_jax(attn_drop, proj_drop, monkeypatch):
    jmod, params, port, x = _attention_pair(64, 2, None, 16,
                                            attn_drop=attn_drop,
                                            proj_drop=proj_drop)
    masks = _record(monkeypatch)
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(4)})
    assert len(masks) == (attn_drop > 0) + (proj_drop > 0)
    asked = _inject(monkeypatch, masks)
    port.train()
    _close(port(torch.from_numpy(x)), ref)
    assert asked == [m.shape for m in masks]
    # eval: nothing drawn, the same output as JAX's deterministic apply
    port.eval()
    _close(port(torch.from_numpy(x)),
           jmod.apply({"params": params}, jnp.asarray(x)))
    assert len(asked) == len(masks)


def test_attention_bias_and_sown_probs_match_jax():
    jmod, params, port, x = _attention_pair(64, 2, None, 16, sow_attn=True)
    port.eval()
    bias = np.random.RandomState(5).randn(2, 1, 16, 16).astype(np.float32)
    ref, inter = jmod.apply({"params": params}, jnp.asarray(x),
                            attn_bias=jnp.asarray(bias),
                            mutable=["intermediates"])
    _close(port(torch.from_numpy(x), attn_bias=torch.from_numpy(bias)), ref)
    (probs,) = inter["intermediates"]["attn_probs"]
    assert port.attn_probs.dtype == torch.float32
    _close(port.attn_probs, probs)  # the softmax without the bias


# --- the models in train mode ------------------------------------------------


SMALL = dict(img_size=32, drop_rate=RATE, attn_drop_rate=RATE)


def _train_pair(name, jax_geo, port_geo, *inputs):
    jmodel = jax_create_model(name, **jax_geo)
    params = jmodel.init(jax.random.PRNGKey(1),
                         *map(jnp.asarray, inputs))["params"]
    params = jax.tree.map(np.asarray, params)
    port = create_model(name, device="cpu", **port_geo)
    port.load_state_dict(params_from_jax(params), strict=True)
    port.train()
    return jmodel, params, port


def _models():
    rng = np.random.RandomState(0)
    clip = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    boxes = np.array([[[3.0, 5.0, 14.0, 12.0]] * 4,
                      [[0.0, 0.0, 32.0, 32.0]] * 4], np.float32)
    mask = jax_masking.tube_mask(jax.random.PRNGKey(0), 2,
                                 temporal_positions=2, patches_per_frame=4,
                                 mask_ratio=0.5)
    vis, msk = (np.array(a) for a in jax_masking.mask_to_indices(mask, 4))
    vit = dict(SMALL, all_frames=4, embed_dim=64, depth=2, num_heads=2,
               num_classes=5, init_scale=1.0)
    bb = dict(vit, embed_dim=128, fusing_method="MCA", mca_num_heads=2)
    pre = dict(SMALL, num_frames=4, encoder_embed_dim=64, encoder_depth=2,
               encoder_num_heads=2, decoder_embed_dim=32, decoder_depth=1,
               decoder_num_heads=2, decoder_num_classes=1536)
    return {"classifier": ("vit_base_patch16_224", vit, (clip,)),
            "bb_mca": ("vit_base_patch16_224_BB_focused", bb, (clip, boxes)),
            "pretrain": ("pretrain_videomae_base_patch16_224", pre,
                         (clip, vis, msk))}


@pytest.mark.parametrize("which", ["classifier", "bb_mca", "pretrain"])
def test_train_mode_model_matches_jax(which, monkeypatch):
    name, geo, inputs = _models()[which]
    jmodel, params, port = _train_pair(name, geo, geo, *inputs)
    masks = _record(monkeypatch)
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, inputs),
                       deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(6)})
    # pos_drop (classifiers), then per Block the attention's probabilities,
    # its projection and the MLP; the MCA block's three after the backbone
    blocks = {"classifier": 2, "bb_mca": 3, "pretrain": 3}[which]
    assert len(masks) == (which != "pretrain") + 3 * blocks
    asked = _inject(monkeypatch, masks)
    t = [torch.from_numpy(a) for a in inputs]
    _close(port(*t), ref)
    assert len(asked) == len(masks)
    # eval: deterministic, nothing drawn
    port.eval()
    _close(port(*t), jmodel.apply({"params": params},
                                  *map(jnp.asarray, inputs)))


# --- routes ------------------------------------------------------------------


def _spy(monkeypatch) -> list:
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "flash_attention_qkv",
                        spy("k1", layers.flash_attention_qkv))
    monkeypatch.setattr(layers, "flash_attention_mh",
                        spy("k3", layers.flash_attention_mh))
    monkeypatch.setattr(attention, "flash_attention",
                        spy("k4", attention.flash_attention))
    return calls


@pytest.mark.parametrize("case,train,want", [
    ("plain", False, "k1"), ("plain", True, "k1"), ("drop", False, "k1"),
    ("drop", True, "plain"), ("proj_drop", True, "k1"),
    ("bias", False, "plain"), ("sow", False, "k4"),
])
def test_attention_routes(case, train, want, monkeypatch):
    """A = 128 at 128 tokens: K1/K2 unless a bias, active attention
    dropout or sowing; sowing keeps the probabilities and takes the
    head-major route (K4 under "auto", as mofo_tpu's dot_product_attention
    takes its kernel there)."""
    switches = {"drop": dict(attn_drop=RATE),
                "proj_drop": dict(proj_drop=RATE),
                "sow": dict(sow_attn=True)}.get(case, {})
    blk = Attention(128, 2, qkv_bias=True, **switches)
    blk.train(train)
    calls = _spy(monkeypatch)
    x = torch.randn(1, 128, 128)
    bias = torch.zeros(1, 1, 1, 128) if case == "bias" else None
    blk(x, attn_bias=bias, generator=torch.Generator().manual_seed(0))
    assert calls == ([] if want == "plain" else [want])
    assert (blk.attn_probs is not None) == (case == "sow")


@pytest.mark.parametrize("train,attn_drop,want", [
    (False, RATE, "k4"), (True, 0.0, "k4"), (True, RATE, "plain"),
])
def test_head_major_route_falls_back_under_active_dropout(
        train, attn_drop, want, monkeypatch):
    blk = Attention(64, 2, qkv_bias=True, attn_head_dim=48,
                    attn_drop=attn_drop)  # A = 96: head-major
    blk.train(train)
    calls = _spy(monkeypatch)
    blk(torch.randn(1, 128, 64), generator=torch.Generator().manual_seed(0))
    assert calls == ([] if want == "plain" else [want])
    with pytest.raises(ValueError, match="attention bias"):
        Attention(64, 2, attn_impl="pallas")(
            torch.randn(1, 8, 64), attn_bias=torch.zeros(1, 1, 1, 8))


@pytest.mark.parametrize("train,attn_drop,nx,want", [
    (False, RATE, 16, "k3"), (True, 0.0, 16, "k3"), (True, RATE, 16, "plain"),
    (False, 0.0, 12, "plain"),
])
def test_cross_attention_routes(train, attn_drop, nx, want, monkeypatch):
    ca = CrossAttention(64, 1, qkv_bias=True, attn_drop=attn_drop,
                        proj_drop=RATE)
    ca.train(train)
    calls = _spy(monkeypatch)
    mask = torch.ones(2, 16, dtype=torch.bool)
    mask[:, 5:] = False
    ca(torch.randn(2, nx, 64), torch.randn(2, 16, 64), mask,
       torch.Generator().manual_seed(0))
    assert calls == ([] if want == "plain" else [want])


def test_cross_attention_plain_route_equals_k3():
    """At rate 0 in train mode the plain head-major math with the -inf
    bias (the route active dropout takes) gives what K3's plain version
    gives."""
    ca = CrossAttention(64, 2, qkv_bias=True, attn_drop=0.0)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(2, 16, 64, generator=g), torch.randn(2, 16, 64,
                                                            generator=g)
    mask = torch.rand(2, 16, generator=g) < 0.5
    mask[:, 0] = True
    via_k3 = ca(x, y, mask)
    ca.attn_drop = 1e-30  # active, but keeps every entry at this draw
    plain = ca.train()(x, y, mask, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(plain.detach().numpy(),
                               via_k3.detach().numpy(), atol=1e-5, rtol=0)


# --- data parallelism and the CLI ---------------------------------------------


DDP_TASK = textwrap.dedent("""
    import os, sys
    import torch
    sys.path.insert(0, {tests!r})
    import torch_ddp_worker as W
    from mofo_tpu_torch.core import distributed
    from mofo_tpu_torch.tools import main_path as mp
    out = sys.argv[1]
    torch.set_num_threads(1)
    distributed.init_distributed_mode(
        verbose=False, device="cpu",
        init_method="file://" + os.path.join(out, "store"))
    rank, world = distributed.process_index(), distributed.process_count()
    try:
        B, k = W.FINETUNE_BK[world]
        model = W.create_model(W.BB, device="cpu", seed=4, drop_rate=0.1,
                               attn_drop_rate=0.1, **W.BB_GEO)
        got = mp.finetune_steps(
            model, W.finetune_cfg(B, k),
            mp.rank_batch(W.u8_batch(world * B, labels=True), rank, world, k),
            W.STEPS, wrap=True, augment=True)
        torch.save(got, os.path.join(out, f"dropout-{{rank}}.pt"))
    finally:
        distributed.destroy()
""")


def test_dropout_finetune_step_equals_one_process(tmp_path):
    """W = 2 ranks (local batch 4, update_freq 2) with dropout 0.1 and
    attention dropout 0.1 (the plain head-major route), drop path 0.1 and
    the train augmentation: every mask is drawn at the global count, so
    each rank computes the one process's step on the global batch."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = DDP_TASK.format(tests=tests)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path)],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    W.wait(procs)
    B, k = W.FINETUNE_BK[2]
    model = W.create_model(W.BB, device="cpu", seed=4, drop_rate=RATE,
                           attn_drop_rate=RATE, **W.BB_GEO)
    want = mp.finetune_steps(model, W.finetune_cfg(2 * B, k),
                             W.u8_batch(2 * B, labels=True), W.STEPS,
                             augment=True)
    for rank in range(2):
        got = torch.load(tmp_path / f"dropout-{rank}.pt")
        # the bounds of tests/test_torch_ddp.py's finetune step
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        for n, v in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=n)
    # dropout moved the steps: the same run without it differs
    plain = mp.finetune_steps(
        W.create_model(W.BB, device="cpu", seed=4, **W.BB_GEO),
        W.finetune_cfg(2 * B, k), W.u8_batch(2 * B, labels=True), 1,
        augment=True)
    assert plain["loss"][0] != want["loss"][0]


def test_finetune_cli_runs_dropout(tmp_path, capsys):
    argv = ["--model", "vit_tiny_debug", "--synthetic", "4", "--batch_size",
            "2", "--input_size", "32", "--num_frames", "4", "--nb_classes",
            "3", "--epochs", "1", "--warmup_epochs", "0", "--decode_height",
            "48", "--decode_width", "64", "--dtype", "float32", "--drop",
            "0.1", "--attn_drop_rate", "0.1", "--device", "cpu",
            "--output_dir", str(tmp_path)]
    state = FT.main(FT.get_args(argv))
    assert state.step == 2
    assert capsys.readouterr().out.count("Final test: Acc@1") == 1
