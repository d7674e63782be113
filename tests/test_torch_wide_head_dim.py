"""Head dims above 256 against the JAX package, on the CPU.

mofo_tpu's attention kernels take any head dim D. Above 256 the port's
CUDA kernels are the column-split ones (csrc/wgmma_attn_split.cuh,
wgmma_tf32_split.cuh), which take any multiple of 64: on the card the
public entry points zero-pad any other D to the next multiple of 64
(head_dim_width: 264 -> 320, 341 -> 384) and slice the results back. Here,
on the CPU:

  - the plain versions of K1/K2, K3 (with a 0 / -1e30 kv bias) and K4 at
    D from 264 to 1024 against mofo_tpu's kernels in interpret mode,
    forward and the gradients of sum(out^2), with the bounds of
    tests/test_torch_any_head_dim.py: f32 out within 2e-5 and gradients
    within 1e-4 (sums in another order); bf16 the loss within rtol 5e-3
    and gradients within atol = rtol = 3e-2 (tests/test_tpu_kernels.py:
    251-254);
  - the padding itself: pad, the plain version at the padded width, slice,
    against the plain version at D, in f32 within 1e-6 (zero columns add
    exact zeros), for the three families at 264 -> 320 and 341 -> 384, and
    the public entry points' padding route with the card's widths: the
    kernels get the caller's scale D^-0.5, and a D that is its own width
    takes no pad copy;
  - the BB-focused model at one Block, f32, with an MCA of 2 and 1 heads at
    ViT-B width (K3 at 384 and 768) and of 3 heads at ViT-L's (embed_dim
    1024, 16 heads: K3 at 341, padded to 384 on the card), against
    mofo_tpu with its weights carried into the port (params_from_jax), with
    tests/test_torch_large_presets.py's bounds.

The kernels themselves run on the card only (chip_smoke.py's
wide_head_dims and wide_head_dim_steps; tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops.flash_attention import flash_attention as jax_hm
from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_qkv
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.train.checkpoint import params_from_jax

QKV_CASES = [(264, 2), (341, 3), (512, 1)]  # (D, H) of K1/K2
MH_CASES = [(341, 3), (384, 2), (768, 1), (1024, 1)]  # (D, H) of K3
HM_DIMS = [320, 512]  # K4
N = 130  # past one 128-row tile of the TPU kernels
N_CLASSES = 7
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


def _jax_run(fn, args, dtype):
    """(out, loss, grads) of loss = sum(out^2) through mofo_tpu's kernel."""
    def loss(*xs):
        out = fn(*xs)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    xs = [jnp.asarray(a).astype(dtype) for a in args]
    (value, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(xs))), has_aux=True))(*xs)
    return _f32(out), float(value), [_f32(g) for g in grads]


def _port_run(fn, args, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in args]
    out = fn(*ts)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return (out.detach().float().numpy(), float(loss.detach()),
            [t.grad.float().numpy() for t in ts])


def _close(port, ref, dtype):
    (p_out, p_loss, p_grads), (j_out, j_loss, j_grads) = port, ref
    if dtype == "float32":
        np.testing.assert_allclose(p_out, j_out, atol=2e-5, rtol=0)
        for p, j in zip(p_grads, j_grads):
            np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(p_loss, j_loss, rtol=5e-3)
        for p, j in zip(p_grads, j_grads):
            np.testing.assert_allclose(p, j, atol=3e-2, rtol=3e-2)


def _randn(seed, *shapes, std=1.0):
    rng = np.random.RandomState(seed)
    return [(std * rng.randn(*s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,H", QKV_CASES)
def test_qkv_matches_tpu_kernels(D, H, dtype):
    """K1/K2's plain versions at D against mofo_tpu's flash_attention_qkv
    (_qkv_fwd_impl, _qkv_bwd_impl) in interpret mode."""
    (x,) = _randn(D + H, (1, N, 3 * H * D))
    scale = D ** -0.5
    ref = _jax_run(lambda a: jax_qkv(a, scale=scale, num_heads=H,
                                     interpret=True), [x], getattr(jnp, dtype))
    port = _port_run(lambda a: fa.flash_attention_qkv(
        a, scale=scale, num_heads=H), [x], getattr(torch, dtype))
    assert port[2][0].shape == (1, N, 3 * H * D)
    _close(port, ref, dtype)


def _mh_inputs(D, H, seed):
    """q, k, v (std 0.5, B = 2, N = 70) and a 0 / -1e30 kv bias row in
    which sample 0 keeps one valid column."""
    q, k, v = _randn(seed, *[(2, 70, H * D)] * 3, std=0.5)
    valid = np.random.RandomState(seed + 1).rand(2, 70) < 0.6
    valid[0] = False
    valid[0, 23] = True
    return q, k, v, np.where(valid, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,H", MH_CASES)
def test_mh_with_bias_matches_tpu_kernel(D, H, dtype):
    """K3's plain versions at D with the kv bias against mofo_tpu's
    flash_attention_mh (_mh_fwd_impl, _mh_bwd_impl) in interpret mode, at
    the BB-focused MCA's head dims (341 at ViT-L width, 384 and 768 at
    ViT-B's) and 1024; masked kv rows get exactly zero dK and dV."""
    q, k, v, bias = _mh_inputs(D, H, D)
    scale = D ** -0.5
    ref = _jax_run(lambda *a: jax_mh(*a, scale=scale, num_heads=H,
                                     kv_bias=jnp.asarray(bias),
                                     interpret=True),
                   [q, k, v], getattr(jnp, dtype))
    port = _port_run(lambda *a: fa.flash_attention_mh(
        *a, scale=scale, num_heads=H, kv_bias=torch.from_numpy(bias)),
        [q, k, v], getattr(torch, dtype))
    _close(port, ref, dtype)
    masked = bias != 0
    assert not port[2][1][masked].any() and not port[2][2][masked].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", HM_DIMS)
def test_hm_matches_tpu_kernel(D, dtype):
    """K4's plain versions at D (B = 1, H = 2) against mofo_tpu's
    flash_attention (_fwd_impl, _bwd_impl) in interpret mode."""
    x = _randn(D, *[(1, 2, N, D)] * 3)
    scale = D ** -0.5
    ref = _jax_run(lambda *a: jax_hm(*a, scale=scale, interpret=True), x,
                   getattr(jnp, dtype))
    port = _port_run(lambda *a: fa.flash_attention(*a, scale=scale), x,
                     getattr(torch, dtype))
    _close(port, ref, dtype)


# --- the padding ------------------------------------------------------------


def _padded_against_plain(family, D, H):
    """(got, want, padded columns): a family's plain versions at the padded
    width W on zero-padded inputs, outputs sliced back, and at D, each
    (out, lse, gradients); f32, the caller's scale D^-0.5, the gradients of
    sum(out^2) (dout = 2 out); and the padded columns of the output at W."""
    W, scale = fa.head_dim_width(D), D ** -0.5
    if family == "qkv":
        (qkv,) = (torch.from_numpy(a) for a in _randn(D, (2, N, 3 * H * D)))
        xs, groups, heads = (qkv,), fa.QKV_GROUPS, H
        fwd, bwd = fa.attention_qkv_fwd_plain, fa.attention_qkv_bwd_plain
        args = (scale, H)
    elif family == "mh":
        xs = tuple(torch.from_numpy(a) for a in _mh_inputs(D, H, D))
        groups, heads = fa.MH_GROUPS, H
        fwd, bwd = fa.attention_mh_fwd_plain, fa.attention_mh_bwd_plain
        args = (scale, H)
    else:
        xs = tuple(torch.from_numpy(a) for a in _randn(D, *[(3, N, D)] * 3))
        groups, heads = fa.HM_GROUPS, 1
        fwd, bwd = fa.attention_hm_fwd_plain, fa.attention_hm_bwd_plain
        args = (scale,)
    out, lse = fwd(*xs, *args)
    dout = 2 * out
    want = (out, lse, bwd(*xs, out, lse, dout, *args))
    xs_w = tuple(fa.pad_head_dim(x, g * heads, D, W) if g else x
                 for x, g in zip(xs, groups))
    out_w, lse_w = fwd(*xs_w, *args)
    grads_w = bwd(*xs_w, out_w, lse_w, fa.pad_head_dim(dout, heads, D, W),
                  *args)
    one = isinstance(grads_w, torch.Tensor)
    grads = tuple(fa.unpad_head_dim(g, n * heads, W, D) for g, n in zip(
        (grads_w,) if one else grads_w, (n for n in groups if n)))
    got = (fa.unpad_head_dim(out_w, heads, W, D), lse_w,
           grads[0] if one else grads)
    return got, want, out_w.reshape(*out_w.shape[:-1], heads, W)[..., D:]


@pytest.mark.parametrize("family", ["qkv", "mh", "hm"])
@pytest.mark.parametrize("D,H", [(264, 2), (341, 3)])
def test_padding_to_a_multiple_of_64_is_exact(family, D, H):
    """pad_head_dim to the column-split kernels' width (264 -> 320,
    341 -> 384), the plain version there with the caller's scale, then
    unpad_head_dim, against the plain version at D (f32, 1e-6); the padded
    output columns are exactly zero."""
    assert fa.head_dim_width(D) == {264: 320, 341: 384}[D]
    (out, lse, grads), (w_out, w_lse, w_grads), pad_cols = \
        _padded_against_plain(family, D, H)
    got = [out, lse] + ([grads] if isinstance(grads, torch.Tensor)
                        else list(grads))
    want = [w_out, w_lse] + ([w_grads] if isinstance(w_grads, torch.Tensor)
                             else list(w_grads))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
    assert not pad_cols.any()


_CALLS = {"qkv_attn_fwd": 1, "qkv_attn_bwd": 4, "mh_attn_fwd": 4,
          "mh_attn_bwd": 7, "hm_attn_fwd": 3, "hm_attn_bwd": 6}


def _card_route(monkeypatch):
    """The public entry points' padding on CPU tensors: kernel_width gives
    the card's answer, and each autograd function's wrappers record what
    they are handed (the last dim of their first tensor and the scale) and
    run their plain versions, as on the CPU. Returns the records and the
    pad copies made (heads, D, width)."""
    seen, pads = [], []
    monkeypatch.setattr(fa, "kernel_width",
                        lambda x, D: fa.head_dim_width(D))
    pad = fa.pad_head_dim

    def counted_pad(x, heads, D, width):
        if width != D:
            pads.append((heads, D, width))
        return pad(x, heads, D, width)

    monkeypatch.setattr(fa, "pad_head_dim", counted_pad)
    for name, at in _CALLS.items():
        def spy(*args, _fn=getattr(fa, name), _name=name, _at=at):
            seen.append((_name, args[0].shape[-1], args[_at]))
            return _fn(*args)
        monkeypatch.setattr(fa, name, spy)
    return seen, pads


def _three_routes(D, H):
    """Each public entry point's out and input gradients of sum(out^2) at
    head dim D (f32) and the caller's scale D^-0.5."""
    scale = D ** -0.5
    (qkv,) = _randn(D, (1, N, 3 * H * D))
    q, k, v, _ = _mh_inputs(D, H, D)
    hm = _randn(D + 1, *[(1, H, N, D)] * 3)
    runs = {
        "qkv": ([qkv], lambda a: fa.flash_attention_qkv(
            a, scale=scale, num_heads=H)),
        "mh": ([q, k, v], lambda *a: fa.flash_attention_mh(
            *a, scale=scale, num_heads=H)),
        "hm": (hm, lambda *a: fa.flash_attention(*a, scale=scale)),
    }
    return {name: _port_run(fn, args, torch.float32)
            for name, (args, fn) in runs.items()}


@pytest.mark.parametrize("D,H,copies", [(264, 2, 10), (341, 1, 10),
                                        (320, 2, 0), (768, 1, 0)])
def test_padding_route_above_256(D, H, copies, monkeypatch):
    """On the card's route each public entry point runs D at its width
    (the next multiple of 64), its wrappers get the caller's scale, the
    pad copies are the forwards' inputs (qkv; q, k, v; K4's q, k, v) and
    each backward's dout at a D that is not its own width and none at one
    that is, and out and gradients equal the plain versions' at D."""
    want = _three_routes(D, H)
    seen, pads = _card_route(monkeypatch)
    got = _three_routes(D, H)
    W = fa.head_dim_width(D)
    widths = {"qkv": 3 * H * W, "mh": H * W, "hm": W}
    assert {(name, width) for name, width, _ in seen} == {
        (name, widths[name[:name.index("_")]]) for name in _CALLS}
    assert all(scale == D ** -0.5 for _, _, scale in seen)
    assert len(pads) == copies
    for name in want:
        for g, w in zip([got[name][0]] + got[name][2],
                        [want[name][0]] + want[name][2]):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


# --- the models ---------------------------------------------------------------


# label -> the MCA's heads and the model's width (embed_dim, backbone
# heads): its head dim is embed_dim // heads (384 and 768 at ViT-B width,
# 341 at ViT-L's: A = 1023, padded to 3 x 384 on the card)
MODELS = {"bb_mca_2_heads": (2, 768, 12), "bb_mca_1_head": (1, 768, 12),
          "bb_vitl_mca_3_heads": (3, 1024, 16)}
BB_MODEL = "vit_base_patch16_224_BB_focused"


@pytest.mark.parametrize("label", sorted(MODELS))
def test_model_at_one_block_matches_jax(label):
    """The model cut to one Block, 2 frames (196 tokens), B = 1, f32, with
    mofo_tpu's initial weights carried into the port (params_from_jax):
    cross entropy on a fixed label and every gradient (carried the same
    way) against mofo_tpu's."""
    heads, width, backbone_heads = MODELS[label]
    kw = dict(num_classes=N_CLASSES, all_frames=2, depth=1, init_scale=1.0,
              fusing_method="MCA", mca_num_heads=heads, embed_dim=width,
              num_heads=backbone_heads)
    rng = np.random.RandomState(7)
    xy1 = rng.uniform(0, 100, (1, 2, 2))
    args = [rng.randn(1, 2, 224, 224, 3).astype(np.float32),
            np.concatenate([xy1, xy1 + 90.0], -1).astype(np.float32)]
    label_ = np.array([rng.randint(N_CLASSES)])

    jmodel = jax_create_model(BB_MODEL, attn_impl="xla", **kw)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), *map(jnp.asarray, args))["params"])
    port = create_model(BB_MODEL, device="cpu", **kw)
    port.load_state_dict(params_from_jax(params), strict=True)
    head_dim = port.local_MCA[0].attn.head_dim
    assert head_dim == width // heads and fa.head_dim_width(head_dim) == {
        2: 384, 1: 768, 3: 384}[heads]

    logits = port(*map(torch.from_numpy, args))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(label_))
    loss.backward()

    def jloss(p):
        out = jmodel.apply({"params": p}, *map(jnp.asarray, args))
        logp = jax.nn.log_softmax(out.astype(jnp.float32))
        return -jnp.take_along_axis(logp, jnp.asarray(label_)[:, None],
                                    axis=-1).mean()

    ref, grads = jax.jit(jax.value_and_grad(jloss))(params)
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=LOSS_RTOL)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert set(named) <= set(ref_grads)
    for n, p in named.items():
        want = np.asarray(ref_grads[n])
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max() + 1e-12, (
            n, err, np.abs(want).max())
