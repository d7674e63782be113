"""Every head dim up to 256 against the JAX package, on the CPU.

mofo_tpu's attention kernels take any head dim D; the port's CUDA kernels
are built for HEAD_DIMS = (16, 32, 64, 128, 192, 256), and on the card its
public entry points zero-pad any other D up to 256 to the next of them
(head_dim_width, pad_head_dim) and slice the results back
(unpad_head_dim). Here, on the CPU:

  - the plain versions of K1/K2, K3 (with a 0 / -1e30 kv bias) and K4 at
    built and unbuilt D against mofo_tpu's kernels in interpret mode,
    forward and the gradients of sum(out^2), with the bounds of
    tests/test_torch_flat_head_dims.py: f32 out within 2e-5 and gradients
    within 1e-4 (sums in another order); bf16 the loss within rtol 5e-3
    and gradients within atol = rtol = 3e-2 (tests/test_tpu_kernels.py:
    251-254);
  - the padding itself: pad, the plain version at the padded width, slice,
    against the plain version at D, in f32 within 1e-6 (zero columns add
    exact zeros; the products' sums may split differently), and the public
    entry points' padding route, run on the CPU by giving kernel_width the
    card's answer: the scale the kernels get is the caller's, and a built D
    takes no pad copy;
  - the ViT-B BB-focused model at one Block, f32, with an MCA of 8, 16
    and 4 heads (mca_num_heads, a create_model keyword of both packages:
    K3 at head dims 96 and 48, padded to 128 and 64 on the card, and at
    192, built), against mofo_tpu with its weights carried into the port
    (train.checkpoint.params_from_jax, as tests/test_torch_classifier.py
    carries them), with tests/test_torch_large_presets.py's bounds.

The kernels themselves run on the card only (chip_smoke.py's
qkv_head_dims, mh_head_dims, hm_head_dims and any_head_dim_steps;
tests/test_torch_gpu.py).
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

# (D, H) of K1/K2: head dims that pad (8, 24, 48, 80, 96) and built ones
# above 128 (192, 256), A = H * D
QKV_CASES = [(8, 16), (24, 16), (48, 8), (80, 8), (96, 4), (192, 2),
             (256, 1)]
MH_CASES = [(16, 4), (32, 2), (128, 2), (192, 1)]  # (D, H) of K3
HM_DIMS = [8, 48, 80, 128, 192, 256]  # K4
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
    flash_attention_mh (_mh_fwd_impl, _mh_bwd_impl) in interpret mode;
    masked kv rows get exactly zero dK and dV."""
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


def test_head_dim_width_rounds_up_to_a_built_head_dim():
    assert [fa.head_dim_width(d) for d in (1, 8, 16, 17, 48, 64, 80, 96,
                                           128, 129, 192, 200, 256)] == [
        16, 16, 16, 32, 64, 64, 128, 128, 128, 192, 192, 256, 256]
    for d in fa.HEAD_DIMS:
        assert fa.head_dim_width(d) == d
    with pytest.raises(ValueError, match="head dim 0 unsupported"):
        fa.head_dim_width(0)
    # above 256: the next multiple of 64 (the column-split kernels' boxes)
    assert [fa.head_dim_width(d) for d in (257, 341, 512)] == [320, 384, 512]


def _qkv_padded_plain(qkv, H, D, W, scale, dout):
    """K1/K2's plain versions at width W on zero-padded qkv and dout,
    outputs sliced back: (out, lse, dqkv)."""
    x = fa.pad_head_dim(qkv, 3 * H, D, W)
    out_w, lse = fa.attention_qkv_fwd_plain(x, scale, H)
    dqkv = fa.attention_qkv_bwd_plain(x, out_w, lse,
                                      fa.pad_head_dim(dout, H, D, W),
                                      scale, H)
    return (fa.unpad_head_dim(out_w, H, W, D), lse,
            fa.unpad_head_dim(dqkv, 3 * H, W, D))


@pytest.mark.parametrize("D,H", [(8, 4), (48, 8), (96, 4), (200, 1)])
def test_qkv_padding_is_exact(D, H):
    """pad_head_dim, the plain K1/K2 at the next built width, then
    unpad_head_dim, against the plain versions at D (f32, 1e-6); the
    padded columns of the output and of dqkv are exactly zero."""
    W = fa.head_dim_width(D)
    qkv, dout = (torch.from_numpy(a) for a in _randn(
        D, (2, N, 3 * H * D), (2, N, H * D)))
    scale = D ** -0.5
    out, lse = fa.attention_qkv_fwd_plain(qkv, scale, H)
    dqkv = fa.attention_qkv_bwd_plain(qkv, out, lse, dout, scale, H)
    p_out, p_lse, p_dqkv = _qkv_padded_plain(qkv, H, D, W, scale, dout)
    for got, want in ((p_out, out), (p_lse, lse), (p_dqkv, dqkv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
    x = fa.pad_head_dim(qkv, 3 * H, D, W)
    out_w, _ = fa.attention_qkv_fwd_plain(x, scale, H)
    assert not out_w.reshape(2, N, H, W)[..., D:].any()


@pytest.mark.parametrize("D,H", [(16, 4), (48, 2), (100, 2), (160, 1)])
def test_mh_padding_is_exact(D, H):
    W = fa.head_dim_width(D)
    q, k, v, bias = (torch.from_numpy(a) for a in _mh_inputs(D, H, D))
    (dout,) = (torch.from_numpy(a) for a in _randn(1, (2, 70, H * D)))
    scale = D ** -0.5
    out, lse = fa.attention_mh_fwd_plain(q, k, v, bias, scale, H)
    grads = fa.attention_mh_bwd_plain(q, k, v, bias, out, lse, dout, scale,
                                      H)
    pad = lambda t: fa.pad_head_dim(t, H, D, W)  # noqa: E731
    unpad = lambda t: fa.unpad_head_dim(t, H, W, D)  # noqa: E731
    out_w, lse_w = fa.attention_mh_fwd_plain(pad(q), pad(k), pad(v), bias,
                                             scale, H)
    grads_w = fa.attention_mh_bwd_plain(pad(q), pad(k), pad(v), bias, out_w,
                                        lse_w, pad(dout), scale, H)
    for got, want in zip([unpad(out_w), lse_w] + [unpad(g) for g in grads_w],
                         [out, lse, *grads]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("D", [8, 80, 200])
def test_hm_padding_is_exact(D):
    W = fa.head_dim_width(D)
    q, k, v, dout = (torch.from_numpy(a) for a in _randn(
        D, *[(3, N, D)] * 4))
    scale = D ** -0.5
    out, lse = fa.attention_hm_fwd_plain(q, k, v, scale)
    grads = fa.attention_hm_bwd_plain(q, k, v, out, lse, dout, scale)
    pad = lambda t: fa.pad_head_dim(t, 1, D, W)  # noqa: E731
    unpad = lambda t: fa.unpad_head_dim(t, 1, W, D)  # noqa: E731
    out_w, lse_w = fa.attention_hm_fwd_plain(pad(q), pad(k), pad(v), scale)
    grads_w = fa.attention_hm_bwd_plain(pad(q), pad(k), pad(v), out_w,
                                        lse_w, pad(dout), scale)
    for got, want in zip([unpad(out_w), lse_w] + [unpad(g) for g in grads_w],
                         [out, lse, *grads]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)


_WRAPPERS = ("qkv_attn_fwd", "qkv_attn_bwd", "mh_attn_fwd", "mh_attn_bwd",
             "hm_attn_fwd", "hm_attn_bwd")


def _width(wrapper: str, H: int, D: int) -> int:
    """The last dim of a wrapper's first tensor at H heads of head dim D."""
    return {"qkv": 3 * H * D, "mh": H * D, "hm": D}[wrapper[:wrapper.index(
        "_")]]


def _card_route(monkeypatch):
    """The public entry points' padding on CPU tensors: kernel_width gives
    the card's answer, and each autograd function's wrappers record what
    they are handed (then run their plain versions, as on the CPU).
    Returns the records: (wrapper, last dim of its first tensor, scale,
    that tensor's data pointer) and the pad copies made."""
    seen, pads = [], []
    monkeypatch.setattr(fa, "kernel_width",
                        lambda x, D: fa.head_dim_width(D))
    pad = fa.pad_head_dim

    def counted_pad(x, heads, D, width):
        if width != D:
            pads.append((heads, D, width))
        return pad(x, heads, D, width)

    monkeypatch.setattr(fa, "pad_head_dim", counted_pad)
    for name, at in (("qkv_attn_fwd", 1), ("qkv_attn_bwd", 4),
                     ("mh_attn_fwd", 4), ("mh_attn_bwd", 7),
                     ("hm_attn_fwd", 3), ("hm_attn_bwd", 6)):
        def spy(*args, _fn=getattr(fa, name), _name=name, _at=at):
            seen.append((_name, args[0].shape[-1], args[_at],
                         args[0].data_ptr()))
            return _fn(*args)
        monkeypatch.setattr(fa, name, spy)
    return seen, pads


def _three_routes(D, H, dtype=torch.float32):
    """Each public entry point's out and input gradients, sum(out^2), at
    head dim D and the caller's scale D^-0.5; and the inputs."""
    scale = D ** -0.5
    qkv, q, k, v, _ = (
        torch.from_numpy(a) for a in (*_randn(D, (1, N, 3 * H * D)),
                                      *_mh_inputs(D, H, D)))
    hm = [torch.from_numpy(a) for a in _randn(D + 1, *[(1, H, N, D)] * 3)]
    runs = {
        "qkv": ([qkv], lambda a: fa.flash_attention_qkv(
            a, scale=scale, num_heads=H)),
        # no bias here: a row that keeps one kv column makes dP - delta
        # cancel to f32 noise, which the order of the sums then sets
        "mh": ([q, k, v], lambda *a: fa.flash_attention_mh(
            *a, scale=scale, num_heads=H)),
        "hm": (hm, lambda *a: fa.flash_attention(*a, scale=scale)),
    }
    out = {}
    for name, (args, fn) in runs.items():
        ts = [t.to(dtype).contiguous().requires_grad_(True) for t in args]
        o = fn(*ts)
        (o.float() ** 2).sum().backward()
        out[name] = ([t.data_ptr() for t in ts], o.detach(),
                     [t.grad for t in ts])
    return out


@pytest.mark.parametrize("D,H", [(48, 2), (100, 2), (200, 1)])
def test_padding_route_keeps_the_callers_scale(D, H, monkeypatch):
    """On the card's route (kernel_width patched to head_dim_width) each
    public entry point pads D to its width, its wrappers get the caller's
    scale D^-0.5 (not the width's), and the out and gradients equal the
    plain versions' at D (f32, 1e-6); the width's own scale would not."""
    want = _three_routes(D, H)
    seen, pads = _card_route(monkeypatch)
    got = _three_routes(D, H)
    W = fa.head_dim_width(D)
    assert {(name, width) for name, width, _, _ in seen} == {
        (name, _width(name, H, W)) for name in _WRAPPERS}
    assert all(scale == D ** -0.5 for _, _, scale, _ in seen)
    # the forwards' inputs (qkv; q, k, v; K4's q, k, v), each backward's dout
    assert len(pads) == (1 + 1) + (3 + 1) + (3 + 1)
    for name in want:
        _, w_out, w_grads = want[name]
        _, g_out, g_grads = got[name]
        for g, w in zip([g_out] + g_grads, [w_out] + w_grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                       rtol=0)
    # the width's scale is another function: the check above can see it
    qkv = torch.from_numpy(_randn(D, (1, N, 3 * H * D))[0])
    x = fa.pad_head_dim(qkv, 3 * H, D, W)
    wrong, _ = fa.attention_qkv_fwd_plain(x, W ** -0.5, H)
    assert (fa.unpad_head_dim(wrong, H, W, D) - want["qkv"][1]).abs().max() \
        > 1e-3


@pytest.mark.parametrize("D,H", [(16, 4), (64, 2), (128, 1), (192, 1),
                                 (256, 1)])
def test_a_built_head_dim_takes_no_pad(D, H, monkeypatch):
    """At a built D the card's route makes no pad copy: each autograd
    function gets the caller's own tensors (the same storage), at D."""
    seen, pads = _card_route(monkeypatch)
    got = _three_routes(D, H)
    assert pads == []
    assert {(name, width) for name, width, _, _ in seen} == {
        (name, _width(name, H, D)) for name in _WRAPPERS}
    inputs = {name: ptrs for name, (ptrs, _, _) in got.items()}
    fwd = {name: ptr for name, _, _, ptr in seen if name.endswith("fwd")}
    assert fwd["qkv_attn_fwd"] == inputs["qkv"][0]
    assert fwd["mh_attn_fwd"] == inputs["mh"][0]
    assert fwd["hm_attn_fwd"] == inputs["hm"][0]


# --- the models ---------------------------------------------------------------


# label -> the MCA's heads; its head dim is 768 / heads (96 and 48 pad on
# the card, 192 is built); the backbone's Blocks take the flat route
MODELS = {"bb_mca_8_heads": 8, "bb_mca_16_heads": 16, "bb_mca_4_heads": 4}
BB_MODEL = "vit_base_patch16_224_BB_focused"


@pytest.mark.parametrize("label", sorted(MODELS))
def test_model_at_one_block_matches_jax(label):
    """The model at ViT-B width cut to one Block, 2 frames (196 tokens),
    B = 1, f32, with mofo_tpu's initial weights carried into the port
    (params_from_jax): cross entropy on a fixed label and every gradient
    (carried the same way) against mofo_tpu's."""
    heads = MODELS[label]
    kw = dict(num_classes=N_CLASSES, all_frames=2, depth=1, init_scale=1.0,
              fusing_method="MCA", mca_num_heads=heads)
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
    assert port.backbone.blocks[0].attn.uses_flat(196)
    assert port.local_MCA[0].attn.head_dim == 768 // heads

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
