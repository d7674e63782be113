"""The port's masked multihead attention (K3) against the JAX package's
Pallas kernel.

On the CPU, mofo_tpu_torch.ops.flash_attention.flash_attention_mh runs the
plain PyTorch versions of its CUDA kernels (mh_attn_fwd, mh_attn_bwd_prep,
mh_attn_bwd_dkv, mh_attn_bwd_dq); here they are held against
mofo_tpu.ops.flash_attention.flash_attention_mh(..., kv_bias=,
interpret=True), which runs the TPU kernel K3 (_mh_fwd_impl / _mh_fwd_kernel
with has_bias, _mh_bwd_impl / _mh_dqkv_kernel), forward and gradients of
sum(out^2), at the head dims the CUDA kernels take: 64, and 256 (the ViT-B
MCA, 3 x 256). The bf16 backward on the card is a prep pass and two
kernels; their plain versions together (attention_mh_bwd_prep_plain, then
attention_mh_bwd_from_prep_plain) are held here against the whole plain
backward bit for bit, and against the interpret-mode K3 backward. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


GEOMS = [(N, H, D) for N in (16, 37, 128)
         for H, D in ((2, 64), (1, 256), (3, 256))]


def _inputs(N, H, D, bias, B=2, seed=0):
    """q, k, v (std 0.5) and a 0 / -1e30 bias row in which sample 0 keeps
    one valid column."""
    rng = np.random.RandomState(seed)
    q, k, v = (0.5 * rng.randn(B, N, H * D)).astype(np.float32), \
        (0.5 * rng.randn(B, N, H * D)).astype(np.float32), \
        (0.5 * rng.randn(B, N, H * D)).astype(np.float32)
    kv_bias = None
    if bias:
        valid = rng.rand(B, N) < 0.6
        valid[0] = False
        valid[0, N // 3] = True
        kv_bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, kv_bias


def _jax_run(q, k, v, kv_bias, H, D, dtype, scale=None):
    bias = None if kv_bias is None else jnp.asarray(kv_bias)
    scale = D ** -0.5 if scale is None else scale

    def fwd(q, k, v):
        return jax_mh(q, k, v, scale=scale, num_heads=H, kv_bias=bias,
                      interpret=True)

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v).astype(jnp.float32) ** 2)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        *args)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(jax.jit(fwd)(*args)), float(value), [f32(g) for g in grads]


def _port_run(q, k, v, kv_bias, H, D, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True)
          for x in (q, k, v)]
    bias = None if kv_bias is None else torch.from_numpy(kv_bias)
    out = fa.flash_attention_mh(*ts, scale=D ** -0.5, num_heads=H,
                                kv_bias=bias)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return (out.detach().float().numpy(), float(loss.detach()),
            [t.grad.float().numpy() for t in ts])


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("N,H,D", GEOMS)
def test_f32_matches_tpu_kernel(N, H, D, bias):
    x = _inputs(N, H, D, bias)
    j_out, _, j_grads = _jax_run(*x, H, D, jnp.float32)
    p_out, _, p_grads = _port_run(*x, H, D, torch.float32)
    np.testing.assert_allclose(p_out, j_out, atol=2e-5, rtol=0)
    for p, j in zip(p_grads, j_grads):
        np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)
    if bias:  # masked kv rows get exactly zero dK and dV
        masked = x[3] != 0
        assert not p_grads[1][masked].any() and not p_grads[2][masked].any()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("N,H,D", GEOMS)
def test_bf16_matches_tpu_kernel(N, H, D, bias):
    # rtol 5e-3 on the loss value, atol/rtol 3e-2 on the gradients (the
    # bounds of tests/test_tpu_kernels.py:251-254)
    x = _inputs(N, H, D, bias, seed=1)
    _, j_loss, j_grads = _jax_run(*x, H, D, jnp.bfloat16)
    _, p_loss, p_grads = _port_run(*x, H, D, torch.bfloat16)
    np.testing.assert_allclose(p_loss, j_loss, rtol=5e-3)
    for p, j in zip(p_grads, j_grads):
        np.testing.assert_allclose(p, j, atol=3e-2, rtol=3e-2)
    if bias:
        masked = x[3] != 0
        assert not p_grads[1][masked].any() and not p_grads[2][masked].any()


def _prep_route(q, k, v, b, out, lse, dout, scale, H):
    """(dq, dk, dv) through the prep pass's plain version and the rest of
    the plain backward, as the bf16 kernels split the work on the card."""
    delta, qs, ks = fa.mh_attn_bwd_prep(q, k, out, dout, scale, H)
    return (delta, qs, ks), fa.attention_mh_bwd_from_prep_plain(
        k, v, b, lse, dout, delta, qs, ks, scale, H)


@pytest.mark.parametrize("fused_kv", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
@pytest.mark.parametrize("N", [16, 37, 128])
def test_prep_pass_then_the_rest_equals_the_plain_backward(
        N, H, D, dtype, scale, bias, fused_kv):
    """delta, q * q_scale and (head dim 64, scale 0.1) k * k_scale from the
    prep pass, then dQ, dK and dV from them: the whole plain backward bit
    for bit, with k and v as column views of a fused kv and as tensors of
    their own."""
    scale = D ** -0.5 if scale is None else scale
    q, k, v, b = main_path.mh_inputs(2, N, H, D, dtype, N + D, "cpu", bias)
    if not fused_kv:
        k, v = k.contiguous(), v.contiguous()
    assert (k.stride(1) == 2 * H * D) == fused_kv
    out, lse = fa.attention_mh_fwd_plain(q, k, v, b, scale, H)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        N)).to(dtype)
    (delta, qs, ks), got = _prep_route(q, k, v, b, out, lse, dout, scale, H)
    want = fa.attention_mh_bwd_plain(q, k, v, b, out, lse, dout, scale, H)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert delta.shape == (2, H, N) and delta.dtype == torch.float32
    assert torch.equal(delta, fa.mh_delta(out, dout, H))
    assert qs.dtype == dtype and qs.shape == q.shape
    # the copy exists only where a kernel reads it (module docstring)
    assert (ks is not None) == (D == 64 and scale == 0.1)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
@pytest.mark.parametrize("N", [16, 37, 128])
def test_prep_route_matches_tpu_backward(N, H, D, scale, bias):
    """The prep pass + the rest, on the port's own forward, against the
    gradients of the interpret-mode K3 kernel, f32 and bf16, to the bounds
    of test_f32_matches_tpu_kernel and test_bf16_matches_tpu_kernel."""
    x = _inputs(N, H, D, bias, seed=2)
    sc = D ** -0.5 if scale is None else scale
    for jdt, tdt, tol in ((jnp.float32, torch.float32, dict(atol=1e-4,
                                                            rtol=0)),
                          (jnp.bfloat16, torch.bfloat16, dict(atol=3e-2,
                                                              rtol=3e-2))):
        _, _, j_grads = _jax_run(*x, H, D, jdt, sc)
        q, k, v = (torch.from_numpy(t).to(tdt) for t in x[:3])
        b = None if x[3] is None else torch.from_numpy(x[3])
        out, lse = fa.attention_mh_fwd_plain(q, k, v, b, sc, H)
        dout = (2 * out.float()).to(tdt)  # the gradient of sum(out^2)
        _, grads = _prep_route(q, k, v, b, out, lse, dout, sc, H)
        for p, j in zip(grads, j_grads):
            np.testing.assert_allclose(p.float().numpy(), j, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_runs_the_plain_versions_on_cpu(dtype):
    q, k, v, b = main_path.mh_inputs(2, 37, 1, 256, dtype, 3, "cpu")
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_mh(*ts, scale=0.0625, num_heads=1, kv_bias=b)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                       ).to(dtype)
    out.backward(dout)
    p_out, lse = fa.attention_mh_fwd_plain(q, k, v, b, 0.0625, 1)
    grads = fa.attention_mh_bwd_plain(q, k, v, b, p_out, lse, dout, 0.0625,
                                      1)
    assert torch.equal(out.detach(), p_out)
    for t, g in zip(ts, grads):
        assert torch.equal(t.grad, g)
    assert lse.shape == (2, 1, 37) and lse.dtype == torch.float32


def test_bias_masks_exactly_like_dropping_the_columns():
    """Masking kv columns with -1e30 equals attention over the kept
    columns alone (f32, one sample)."""
    q, k, v, b = main_path.mh_inputs(1, 37, 2, 64, torch.float32, 5, "cpu")
    out, _ = fa.attention_mh_fwd_plain(q, k, v, b, 0.125, 2)
    keep = b[0] == 0
    ref, _ = fa.attention_mh_fwd_plain(q, k[:, keep], v[:, keep], None,
                                       0.125, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bounds_reject_planted_faults(dtype):
    """The bounds that hold the K3 kernels against their plain versions on
    the card pass the plain versions themselves (the CPU route) and reject
    the bias ignored, a zeroed dQ, a dK without its 1/log2(e) fix and a dV
    zeroed outside its peak row."""
    q, k, v, b = main_path.mh_inputs(2, 100, 1, 256, dtype, 6, "cpu")
    got, want = main_path.mh_attention_against_plain(q, k, v, b, 1, 0.0625)
    res = main_path.check_against_plain(got, want)
    assert set(res["max_abs_err"].values()) == {0.0}
    assert main_path.masked_kv_grad(got, b) == 0.0
    no_bias, _ = main_path.mh_attention_against_plain(q, k, v, None, 1,
                                                      0.0625)
    faults = main_path.planted_faults(got, no_bias)
    assert set(faults) == {"dq_zero", "dk_without_fix", "bias_ignored",
                           "dv_off_peak_row_zero"}
    for outputs in faults.values():
        with pytest.raises(AssertionError, match="beyond the bounds"):
            main_path.check_against_plain(outputs, want)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    # the launchers take a head dim that is its own width only
    # (flash_attention_mh pads 48 to 64 and 264 to 320 first); 320 is one
    q = torch.zeros(1, 8, 2 * 264)
    with pytest.raises(ValueError, match="head dim 264 .* pad it to 320"):
        fa._check_mh(q, q, q, None, 2)
    q = torch.zeros(1, 8, 2 * 320)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_mh(q, q, q, None, 2)
    q = torch.zeros(1, 8, 2 * 48)
    with pytest.raises(ValueError, match="head dim 48 has no kernel"):
        fa._check_mh(q, q, q, None, 2)
    q = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_mh(q, q, q, None, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.mh_attn_bwd_dq(q, q, q, None, q, q, q, q, 1.0, 2)
    with pytest.raises(ValueError, match="kv_bias"):
        fa.flash_attention_mh(q, q, q, scale=1.0, num_heads=2,
                              kv_bias=torch.zeros(1, 9))
    assert fa.MH_KERNELS == ("mh_attn_fwd", "mh_attn_bwd_prep",
                             "mh_attn_bwd_dkv", "mh_attn_bwd_dq")
    # the prep pass is the bf16 backward's: f32 runs mh_delta's reduction
    assert fa.MH_F32_KERNELS == ("mh_attn_fwd", "mh_attn_bwd_dkv",
                                 "mh_attn_bwd_dq")
    assert set(fa.MH_KERNELS) <= set(fa.launch_counts)


def test_build_lists_both_sources():
    from mofo_tpu_torch.ops import _build

    assert _build.SOURCES == ("qkv_flash_attention.cu",
                              "mh_flash_attention.cu",
                              "mh_flash_attention_f32.cu",
                              "hm_flash_attention.cu")
    assert all((_build.CSRC / s).exists()
               for s in _build.SOURCES + _build.HEADERS)
    assert set(fa.KERNELS) == set(_build.SIGNATURES)


def test_plain_attention_swaps_the_wrappers_and_restores_them():
    """main_path.plain_attention sends the autograd functions to the plain
    versions (the checks' bf16 step through them on the card) and puts the
    wrappers back, also after an error; no CLI module names it."""
    from pathlib import Path

    kept = {n: getattr(fa, n) for n in main_path._PLAIN}
    q, k, v, b = main_path.mh_inputs(1, 16, 1, 64, torch.float32, 8, "cpu")
    with pytest.raises(RuntimeError, match="inside"):
        with main_path.plain_attention():
            assert all(getattr(fa, n) is p
                       for n, p in main_path._PLAIN.items())
            out = fa.flash_attention_mh(q, k, v, scale=0.125, num_heads=1,
                                        kv_bias=b)
            raise RuntimeError("inside")
    assert all(getattr(fa, n) is w for n, w in kept.items())
    assert torch.equal(out, fa.attention_mh_fwd_plain(q, k, v, b, 0.125,
                                                      1)[0])
    cli = Path(fa.__file__).resolve().parent.parent / "cli"
    for path in cli.glob("*.py"):
        text = path.read_text()
        assert "plain_attention" not in text and "plain=" not in text, path
