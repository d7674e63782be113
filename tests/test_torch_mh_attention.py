"""The port's masked multihead attention (K3) against the JAX package's
Pallas kernel.

On the CPU, mofo_tpu_torch.ops.flash_attention.flash_attention_mh runs the
plain PyTorch versions of its CUDA kernels (mh_attn_fwd, mh_attn_bwd_dkv,
mh_attn_bwd_dq); here they are held against
mofo_tpu.ops.flash_attention.flash_attention_mh(..., kv_bias=,
interpret=True), which runs the TPU kernel K3 (_mh_fwd_impl / _mh_fwd_kernel
with has_bias, _mh_bwd_impl / _mh_dqkv_kernel), forward and gradients of
sum(out^2), at the head dims the CUDA kernels take: 64, and 256 (the ViT-B
MCA, 3 x 256). The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path

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


def _jax_run(q, k, v, kv_bias, H, D, dtype):
    bias = None if kv_bias is None else jnp.asarray(kv_bias)

    def fwd(q, k, v):
        return jax_mh(q, k, v, scale=D ** -0.5, num_heads=H, kv_bias=bias,
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
    the bias ignored, a zeroed dQ and a dK without its 1/log2(e) fix."""
    q, k, v, b = main_path.mh_inputs(2, 100, 1, 256, dtype, 6, "cpu")
    got, want = main_path.mh_attention_against_plain(q, k, v, b, 1, 0.0625)
    res = main_path.check_against_plain(got, want)
    assert set(res["max_abs_err"].values()) == {0.0}
    assert main_path.masked_kv_grad(got, b) == 0.0
    no_bias, _ = main_path.mh_attention_against_plain(q, k, v, None, 1,
                                                      0.0625)
    faults = main_path.planted_faults(got, no_bias)
    assert set(faults) == {"dq_zero", "dk_without_fix", "bias_ignored"}
    for outputs in faults.values():
        with pytest.raises(AssertionError, match="beyond the bounds"):
            main_path.check_against_plain(outputs, want)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2 * 32)
    with pytest.raises(ValueError, match="head dim"):
        fa._check_mh(q, q, q, None, 2)
    q = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_mh(q, q, q, None, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.mh_attn_bwd_dq(q, q, q, None, q, q, q, q, 1.0, 2)
    with pytest.raises(ValueError, match="kv_bias"):
        fa.flash_attention_mh(q, q, q, scale=1.0, num_heads=2,
                              kv_bias=torch.zeros(1, 9))
    assert fa.MH_KERNELS == ("mh_attn_fwd", "mh_attn_bwd_dkv",
                             "mh_attn_bwd_dq")
    assert set(fa.MH_KERNELS) <= set(fa.launch_counts)


def test_build_lists_both_sources():
    from mofo_tpu_torch.ops import _build

    assert _build.SOURCES == ("qkv_flash_attention.cu",
                              "mh_flash_attention.cu")
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)
    assert set(fa.KERNELS) == set(_build.SIGNATURES)
