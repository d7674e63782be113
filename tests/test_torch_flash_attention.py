"""The port's fused-qkv attention against the JAX package's Pallas kernels.

On the CPU, mofo_tpu_torch.ops.flash_attention runs the plain PyTorch
versions of its CUDA kernels; here they are held against
mofo_tpu.ops.flash_attention.flash_attention_qkv in interpret mode, which
runs the TPU kernels K1 (_qkv_fwd_impl) and K2 (_qkv_bwd_impl; the
head-inner kernel at H <= 8, the head-outer one at H = 9), forward and
gradients. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops.attention import xla_attention
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


D = 64
SCALE = D ** -0.5
# (N, H): ragged N, a 128-row case, and 9 heads (the TPU head-outer bwd)
GEOMS = [(16, 2), (37, 2), (128, 2), (37, 9)]


def _qkv(N, H, B=2, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, N, 3 * H * D).astype(np.float32)


def _jax_run(x, H, dtype):
    """(out, loss, dqkv) of loss = sum(out^2) through the TPU kernels."""
    def fwd(qkv):
        return jax_flash(qkv, scale=SCALE, num_heads=H, interpret=True)

    def loss(qkv):
        return jnp.sum(fwd(qkv).astype(jnp.float32) ** 2)

    qkv = jnp.asarray(x).astype(dtype)
    value, grad = jax.jit(jax.value_and_grad(loss))(qkv)
    out = jax.jit(fwd)(qkv)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(out), float(value), f32(grad)


def _port_run(x, H, dtype):
    qkv = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=H)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return (out.detach().float().numpy(), float(loss.detach()),
            qkv.grad.float().numpy())


@pytest.mark.parametrize("N,H", GEOMS)
def test_f32_matches_tpu_kernels(N, H):
    x = _qkv(N, H)
    j_out, _, j_grad = _jax_run(x, H, jnp.float32)
    p_out, _, p_grad = _port_run(x, H, torch.float32)
    np.testing.assert_allclose(p_out, j_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(p_grad, j_grad, atol=1e-4, rtol=0)


@pytest.mark.parametrize("N,H", GEOMS)
def test_bf16_matches_tpu_kernels(N, H):
    # the bounds of tests/test_tpu_kernels.py:251-254: rtol 5e-3 on the
    # loss value, atol/rtol 3e-2 on the gradients
    x = _qkv(N, H, seed=1)
    _, j_loss, j_grad = _jax_run(x, H, jnp.bfloat16)
    _, p_loss, p_grad = _port_run(x, H, torch.bfloat16)
    np.testing.assert_allclose(p_loss, j_loss, rtol=5e-3)
    np.testing.assert_allclose(p_grad, j_grad, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_runs_the_plain_versions_on_cpu(dtype):
    x = torch.from_numpy(_qkv(37, 2, seed=2)).to(dtype)
    qkv = x.clone().requires_grad_(True)
    out = fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=2)
    dout = torch.from_numpy(
        np.random.RandomState(3).randn(*out.shape).astype(np.float32)
    ).to(dtype)
    out.backward(dout)
    p_out, lse = fa.attention_qkv_fwd_plain(x, SCALE, 2)
    p_dqkv = fa.attention_qkv_bwd_plain(x, p_out, lse, dout, SCALE, 2)
    assert torch.equal(out.detach(), p_out)
    assert torch.equal(qkv.grad, p_dqkv)
    assert lse.shape == (2, 2, 37) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_units(dtype):
    """f32 keeps the LSE in natural-log units, bf16 in log2 units."""
    x = torch.from_numpy(_qkv(37, 2, seed=4)).to(dtype)
    _, lse = fa.attention_qkv_fwd_plain(x, SCALE, 2)
    q, k, _ = fa.split_heads(x.float(), 2)
    ref = torch.logsumexp(SCALE * q @ k.transpose(-1, -2), dim=-1)
    got = lse * np.log(2.0) if dtype == torch.bfloat16 else lse
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=2e-5 if dtype == torch.float32 else 5e-2)


def test_plain_matches_head_major_math():
    x = torch.from_numpy(_qkv(37, 3, seed=5))
    out, _ = fa.attention_qkv_fwd_plain(x, SCALE, 3)
    q, k, v = fa.split_heads(x, 3)
    ref = fa.merge_heads(xla_attention(q, k, v, scale=SCALE))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 3 * 2 * D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_cuda(x, 2)
    with pytest.raises(ValueError, match="qkv width"):
        fa.flash_attention_qkv(torch.zeros(1, 8, 100), scale=1.0,
                               num_heads=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bounds_reject_planted_faults(dtype):
    """The bounds that hold the kernels against their plain versions on the
    card pass the plain versions themselves (the CPU route) and reject a
    zeroed dQ and a dK without its 1/log2(e) fix."""
    x = torch.from_numpy(_qkv(100, 2, seed=6)).to(dtype)
    got, want = main_path.attention_against_plain(x, 2, SCALE)
    res = main_path.check_against_plain(got, want)
    assert set(res["max_abs_err"].values()) == {0.0}
    faults = main_path.planted_faults(got)
    assert set(faults) == {"dq_zero", "dk_without_fix"}
    for outputs in faults.values():
        bad = main_path.compare_with_plain(outputs, want)["beyond_bounds"]
        assert bad and set(bad) <= {"dq", "dk", "dq allclose 3e-2",
                                    "dk allclose 3e-2"}
        with pytest.raises(AssertionError, match="beyond the bounds"):
            main_path.check_against_plain(outputs, want)


def test_launch_counts_reset():
    fa.launch_counts["qkv_attn_fwd"] += 3
    fa.reset_launch_counts()
    assert set(fa.launch_counts.values()) == {0}
    assert tuple(fa.launch_counts) == fa.KERNELS


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from mofo_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.library_path().name.startswith("libmofo_kernels_")


@pytest.mark.parametrize("scale", [SCALE, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", GEOMS)
def test_prep_then_rest_is_the_plain_backward(N, H, dtype, scale):
    """The bf16 backward's prep pass (delta, q * scale, k * scale when the
    scale is not a power of two) followed by the rest of the backward is
    attention_qkv_bwd_plain, bit for bit."""
    x = torch.from_numpy(_qkv(N, H, seed=7)).to(dtype)
    out, lse = fa.attention_qkv_fwd_plain(x, scale, H)
    dout = torch.from_numpy(
        np.random.RandomState(8).randn(*out.shape).astype(np.float32)
    ).to(dtype)
    prep = fa.qkv_attn_bwd_prep(x, out, dout, scale, H)  # plain on the CPU
    delta, qs, ks = prep
    assert delta.shape == (2, H, N) and delta.dtype == torch.float32
    assert qs.shape == out.shape and qs.dtype == dtype
    assert (ks is None) == (scale == SCALE)
    got = fa.attention_qkv_bwd_from_prep_plain(x, lse, dout, *prep, scale, H)
    assert torch.equal(got,
                       fa.attention_qkv_bwd_plain(x, out, lse, dout, scale, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H", GEOMS)
def test_prep_then_rest_matches_tpu_kernels(N, H, dtype):
    """The same split backward against K2 (_qkv_bwd_impl) in interpret
    mode, at the bounds of the K2 tests above."""
    x = _qkv(N, H, seed=9)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, _, j_grad = _jax_run(x, H, jdt)
    qkv = torch.from_numpy(x).to(dtype)
    out, lse = fa.attention_qkv_fwd_plain(qkv, SCALE, H)
    dout = (2 * out.float()).to(dtype)  # the gradient of sum(out^2)
    prep = fa.attention_qkv_bwd_prep_plain(qkv, out, dout, SCALE, H)
    got = fa.attention_qkv_bwd_from_prep_plain(qkv, lse, dout, *prep, SCALE,
                                               H).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, j_grad, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, j_grad, atol=3e-2, rtol=3e-2)


def test_a_power_of_two_scale_needs_no_scaled_k_copy():
    """dQ scales its f32 accumulator by k_scale only where that equals the
    product with bf16(k * k_scale): k_scale a power of two."""
    assert fa._power_of_two(0.125) and fa._power_of_two(1.0)
    assert not fa._power_of_two(0.1) and not fa._power_of_two(0.0)
