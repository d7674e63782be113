"""K1/K2 at the flat head dims 16, 32 and 128 against the JAX package.

mofo_tpu's flat kernels take any head dim D = A / heads
(mofo_tpu/ops/flash_attention.py:1160-1165); the port's are built for
HEAD_DIMS = (16, 32, 64, 128, 192, 256), pad any other D up to 256 on the
card (tests/test_torch_any_head_dim.py) and refuse D above it. Here,
on the CPU, the port's plain versions of K1/K2 at D = 16, 32 and 128 are
held against mofo_tpu.ops.flash_attention.flash_attention_qkv in interpret
mode (the TPU kernels _qkv_fwd_impl and _qkv_bwd_impl), forward and dqkv of
loss = sum(out^2), with the bounds of tests/test_torch_flash_attention.py:
f32 out within 2e-5 and dqkv within 1e-4 (sums taken in another order);
bf16 the loss within rtol 5e-3 and dqkv within atol = rtol = 3e-2
(tests/test_tpu_kernels.py:251-254). The kernels themselves are held
against the plain versions on the card by chip_smoke.py (qkv_head_dims).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from mofo_tpu_torch.ops import flash_attention as fa

# (D, H): A = H * D, two heads a case (the TPU kernel's head-inner
# backward), one at D = 128
CASES = [(16, 2), (32, 2), (128, 1)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _qkv(N, H, D, seed):
    return np.random.RandomState(seed).randn(1, N, 3 * H * D).astype(
        np.float32)


def _jax_run(x, H, scale, dtype):
    """(out, loss, dqkv) of loss = sum(out^2) through the TPU kernels."""
    def fwd(qkv):
        return jax_flash(qkv, scale=scale, num_heads=H, interpret=True)

    def loss(qkv):
        out = fwd(qkv)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (value, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x).astype(dtype))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(out), float(value), f32(grad)


def _port_run(x, H, scale, dtype):
    qkv = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = fa.flash_attention_qkv(qkv, scale=scale, num_heads=H)
    loss = (out.float() ** 2).sum()
    loss.backward()
    return (out.detach().float().numpy(), float(loss.detach()),
            qkv.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [100, 256])
@pytest.mark.parametrize("D,H", CASES)
def test_flat_head_dim_matches_tpu_kernels(D, H, N, dtype):
    x = _qkv(N, H, D, seed=D + N)
    scale = D ** -0.5
    j_out, j_loss, j_grad = _jax_run(x, H, scale, getattr(jnp, dtype))
    p_out, p_loss, p_grad = _port_run(x, H, scale, getattr(torch, dtype))
    assert p_grad.shape == (1, N, 3 * H * D)
    if dtype == "float32":
        np.testing.assert_allclose(p_out, j_out, atol=2e-5, rtol=0)
        np.testing.assert_allclose(p_grad, j_grad, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(p_loss, j_loss, rtol=5e-3)
        np.testing.assert_allclose(p_grad, j_grad, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", CASES)
def test_prep_then_rest_is_the_plain_backward(D, H, dtype):
    """The bf16 backward's split (prep pass, then dK/dV and dQ from its
    delta, q * scale and, at D = 32 and 128, whose scale is no power of two,
    k * scale) equals the whole plain backward."""
    x = torch.from_numpy(_qkv(100, H, D, seed=D)).to(dtype)
    scale = D ** -0.5
    out, lse = fa.attention_qkv_fwd_plain(x, scale, H)
    dout = (2 * out.float()).to(dtype)
    delta, qs, ks = fa.attention_qkv_bwd_prep_plain(x, out, dout, scale, H)
    assert (ks is None) == (D == 16)
    split = fa.attention_qkv_bwd_from_prep_plain(x, lse, dout, delta, qs, ks,
                                                 scale, H)
    whole = fa.attention_qkv_bwd_plain(x, out, lse, dout, scale, H)
    assert torch.equal(split, whole)


@pytest.mark.parametrize("D", [264, 320])
def test_a_head_dim_without_kernels_is_refused(D):
    """A flat D above 256 passes the gate and runs at the next multiple of
    64 (320 here): the launchers refuse a D that is not its own width (the
    wrappers pad it first) and, at its width, a tensor off the card; the
    gate looks at the head dim before it looks at the device."""
    x = torch.zeros(1, 16, 3 * 8 * D)
    assert fa.qkv_head_dim(x, 8) == D and fa.head_dim_width(D) == 320
    match = ("CUDA tensors" if D == 320 else
             f"head dim {D} has no kernel of its own: .* pad it to 320")
    with pytest.raises(ValueError, match=match):
        fa.qkv_attn_bwd_dkv(x, x[..., :8 * D], torch.zeros(1, 8, 16),
                            x[..., :8 * D], x, D ** -0.5, 8)
    for hd in fa.HEAD_DIMS + (48, 80):
        assert fa.qkv_head_dim(torch.zeros(1, 16, 3 * 8 * hd), 8) == hd
