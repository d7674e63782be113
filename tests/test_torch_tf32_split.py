"""The numerics of the f32 kernels whose products run in 3xTF32 (K1's
forward and K2's dK/dV, mofo_tpu_torch/csrc/wgmma_tf32.cuh), emulated on
the CPU, where the kernels cannot run.

cvt.rna.tf32.f32 is emulated on the int32 view of an f32 array: add 0x1000
(half a TF32 unit in the last place), then clear the low 13 bits (round to
nearest, ties away from zero). Each operand x is split into hi = rna(x) and
lo = rna(x - hi), and a product is lo.hi + hi.lo + hi.hi in f32, as the
kernels issue it. The emulated kernels walk the same tiles: the forward's
64-row kv tiles with its online softmax, the dK/dV kernel's q tiles.

The emulation is held against mofo_tpu's flash_attention_qkv in interpret
mode (f32) within main_path.F32_ATOL, and against one float64 run: its
error is at most PRECISION_FACTOR times the plain f32 version's, and
1xTF32 (one product of rounded operands) misses that bound. The card runs
the same checks on the kernels themselves (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
    TF32X3_OUTPUTS,
    attention_qkv_f64,
)

# the outputs of the kernels emulated here (dQ's walk:
# tests/test_torch_tf32_dq.py)
EMULATED = tuple(k for k in TF32X3_OUTPUTS if k != "dq")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


TILE = 64  # the kernels' kv tile (forward) and q tile (dK/dV up to D = 64)


def rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on an f32 array: the TF32 value, low 13 bits 0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def split(x: np.ndarray):
    hi = rna(x)
    return hi, rna(x - hi)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in 3xTF32, the small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in 1xTF32: what the tensor cores give f32 operands as they
    are (the fault the precision check must reject)."""
    return rna(a) @ rna(b)


def _heads(x: np.ndarray, heads: int) -> np.ndarray:
    B, N, A = x.shape
    return x.reshape(B, N, heads, A // heads).transpose(0, 2, 1, 3)


def _merge(x: np.ndarray) -> np.ndarray:
    B, H, N, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B, N, H * D)


def _qkv_heads(qkv: np.ndarray, heads: int):
    A = qkv.shape[-1] // 3
    return tuple(_heads(qkv[..., i * A:(i + 1) * A], heads)
                 for i in range(3))


def fwd_kernel(qkv, scale: float, heads: int, mm=mm3):
    """K1's f32 forward as the kernel runs it: q * q_scale in f32, one pass
    over 64-row kv tiles with an online softmax (base e), S and P.V through
    `mm`, P not rounded, 1 / l at the end. (out, lse)."""
    q, k, v = _qkv_heads(qkv, heads)
    qs = q * np.float32(scale)
    N = q.shape[2]
    m = np.full(q.shape[:3] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    o = np.zeros(q.shape, np.float32)
    for j in range(0, N, TILE):
        s = mm(qs, k[:, :, j:j + TILE].transpose(0, 1, 3, 2))
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdims=True)
        o = o * corr + mm(p, v[:, :, j:j + TILE])
        m = m_new
    return _merge(o / l), (m + np.log(l))[..., 0]


def dkv_kernel(qkv, out, lse, dout, scale: float, heads: int, mm=mm3):
    """K2's f32 dK/dV as the kernel runs it: delta = rowsum(dO * O) from
    the caller, then per 64-row q tile S^T and dP^T through `mm`, P^T =
    exp(S^T - lse), dS^T = P^T (dP^T - delta), and dV += P^T dO, dK += dS^T
    (q * q_scale) through `mm`. (dk, dv)."""
    q, k, v = _qkv_heads(qkv, heads)
    qs = q * np.float32(scale)
    do, o = _heads(dout, heads), _heads(out, heads)
    delta = (do * o).sum(-1)
    dk, dv = np.zeros(k.shape, np.float32), np.zeros(v.shape, np.float32)
    for i in range(0, q.shape[2], TILE):
        rows = slice(i, i + TILE)
        st = mm(k, qs[:, :, rows].transpose(0, 1, 3, 2))
        dpt = mm(v, do[:, :, rows].transpose(0, 1, 3, 2))
        pt = np.exp(st - lse[:, :, None, rows])
        dst = pt * (dpt - delta[:, :, None, rows])
        dv += mm(pt, do[:, :, rows])
        dk += mm(dst, qs[:, :, rows])
    return _merge(dk), _merge(dv)


# (B, N, H, D): a ragged N over two tiles at the registry's head dim, a
# tiny preset's 16, and one tile at 32
GEOMS = [(2, 100, 2, 64), (2, 70, 4, 16), (1, 40, 2, 32)]


def _inputs(B, N, H, D, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, N, 3 * H * D).astype(np.float32)
    dout = rng.randn(B, N, H * D).astype(np.float32)
    return qkv, dout


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 unit in the last place at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                  one + 3 * ulp / 2, 4 + 4 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        rna(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                          4 + 4 * ulp], np.float32))
    assert not (rna(x).view(np.int32) & 0x1FFF).any()


def test_the_split_carries_f32_precision():
    """hi + lo is x to about 2^-22 of |x|; hi alone only to 2^-11."""
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    hi, lo = split(x)
    rel = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    assert np.abs(hi.astype(np.float64) - x).max() / np.abs(x).max() > 2e-5


def test_the_permuted_k_order_is_the_same_product():
    """The A fragments taken from an accumulator (wgmma_tf32.cuh's
    acc_to_a: word i of thread (g, t) at K position t + 4 (i // 2) holds
    accumulator column 2t + (i // 2)) against a B tile whose rows are
    permuted by perm8 give the product of the unpermuted matrices."""
    def perm8(k):
        return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1)

    rng = np.random.RandomState(2)
    K = 32
    a = rng.randint(-8, 8, (16, K)).astype(np.float64)  # an accumulator
    b = rng.randint(-8, 8, (K, 24)).astype(np.float64)
    frag = np.zeros_like(a)  # A in the K positions the fragments hold
    for g in range(8):
        for t in range(4):
            for kk in range(K // 8):
                for i in range(4):
                    row = g + 8 * (i & 1)
                    pos = 8 * kk + t + 4 * (i >> 1)
                    col = 8 * kk + 2 * t + (i >> 1)  # c[kk][acc_of_word(i)]
                    assert perm8(col) == pos
                    frag[row, pos] = a[row, col]
    b_perm = np.zeros_like(b)  # split_transposed writes row k at perm8(k)
    for k in range(K):
        b_perm[perm8(k)] = b[k]
    np.testing.assert_array_equal(frag @ b_perm, a @ b)


def _jax_fwd_bwd(qkv, dout, H, D):
    """mofo_tpu's f32 K1/K2 in interpret mode: out and the gradient of
    sum(out * dout), i.e. dqkv for that dout."""
    def fwd(x):
        return jax_flash(x, scale=D ** -0.5, num_heads=H, interpret=True)

    x = jnp.asarray(qkv)
    out, vjp = jax.vjp(jax.jit(fwd), x)
    (dqkv,) = vjp(jnp.asarray(dout))
    return np.asarray(out), np.asarray(dqkv)


@pytest.mark.parametrize("B,N,H,D", GEOMS)
def test_3xtf32_kernels_match_the_tpu_kernels(B, N, H, D):
    qkv, dout = _inputs(B, N, H, D)
    j_out, j_dqkv = _jax_fwd_bwd(qkv, dout, H, D)
    scale = fa._rounded(D ** -0.5, torch.float32)
    out, lse = fwd_kernel(qkv, scale, H)
    dk, dv = dkv_kernel(qkv, out, lse, dout, scale, H)
    A = H * D
    np.testing.assert_allclose(out, j_out, atol=F32_ATOL["out"], rtol=0)
    np.testing.assert_allclose(dk, j_dqkv[..., A:2 * A], atol=F32_ATOL["dk"],
                               rtol=0)
    np.testing.assert_allclose(dv, j_dqkv[..., 2 * A:], atol=F32_ATOL["dv"],
                               rtol=0)
    # and the lse against the port's plain version (the TPU kernel keeps
    # its own inside)
    _, p_lse = fa.attention_qkv_fwd_plain(torch.from_numpy(qkv), D ** -0.5,
                                          H)
    np.testing.assert_allclose(lse, p_lse.numpy(), atol=F32_ATOL["lse"],
                               rtol=0)


def _errors_vs_f64(qkv, dout, H, D, fwd, dkv) -> dict:
    """Max abs error of out, lse (fwd(qkv)) and dk, dv (dkv on the f64
    run's out and lse rounded to f32) against attention_qkv_f64."""
    ref = {k: v.numpy() for k, v in attention_qkv_f64(
        torch.from_numpy(qkv), torch.from_numpy(dout), D ** -0.5,
        H).items()}
    out, lse = fwd(qkv)
    dk, dv = dkv(qkv, ref["out"].astype(np.float32),
                 ref["lse"].astype(np.float32), dout)
    got = {"out": out, "lse": lse, "dk": dk, "dv": dv}
    return {k: float(np.abs(got[k].astype(np.float64) - ref[k]).max())
            for k in EMULATED}


def _plain(H, D):
    scale = D ** -0.5

    def fwd(qkv):
        out, lse = fa.attention_qkv_fwd_plain(torch.from_numpy(qkv), scale, H)
        return out.numpy(), lse.numpy()

    def dkv(qkv, out, lse, dout):
        dqkv = fa.attention_qkv_bwd_plain(
            torch.from_numpy(qkv), torch.from_numpy(out),
            torch.from_numpy(lse), torch.from_numpy(dout), scale, H).numpy()
        A = H * D
        return dqkv[..., A:2 * A], dqkv[..., 2 * A:]

    return fwd, dkv


def _emulated(H, D, mm):
    scale = fa._rounded(D ** -0.5, torch.float32)
    return (lambda qkv: fwd_kernel(qkv, scale, H, mm),
            lambda qkv, out, lse, dout: dkv_kernel(qkv, out, lse, dout,
                                                   scale, H, mm))


@pytest.mark.parametrize("B,N,H,D", GEOMS)
def test_3xtf32_is_as_precise_as_f32(B, N, H, D):
    """Against one float64 run, the 3xTF32 kernels' error is within
    PRECISION_FACTOR times the plain f32 version's, on each output."""
    qkv, dout = _inputs(B, N, H, D, seed=3)
    plain = _errors_vs_f64(qkv, dout, H, D, *_plain(H, D))
    tf32x3 = _errors_vs_f64(qkv, dout, H, D, *_emulated(H, D, mm3))
    for k in EMULATED:
        assert tf32x3[k] <= PRECISION_FACTOR * plain[k], (k, tf32x3, plain)


@pytest.mark.parametrize("B,N,H,D", GEOMS)
def test_1xtf32_misses_the_precision_bound(B, N, H, D):
    """The check sees TF32: one product of rounded operands misses the
    bound on every output, by far."""
    qkv, dout = _inputs(B, N, H, D, seed=3)
    plain = _errors_vs_f64(qkv, dout, H, D, *_plain(H, D))
    tf32 = _errors_vs_f64(qkv, dout, H, D, *_emulated(H, D, mm1))
    for k in EMULATED:
        assert tf32[k] > 10 * PRECISION_FACTOR * plain[k], (k, tf32, plain)


@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_the_f32_backward_reads_mh_delta(D):
    """The f32 backward's prep at every head dim: delta from mh_delta's
    reduction, which K2's dK/dV kernel reads (no q or k copy)."""
    qkv, dout = _inputs(2, 50, 2, D)
    x, g = torch.from_numpy(qkv), torch.from_numpy(dout)
    out, _ = fa.attention_qkv_fwd_plain(x, D ** -0.5, 2)
    delta, qs, ks = fa._qkv_prep(x, out, g, D ** -0.5, 2)
    assert qs is None and ks is None
    torch.testing.assert_close(delta, fa.mh_delta(out, g, 2), rtol=0, atol=0)
    assert delta.shape == (2, 2, 50)
