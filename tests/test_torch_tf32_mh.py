"""The numerics of K3's f32 kernels at head dims 192 and 256, whose products
run in 3xTF32 on the tensor cores with D streamed in 64-column chunks
(mofo_tpu_torch/csrc/wgmma_tf32_wide.cuh), emulated on the CPU, where the
kernels cannot run.

The emulated kernels walk what the kernels walk: the forward's 64-row kv
tiles, each score S a sum of one 3xTF32 product a 64-column chunk of D
(each chunk into a fresh accumulator, added in f32), the bias after the
scale fold, an online softmax in base e, and P.V one 64-column chunk of
the output at a time; the dK/dV kernel's dV block (S^T by chunks, then
dV_c += P^T dO_c) and dK block (dP^T one k-step of 8 columns at a time,
each k-step's sum added to its chunk's in f32, then S^T again and dK_c +=
dS^T (q * q_scale)_c), q tile by q tile. A 3xTF32 product is lo.hi +
hi.lo + hi.hi, small terms first (rna and the split as in
tests/test_torch_tf32_split.py); 1xTF32 (rna(a) rna(b)) is the fault the
precision check must reject.

The emulation is held against mofo_tpu's flash_attention_mh with a kv
bias in interpret mode (the TPU kernel K3) within main_path.F32_ATOL, and
against one float64 run (main_path.attention_mh_f64): its error is at
most PRECISION_FACTOR times the plain f32 version's, and 1xTF32 misses
that bound by over 10x. At N = 1 the plain version is exact (one kv column:
out = v), so there the emulation is held to F32_ATOL of float64 instead.
The index algebra of the chunked layout (a strip's chunk is a whole tile,
the walks' entries, the two-deep per-tile values, the shared memory) is
checked exactly. The card runs the checks on the kernels themselves
(tests/test_torch_gpu.py, chip_smoke.py's f32_precision phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
    TF32X3_OUTPUTS,
    attention_mh_f64,
    f32_rows_beyond,
    mh_backward_f64,
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


TILE = CHUNK = 64  # rows of every tile; columns of a chunk of D
KSTEP = 8  # columns of D a k-step takes


def rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on an f32 array (test_torch_tf32_split.py's)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in 3xTF32, the small terms first."""
    ah, bh = rna(a), rna(b)
    al, bl = rna(a - ah), rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in 1xTF32, the fault the precision check must reject."""
    return rna(a) @ rna(b)


def _heads(x, H):
    B, N, A = x.shape
    return x.reshape(B, N, H, A // H).transpose(0, 2, 1, 3)


def _merge(x):
    B, H, N, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B, N, H * D)


def _t(x):
    return x.swapaxes(-1, -2)


def _chunked(a, b, mm, step=CHUNK):
    """a @ b^T over the last axis, one product of `step` columns at a time,
    each into a fresh sum added in f32 (the kernels' chunk chains)."""
    D = a.shape[-1]
    s = mm(a[..., :step], _t(b[..., :step]))
    for c in range(step, D, step):
        s = s + mm(a[..., c:c + step], _t(b[..., c:c + step]))
    return s


def _bias(kv_bias, B, N):
    return np.zeros((B, N), np.float32) if kv_bias is None else kv_bias


def fwd_kernel(q, k, v, kv_bias, scale, H, mm=mm3):
    """mh_fwd_tf32 as it runs: (out, lse)."""
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    qs = qh * np.float32(scale)
    B, _, N, D = qh.shape
    bias = _bias(kv_bias, B, N)
    m = np.full((B, H, N, 1), -np.inf, np.float32)
    l = np.zeros_like(m)
    o = np.zeros(qh.shape, np.float32)
    for j in range(0, N, TILE):
        cols = slice(j, j + TILE)
        s = _chunked(qs, kh[:, :, cols], mm) + bias[:, None, None, cols]
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdims=True)
        o = o * corr
        for c in range(0, D, CHUNK):
            o[..., c:c + CHUNK] += mm(p, vh[:, :, cols, c:c + CHUNK])
        m = m_new
    return _merge(o / l), (m + np.log(l))[..., 0]


def dkv_kernel(q, k, v, kv_bias, out, lse, dout, scale, H, mm=mm3):
    """mh_dkv_tf32 as it runs: the dV block and the dK block, q tile by q
    tile, delta = rowsum(dO * O) from the caller (fa.mh_delta). (dk, dv)."""
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    do = _heads(dout, H)
    qs = qh * np.float32(scale)
    B, _, N, D = qh.shape
    brow = _bias(kv_bias, B, N)[:, None, :, None]  # the block's kv rows
    delta = (do * _heads(out, H)).sum(-1)
    dk, dv = np.zeros(kh.shape, np.float32), np.zeros(vh.shape, np.float32)
    for i in range(0, N, TILE):
        rows = slice(i, i + TILE)
        l_t, d_t = lse[:, :, None, rows], delta[:, :, None, rows]
        st = _chunked(kh, qs[:, :, rows], mm)
        pt = np.exp(st + brow - l_t)
        # dP^T: each k-step's sum into its chunk's, the chunks' in f32
        dpt = _chunked(vh, do[:, :, rows],
                       lambda a, b: _chunked(a, _t(b), mm, KSTEP))
        dst = pt * (dpt - d_t)
        for c in range(0, D, CHUNK):
            dv[..., c:c + CHUNK] += mm(pt, do[:, :, rows, c:c + CHUNK])
            dk[..., c:c + CHUNK] += mm(dst, qs[:, :, rows, c:c + CHUNK])
    return _merge(dk), _merge(dv)


def _inputs(B, N, H, D, bias=True, seed=0):
    """q, k, v (B, N, H*D) f32 and a 0 / -1e30 kv bias row in which sample
    0 keeps one valid column (main_path.mh_inputs' masks) and every sample
    at least one (the TPU kernel's precondition)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(3))
    kv_bias = None
    if bias:
        valid = rng.rand(B, N) < 0.6
        valid[0] = False
        valid[0, N // 2] = True
        valid[1:, N // 3] = True
        kv_bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, kv_bias


# (B, N, H, D, scale): ragged N over two tiles at the MCA's 256, the
# 4-head MCA's 192 over three tiles, scale 0.1, and N = 1
GEOMS = [(2, 70, 1, 256, None), (2, 130, 2, 192, None),
         (2, 70, 1, 256, 0.1), (2, 1, 2, 256, None), (2, 1, 1, 192, None)]


def _emulated(q, k, v, kv_bias, H, scale, dout_of, mm=mm3):
    """out, lse, dk, dv of the emulated kernels; the backward takes
    dout_of(out) and the emulated forward's out and lse."""
    s = fa._rounded(scale, torch.float32)
    out, lse = fwd_kernel(q, k, v, kv_bias, s, H, mm)
    dout = dout_of(out)
    dk, dv = dkv_kernel(q, k, v, kv_bias, out, lse, dout, s, H, mm)
    return {"out": out, "lse": lse, "dk": dk, "dv": dv}


@pytest.mark.parametrize("B,N,H,D,scale", GEOMS)
def test_3xtf32_chunks_match_the_tpu_kernel(B, N, H, D, scale):
    """Forward and backward against mofo_tpu's K3 with the kv bias in
    interpret mode, within F32_ATOL, for a cotangent of std 1; masked kv
    rows get exactly zero dK and dV. With sum(out^2)'s cotangent 2 out, dV
    of sample 0's one unmasked column is a sum of N like terms (|dV| ~ 2
    N), where F32_ATOL is a few f32 ulps and either side's own rounding
    may pass it: there each row is held as main_path.f32_rows_beyond holds
    it (within F32_ATOL of the TPU kernel's, except in a row where the TPU
    kernel is beyond F32_ATOL of float64: there within PRECISION_FACTOR of
    its error against float64)."""
    scale = scale or D ** -0.5
    q, k, v, b = _inputs(B, N, H, D)
    dout = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def fwd(q, k, v):
        return jax_mh(q, k, v, scale=scale, num_heads=H,
                      kv_bias=jnp.asarray(b), interpret=True)

    out_j, vjp = jax.vjp(jax.jit(fwd), *map(jnp.asarray, (q, k, v)))
    _, dk_j, dv_j = vjp(jnp.asarray(dout))
    got = _emulated(q, k, v, b, H, scale, lambda o: dout)
    for n, want in (("out", out_j), ("dk", dk_j), ("dv", dv_j)):
        np.testing.assert_allclose(got[n], np.asarray(want),
                                   atol=F32_ATOL[n], rtol=0, err_msg=n)
    # and the lse against the port's plain version (the TPU kernel keeps
    # its own inside)
    t = [torch.from_numpy(x) for x in (q, k, v, b)]
    _, p_lse = fa.attention_mh_fwd_plain(*t, scale, H)
    np.testing.assert_allclose(got["lse"], p_lse.numpy(),
                               atol=F32_ATOL["lse"], rtol=0)
    masked = b != 0
    assert not got["dk"][masked].any() and not got["dv"][masked].any()

    _, dk_j, dv_j = vjp(2 * out_j)
    got = _emulated(q, k, v, b, H, scale, lambda o: 2 * o)
    ref = attention_mh_f64(*t, torch.from_numpy(dout), scale, H)
    exact = dict(zip(("dq", "dk", "dv"), mh_backward_f64(
        *t, ref["out"], ref["lse"], 2 * ref["out"], scale, H)))
    for n, want in (("dk", dk_j), ("dv", dv_j)):
        held = f32_rows_beyond(torch.from_numpy(got[n]), torch.from_numpy(
            np.asarray(want)), exact[n], F32_ATOL[n])
        assert held["beyond"] == 0, (n, held)


def _errors_vs_f64(q, k, v, b, H, scale, run) -> dict:
    """Max abs error of out, lse, dk, dv against attention_mh_f64: run(dout)
    gives them, its backward on the f64 run's out and lse rounded to f32
    (main_path.mh_f32_precision's inputs)."""
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    ref = {n: t.numpy() for n, t in attention_mh_f64(
        *map(torch.from_numpy, (q, k, v, b, dout)), scale, H).items()}
    got = run(dout, ref["out"].astype(np.float32),
              ref["lse"].astype(np.float32))
    return {n: float(np.abs(got[n].astype(np.float64) - ref[n]).max())
            for n in EMULATED}


def _plain_run(q, k, v, b, H, scale):
    t = [torch.from_numpy(x) for x in (q, k, v, b)]

    def run(dout, out, lse):
        o, l = fa.attention_mh_fwd_plain(*t, scale, H)
        _, dk, dv = fa.attention_mh_bwd_plain(
            *t, torch.from_numpy(out), torch.from_numpy(lse),
            torch.from_numpy(dout), scale, H)
        return {"out": o.numpy(), "lse": l.numpy(), "dk": dk.numpy(),
                "dv": dv.numpy()}
    return run


def _kernel_run(q, k, v, b, H, scale, mm):
    s = fa._rounded(scale, torch.float32)

    def run(dout, out, lse):
        o, l = fwd_kernel(q, k, v, b, s, H, mm)
        dk, dv = dkv_kernel(q, k, v, b, out, lse, dout, s, H, mm)
        return {"out": o, "lse": l, "dk": dk, "dv": dv}
    return run


@pytest.mark.parametrize("B,N,H,D,scale", GEOMS)
def test_3xtf32_chunks_are_as_precise_as_f32(B, N, H, D, scale):
    """Against one float64 run, each output of the emulated kernels is
    within PRECISION_FACTOR times the plain f32 version's error, and
    1xTF32 misses that bound by over 10x. At N = 1 the plain version is
    exact (out = v; dS = 0 in either version) and TF32 does not change it,
    so there the emulation is held to F32_ATOL of float64."""
    scale = scale or D ** -0.5
    x = _inputs(B, N, H, D, seed=3)
    tf32x3 = _errors_vs_f64(*x, H, scale, _kernel_run(*x, H, scale, mm3))
    if N == 1:
        for n in EMULATED:
            assert tf32x3[n] <= F32_ATOL[n], (n, tf32x3)
        return
    plain = _errors_vs_f64(*x, H, scale, _plain_run(*x, H, scale))
    tf32 = _errors_vs_f64(*x, H, scale, _kernel_run(*x, H, scale, mm1))
    for n in EMULATED:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > 10 * PRECISION_FACTOR * plain[n], (n, tf32, plain)


@pytest.mark.parametrize("case,beyond,held", [
    ("as_plain", 0, 0), ("row0_tiled", 0, 1), ("row0_past_factor", 1, 0),
    ("row1_off", 1, 0), ("row1_zero", 1, 0), ("nan", 1, 0)])
def test_rows_are_held_to_float64_only_where_the_plain_version_misses(
        case, beyond, held):
    """main_path.f32_rows_beyond: row 0 of the plain version is 0.1 off
    float64 (a long sum of like terms), the other rows within 1e-6. A got
    with row 0 0.01 off passes there (held to float64), 0.5 off does not;
    in row 1 one element 1e-3 off, the row zeroed or a NaN is beyond."""
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 4, 8))
    plain = (x + 1e-6).float()
    plain[0, 0] = (x[0, 0] + 0.1).float()
    got = plain.clone()
    if case == "row0_tiled":
        got[0, 0] = (x[0, 0] + 0.01).float()
    elif case == "row0_past_factor":
        got[0, 0] = (x[0, 0] + 0.5).float()
    elif case == "row1_off":
        got[0, 1, 3] += 1e-3
    elif case == "row1_zero":
        got[0, 1] = 0
    elif case == "nan":
        got[2, 3, 7] = float("nan")
    res = f32_rows_beyond(got, plain, x, 5e-4)
    assert (res["beyond"], res["held_to_f64"]) == (beyond, held)
    assert int(res["held"].sum()) == held
    assert f32_rows_beyond(got, plain, None, 5e-4)["beyond"] == \
        beyond + held


# --- the chunked layout's index algebra (wgmma_tf32.cuh, wgmma_tf32_wide.cuh)


def kmaj_index(R, C, r, c):
    """wgmma_tf32.cuh's kmaj_index<R, C>(r, c)."""
    W = C if C < 32 else 32
    swz = ((r * 4 * W) >> 7) & (4 * W // 16 - 1)
    return (c // W) * R * W + r * W + ((((c % W) >> 2) ^ swz) << 2) + (c & 3)


@pytest.mark.parametrize("D", [192, 256])
def test_a_chunk_of_a_strip_is_a_whole_tile(D):
    """Chunk c of a 64 x D K-major strip is the 64 x 64 K-major tile at
    float c * 4096, element for element: strip_k8(strip, c, kk) is then
    chunk_k8(strip + 4096 c, kk), and each chunk of a row is one TMA
    box pair (two 32-column boxes)."""
    r, x = np.meshgrid(np.arange(TILE), np.arange(CHUNK), indexing="ij")
    for c in range(D // CHUNK):
        np.testing.assert_array_equal(
            kmaj_index(TILE, D, r, CHUNK * c + x),
            c * TILE * CHUNK + kmaj_index(TILE, CHUNK, r, x))
    # every float of the strip is addressed once
    r, x = np.meshgrid(np.arange(TILE), np.arange(D), indexing="ij")
    assert sorted(kmaj_index(TILE, D, r, x).ravel()) == list(range(TILE * D))


def wide_entry(kC, role, r):
    """wgmma_tf32_wide.cuh's wide_entry<kC, kRole>(r): (tensor, chunk,
    transposed), tensor 0 q, 1 v, 2 dO."""
    if role == 0:
        return (0, r, False) if r < kC else (2, r - kC, True)
    if r < 2 * kC:
        return (2 if r & 1 else 1, r // 2, False)
    return (0, r - 2 * kC, False) if r < 3 * kC else (0, r - 3 * kC, True)


@pytest.mark.parametrize("D", [192, 256])
def test_the_dkv_walks(D):
    """A q tile's entries: the dV block reads q's chunks as loaded, then
    dO's transposed; the dK block V's and dO's chunks in turn, q's as
    loaded, then q's transposed. Each (tensor, form, chunk) once, and the
    consumer's last kC entries of a tile (e0 + kEPT - kC + c) are the
    transposed chunks c its output product takes."""
    kC = D // CHUNK
    for role, kept in ((0, 2 * kC), (1, 4 * kC)):
        walk = [wide_entry(kC, role, r) for r in range(kept)]
        assert len(set(walk)) == kept
        for c in range(kC):
            assert walk[kept - kC + c] == (0 if role else 2, c, True)
    walk = [wide_entry(kC, 1, r) for r in range(2 * kC)]
    assert walk[0::2] == [(1, c, False) for c in range(kC)]  # V_c
    assert walk[1::2] == [(2, c, False) for c in range(kC)]  # dO_c


def ring_entries(D):
    """WideF32<D>::kEntries."""
    return 3 if D == 256 else 4


@pytest.mark.parametrize("D", [192, 256])
def test_per_tile_values_are_read_before_they_are_overwritten(D):
    """The bias row (forward) and LSE and delta (dK/dV) of tile j live in
    slot j % 2, written by the producer when it splits the tile's first
    entry e0(j); that entry's load starts when the consumer is done with
    entry e0(j) - kEntries. Tile j - 2's values in the same slot are read
    before the consumer takes entry e0(j - 2) + read (the forward and the
    dV block after S: kC entries; the dK block after dP^T and S^T: 3 kC),
    so e0(j) - kEntries must be at least e0(j - 2) + read."""
    kC, kE = D // CHUNK, ring_entries(D)
    for per_tile, read in ((2 * kC, kC), (2 * kC, kC), (4 * kC, 3 * kC)):
        for j in range(2, 40):
            assert per_tile * j - kE >= per_tile * (j - 2) + read
        # and a tile's entries never share a slot with its own stats'
        # entry before that entry is consumed: more entries than slots
        assert per_tile >= kE


@pytest.mark.parametrize("D", [192, 256])
def test_the_block_fits_shared_memory(D):
    """WideF32<D>::smem(): 1024 bytes of alignment, the (hi, lo) strip,
    the ring, the per-tile values two deep, the barriers; at most the
    232,448 bytes a block may take, and no third strip-sized pair fits."""
    kE = ring_entries(D)
    strip = TILE * D
    smem = 1024 + (2 * strip + kE * 2 * CHUNK * CHUNK + 4 * CHUNK) * 4 + \
        (2 * kE + 1) * 8
    assert smem <= 232_448
    assert smem + 2 * CHUNK * CHUNK * 4 > 232_448  # the ring is full
    assert {192: 231_496, 256: 231_480}[D] == smem


def test_rna_is_the_split_the_emulation_takes():
    """The emulation's TF32 rounding (round to nearest, ties away) leaves
    hi with its low 13 bits clear, within 2^-11 of the value."""
    x = np.random.RandomState(4).randn(1024).astype(np.float32)
    hi = rna(x)
    assert not (hi.view(np.int32) & 0x1FFF).any()
    assert np.abs(hi - x).max() <= np.abs(x).max() * 2.0 ** -11
