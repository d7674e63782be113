"""The numerics of the f32 dQ of K3 and K2, whose products run in 3xTF32 on
the tensor cores (mofo_tpu_torch/csrc/wgmma_tf32_dq.cuh up to head dim
128, wgmma_tf32_wide.cuh's mh_dq_tf32 at 192 and 256), emulated on the
CPU, where the kernels cannot run; and the repaired checks that hold them
on the card (main_path: dQ in TF32X3_OUTPUTS, rows held to float64 only in
a one-column sample, the planted fault dq_one_column_rows_off).

The emulated walks do what the kernels do, kv tile by kv tile: the narrow
one (D = 16 to 128; 64-row kv tiles, 32 at 128) forms S = (q * q_scale)
K^T in one 3xTF32 product, the bias after the fold (-inf past N), dP = dO
V^T one k-step of 8 columns at a time (each k-step's three products into a
fresh sum, added in f32), P = exp(S - lse) and dS = P (dP - delta), then
dQ += dS (K * k_scale) with K scaled before its split and the kv index in
the permuted order (perm8) that dS's fragments and the transposed K tile
share, into a fresh sum of at most 64 output columns added in f32. The
chunked one (D = 192, 256; 64-row tiles) forms S as a sum of one product a
64-column chunk of D and dQ one 64-column chunk at a time. A 3xTF32
product is lo.hi + hi.lo + hi.hi, small terms first (rna and the split of
tests/test_torch_tf32_split.py); 1xTF32 (rna(a) rna(b)) is the fault the
precision check must reject.

The emulation is held against mofo_tpu's interpret-mode kernels within
main_path.F32_ATOL["dq"] (flash_attention_mh with a kv bias for K3,
flash_attention_qkv for K2), and against one float64 run: its error is at
most PRECISION_FACTOR times the plain f32 version's, and 1xTF32 misses
that bound by over 10x. The index algebra (the walks' entries, the bias
rows' lifetime, the shared-memory budgets) is checked exactly. The card
runs the checks on the kernels themselves (tests/test_torch_gpu.py,
chip_smoke.py's f32_precision and mh_kernels phases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_qkv
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
    TF32X3_OUTPUTS,
    attention_mh_f64,
)
from test_torch_tf32_split import mm1, mm3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


CHUNK = 64  # columns of a chunk of D (the chunked walk), rows of its tiles
KSTEP = 8  # columns of D a k-step takes
SMEM = 232_448  # shared memory a block may take


def kv_rows(D: int) -> int:
    """DqF32<D>::kBK (the narrow walk) or the chunked walk's 64."""
    return 32 if D == 128 else 64


def perm8(k):
    """wgmma_tf32.cuh's perm8: the position of column k in its group of 8
    in the K order of products whose A operand comes from an
    accumulator."""
    return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1)


def _heads(x, H):
    B, N, A = x.shape
    return x.reshape(B, N, H, A // H).transpose(0, 2, 1, 3)


def _merge(x):
    B, H, N, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B, N, H * D)


def _t(x):
    return x.swapaxes(-1, -2)


def _stepped(a, b, mm, step):
    """a @ b^T over the last axis, one product of `step` columns at a time,
    each into a fresh sum added in f32."""
    s = mm(a[..., :step], _t(b[..., :step]))
    for c in range(step, a.shape[-1], step):
        s = s + mm(a[..., c:c + step], _t(b[..., c:c + step]))
    return s


def _permuted(ds, ks):
    """dS and the K tile with the kv index in perm8's order (the fragments'
    and split_transposed's): the same product, summed in another order."""
    pos = perm8(np.arange(ds.shape[-1]))
    dsp, ksp = np.empty_like(ds), np.empty_like(ks)
    dsp[..., pos] = ds
    ksp[..., pos, :] = ks
    return dsp, ksp


def dq_kernel(q, k, v, kv_bias, lse, delta, dout, scale, k_scale, H,
              mm=mm3):
    """The f32 dQ kernel as it runs at q's head dim (the narrow walk up to
    128, the chunked one at 192 and 256): q, k, v, dout (B, N, H D), lse
    and delta (B, H, N), kv_bias (B, N) or None. Returns dq (B, N, H D)."""
    qh, kh, vh, do = (_heads(x, H) for x in (q, k, v, dout))
    B, _, N, D = qh.shape
    wide = D > 128
    T = kv_rows(D)
    pad = -N % T  # rows past N arrive as zeros; their columns score -inf
    kh, vh = (np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (kh, vh))
    bias = np.zeros((B, N), np.float32) if kv_bias is None else kv_bias
    bias = np.pad(bias, ((0, 0), (0, pad)), constant_values=-np.inf)
    qs = qh * np.float32(scale)
    ks = kh * np.float32(k_scale)  # K scaled before its split
    dq = np.zeros(qh.shape, np.float32)
    lse, delta = lse[..., None], delta[..., None]
    for j in range(0, N + pad, T):
        cols = slice(j, j + T)
        kt = kh[:, :, cols]
        s = (_stepped(qs, kt, mm, CHUNK) if wide else mm(qs, _t(kt))) + \
            bias[:, None, None, cols]
        dp = _stepped(do, vh[:, :, cols], mm, KSTEP)  # one k-step a chain
        ds = np.exp(s - lse) * (dp - delta)
        dsp, ksp = _permuted(ds, ks[:, :, cols])
        for c in range(0, D, CHUNK):  # a fresh sum of 64 columns at most
            dq[..., c:c + CHUNK] += mm(dsp, ksp[..., c:c + CHUNK])
    return _merge(dq)


def _inputs(B, N, H, D, bias=True, seed=0):
    """q, k, v (B, N, H D) f32 and a 0 / -1e30 kv bias row in which sample
    0 keeps one valid column (main_path.mh_inputs' masks) and every sample
    at least one (the TPU kernel's precondition); None without `bias`."""
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


def _stats(q, k, v, kv_bias, dout, scale, H):
    """lse from the port's plain forward and delta = rowsum(dO * O) from
    fa.mh_delta, as the kernel's caller hands them over."""
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, kv_bias)]
    out, lse = fa.attention_mh_fwd_plain(*t, scale, H)
    return lse.numpy(), fa.mh_delta(out, torch.from_numpy(dout), H).numpy()


def _emulated_dq(q, k, v, kv_bias, dout, scale, H, mm=mm3, stats=None):
    s = fa._rounded(scale, torch.float32)
    lse, delta = stats or _stats(q, k, v, kv_bias, dout, scale, H)
    return dq_kernel(q, k, v, kv_bias, lse, delta, dout, s, s, H, mm)


# K3 with the kv bias (B, N, H, D, scale): each narrow head dim, ragged N
# over two tiles, scale 0.1, N = 1; the chunked 256 and 192
K3_GEOMS = [(2, 70, 2, 16, None), (2, 70, 1, 32, None),
            (2, 130, 1, 64, 0.1), (2, 70, 1, 128, None), (2, 1, 2, 64, None),
            (2, 70, 1, 256, None), (2, 130, 1, 192, 0.1),
            (2, 1, 1, 256, None)]
# K2 (no bias): the narrow head dims, ragged N, scale 0.1, N = 1, and 192
# through K3's chunked kernel
K2_GEOMS = [(2, 70, 2, 16, None), (2, 130, 1, 64, None),
            (2, 70, 1, 128, 0.1), (2, 1, 1, 32, None), (1, 70, 1, 192, None)]


@pytest.mark.parametrize("B,N,H,D,scale", K3_GEOMS)
def test_dq_walks_match_the_tpu_k3(B, N, H, D, scale):
    """The emulated dQ against mofo_tpu's flash_attention_mh with the kv
    bias in interpret mode, within F32_ATOL["dq"], for a cotangent of std
    1."""
    scale = scale or D ** -0.5
    q, k, v, b = _inputs(B, N, H, D)
    dout = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def fwd(q_):
        return jax_mh(q_, jnp.asarray(k), jnp.asarray(v), scale=scale,
                      num_heads=H, kv_bias=jnp.asarray(b), interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), jnp.asarray(q))
    (dq_j,) = vjp(jnp.asarray(dout))
    got = _emulated_dq(q, k, v, b, dout, scale, H)
    np.testing.assert_allclose(got, np.asarray(dq_j), atol=F32_ATOL["dq"],
                               rtol=0)


@pytest.mark.parametrize("B,N,H,D,scale", K2_GEOMS)
def test_dq_walks_match_the_tpu_k2(B, N, H, D, scale):
    """The same walk with the bias flag off against mofo_tpu's
    flash_attention_qkv in interpret mode (its f32 backward is K3's dQ
    kernel without a bias, off interpret mode), q, k and v the column
    views of one fused qkv."""
    scale = scale or D ** -0.5
    rng = np.random.RandomState(7)
    qkv = rng.randn(B, N, 3 * H * D).astype(np.float32)
    dout = rng.randn(B, N, H * D).astype(np.float32)
    A = H * D

    def fwd(x):
        return jax_qkv(x, scale=scale, num_heads=H, interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(dout))
    q, k, v = (np.ascontiguousarray(qkv[..., i * A:(i + 1) * A])
               for i in range(3))
    got = _emulated_dq(q, k, v, None, dout, scale, H)
    np.testing.assert_allclose(got, np.asarray(dqkv_j)[..., :A],
                               atol=F32_ATOL["dq"], rtol=0)


def _dq_errors_vs_f64(q, k, v, b, H, scale, mm) -> tuple:
    """Max abs error of dQ against main_path.mh_backward_f64, for the
    plain f32 version and for the emulated kernel through `mm`; both take
    the f64 run's out and lse rounded to f32 (main_path.mh_f32_precision's
    inputs) and delta from them."""
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, b, dout)]
    ref = attention_mh_f64(*t, scale, H)
    out, lse = ref["out"].float(), ref["lse"].float()
    exact = ref["dq"].numpy()
    p_dq, _, _ = fa.attention_mh_bwd_plain(*t[:4], out, lse, t[4], scale, H)
    stats = (lse.numpy(), fa.mh_delta(out, t[4], H).numpy())
    got = _emulated_dq(q, k, v, b, dout, scale, H, mm, stats)
    return (float(np.abs(p_dq.double().numpy() - exact).max()),
            float(np.abs(got.astype(np.float64) - exact).max()))


# (B, N, H, D, bias): each head dim, with and without the kv bias, ragged
PRECISION_GEOMS = [(2, 100, 2, 16, True), (2, 100, 2, 32, False),
                   (2, 130, 1, 64, True), (2, 130, 1, 64, False),
                   (2, 70, 1, 128, True), (2, 100, 1, 192, True),
                   (2, 70, 1, 256, False)]


@pytest.mark.parametrize("B,N,H,D,bias", PRECISION_GEOMS)
def test_dq_walks_are_as_precise_as_f32(B, N, H, D, bias):
    """Against one float64 run, the emulated 3xTF32 dQ is within
    PRECISION_FACTOR of the plain f32 version's error, and 1xTF32 misses
    that bound by over 10x."""
    x = _inputs(B, N, H, D, bias=bias, seed=3)
    scale = D ** -0.5
    plain, tf32x3 = _dq_errors_vs_f64(*x, H, scale, mm3)
    _, tf32 = _dq_errors_vs_f64(*x, H, scale, mm1)
    assert tf32x3 <= PRECISION_FACTOR * plain, (tf32x3, plain)
    assert tf32 > 10 * PRECISION_FACTOR * plain, (tf32, plain)


@pytest.mark.parametrize("D", [64, 256])
def test_dq_at_one_column_is_rounding_noise(D):
    """At N = 1 every query attends its one kv column with P = 1, so dS =
    dP - delta is rounding noise around 0: the plain version and the
    emulated walk both give dQ within F32_ATOL["dq"] of float64."""
    x = _inputs(3, 1, 2, D, seed=4)
    plain, tf32x3 = _dq_errors_vs_f64(*x, 2, D ** -0.5, mm3)
    assert max(plain, tf32x3) <= F32_ATOL["dq"], (plain, tf32x3)


# --- the walks' index algebra and budgets ------------------------------------


def test_the_fragments_take_ds_in_the_permuted_order():
    """acc_to_a's A fragment word i of thread (g, t) holds accumulator
    column 2t + (i // 2) at K position t + 4 (i // 2), which is perm8 of
    that column: the dS fragments and split_transposed's K tile (row k at
    perm8(k)) share one order, and the product is dS K."""
    rng = np.random.RandomState(2)
    ds = rng.randint(-8, 8, (16, 64)).astype(np.float64)
    kt = rng.randint(-8, 8, (64, 40)).astype(np.float64)
    for t in range(4):
        for i in range(4):
            for kk in range(8):
                col = 8 * kk + 2 * t + (i >> 1)
                assert perm8(col) == 8 * kk + t + 4 * (i >> 1)
    assert sorted(perm8(np.arange(64))) == list(range(64))
    np.testing.assert_array_equal(np.matmul(*_permuted(ds, kt)), ds @ kt)


def narrow(D):
    """DqF32<D>: (consumer warpgroups, kv rows a tile, entries, smem)."""
    wgs = 1 if D == 128 else 2
    bk = kv_rows(D)
    entries = 6 if D <= 32 else 3
    smem = 1024 + (4 * wgs * 64 * D + 2 * entries * bk * D + entries * bk) \
        * 4 + (3 * entries + 1) * 8
    return wgs, bk, entries, smem


@pytest.mark.parametrize("D,want", [(16, 84_632), (32, 166_552),
                                    (64, 231_248), (128, 230_864)])
def test_the_narrow_block_fits_shared_memory(D, want):
    """DqF32<D>::smem(): 1024 bytes of alignment, each consumer
    warpgroup's resident q * q_scale and dO (hi, lo) pairs, the ring of
    (hi, lo) kv entries, one bias row an entry, the barriers. At 64 and
    128 no fourth entry fits, so 128 takes 32-row kv tiles (a 64-row
    entry would be 64 KB) and one consumer warpgroup."""
    wgs, bk, entries, smem = narrow(D)
    assert smem == want <= SMEM
    if D >= 64:
        assert smem + 2 * bk * D * 4 > SMEM
        two = 1024 + (4 * 2 * 64 * D + 2 * 3 * 64 * D) * 4
        assert D == 64 or two > SMEM
    # every tile of the block starts on a 1024-byte boundary (swizzle)
    assert (64 * D * 4) % 1024 == 0 and (bk * D * 4) % 1024 == 0


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_the_narrow_walk(D):
    """Entry e of the walk is kv tile e // 3's K (kind 0), V (1) or K
    transposed (2), in slot e % entries. A tile's three entries sit in
    three different slots, so its S, dP and dQ products each find their
    operand; the ring holds whole tiles; the K entry's bias row is read
    before that slot is released, so no later tile overwrites it first."""
    _, _, entries, _ = narrow(D)
    assert entries % 3 == 0
    for j in range(12):
        slots = [(3 * j + kind) % entries for kind in range(3)]
        assert len(set(slots)) == 3
        assert [(3 * j + kind) % 3 for kind in range(3)] == [0, 1, 2]


def dq_entry(kC, r):
    """wgmma_tf32_wide.cuh's wide_entry<kC, 1>(r) as the dQ kernel reads
    it: (tensor, chunk, transposed), tensor 0 K, 1 V, 2 dO."""
    if r < 2 * kC:
        return (2 if r & 1 else 1, r // 2, False)
    return (0, r - 2 * kC, False) if r < 3 * kC else (0, r - 3 * kC, True)


@pytest.mark.parametrize("D", [192, 256])
def test_the_chunked_walk(D):
    """A kv tile's 4 kC entries: V's and dO's chunks in turn (dP, one
    chunk pair at a time), K's as loaded (S), then K's transposed (dQ's
    chunk c is the tile's last kC entries' c-th). Each (tensor, chunk,
    form) once; dO is the only tensor at the block's q rows."""
    kC = D // CHUNK
    walk = [dq_entry(kC, r) for r in range(4 * kC)]
    assert len(set(walk)) == 4 * kC
    assert walk[0:2 * kC:2] == [(1, c, False) for c in range(kC)]
    assert walk[1:2 * kC:2] == [(2, c, False) for c in range(kC)]
    assert walk[2 * kC:3 * kC] == [(0, c, False) for c in range(kC)]
    assert walk[3 * kC:] == [(0, c, True) for c in range(kC)]


@pytest.mark.parametrize("D", [192, 256])
def test_the_chunked_bias_rows_live_long_enough(D):
    """The bias row of kv tile j lives in slot j % 2, written when the
    producer splits the tile's first entry e0(j) = 4 kC j, whose load
    starts when the consumer is done with entry e0(j) - kEntries; tile
    j - 2's row in that slot is read after dP and S, before entry e0(j -
    2) + 3 kC: so e0(j) - kEntries >= e0(j - 2) + 3 kC."""
    kC, kE = D // CHUNK, 3 if D == 256 else 4
    for j in range(2, 40):
        assert 4 * kC * j - kE >= 4 * kC * (j - 2) + 3 * kC


@pytest.mark.parametrize("D", [192, 256])
def test_the_chunked_dq_keeps_the_forward_s_layout(D):
    """The chunked dQ block takes WideF32<D>::smem() (the q * q_scale
    strip, the ring, the per-tile values, the barriers): a second (hi, lo)
    strip for dO beside the first leaves no room for a ring of two
    entries (S's K and dP's V), so dO is streamed."""
    kE = 3 if D == 256 else 4
    strip = 64 * D * 4
    smem = 1024 + 2 * strip + kE * 2 * CHUNK * CHUNK * 4 + 4 * CHUNK * 4 + \
        (2 * kE + 1) * 8
    assert smem <= SMEM
    assert 1024 + 4 * strip + 2 * 2 * CHUNK * CHUNK * 4 > SMEM


def test_no_fma_dq_kernel_is_left():
    """In f32 every dQ up to head dim 256 runs one of the two 3xTF32
    kernels: K3's entry point sends its f32 dQ (through
    mh_flash_attention_f32.cu's mh_f32_dq) to launch_dq_tf32 (the narrow
    mh_dq_f32 up to 128, the chunked mh_dq_tf32 at 192 and 256), K2's f32
    dQ goes through K3's entry point at every head dim, and no source
    keeps an FMA dQ kernel."""
    from mofo_tpu_torch.ops import _build

    qkv = (_build.CSRC / "qkv_flash_attention.cu").read_text()
    mh = (_build.CSRC / "mh_flash_attention_f32.cu").read_text()
    entry = (_build.CSRC / "mh_flash_attention.cu").read_text()
    for text in (qkv, mh, entry):
        assert "bwd_dq_f32" not in text
    dq_entry = entry[entry.index('extern "C" int mh_attn_bwd_dq('):]
    assert "!bf16 ? mh_f32_dq(" in dq_entry
    assert "flash_tiles.cuh" not in qkv
    run_dq = qkv[qkv.index("int run_dq("):qkv.index("}  // namespace")]
    f32 = run_dq[run_dq.index("} else if (!is_bf16) {"):
                 run_dq.index("} else {")]
    assert "return k3_dq(" in f32
    bwd_dq = mh[mh.index("int bwd_dq("):mh.index("int split_fwd(")]
    assert "return launch_dq_tf32<D>(" in bwd_dq
    dq = (_build.CSRC / "wgmma_tf32_dq.cuh").read_text()
    launch = dq[dq.index("int launch_dq_tf32("):]
    assert "launch_dq_tf32_wide<D>(" in launch and "mh_dq_f32<D, " in launch
    assert "wgmma_tf32_dq.cuh" in _build.HEADERS


# --- the repaired checks (main_path) -----------------------------------------


def test_dq_is_held_by_the_precision_check():
    assert "dq" in TF32X3_OUTPUTS
    assert set(TF32X3_OUTPUTS) == set(main_path.OUTPUTS)


def test_one_column_rows_come_from_the_inputs():
    """main_path.one_column_rows: the samples with exactly one unmasked kv
    column (mh_inputs' sample 0), every sample at N = 1, none without a
    bias above N = 1; dQ's, dK's and dV's rows, never out's or lse's."""
    q, k, v, b = main_path.mh_inputs(3, 40, 2, 16, torch.float32, 0, "cpu")
    rows = main_path.one_column_rows(q, b, 2)
    assert rows["dq"].shape == (3, 40) and rows["lse"].shape == (3, 2, 40)
    assert rows["dq"][0].all() and not rows["dq"][1:].any()
    assert torch.equal(rows["dk"], rows["dq"]) and \
        torch.equal(rows["dv"], rows["dq"])
    assert not rows["out"].any() and not rows["lse"].any()
    assert not main_path.one_column_rows(q, None, 2)["dq"].any()
    q1, _, _, b1 = main_path.mh_inputs(3, 1, 2, 16, torch.float32, 0, "cpu")
    assert main_path.one_column_rows(q1, b1, 2)["dq"].all()
    assert main_path.one_column_rows(q1, None, 2)["dv"].all()


@pytest.mark.parametrize("B,N,H,D", [(2, 100, 1, 256), (2, 70, 2, 64),
                                     (3, 65, 1, 128)])
def test_a_dq_off_on_the_one_column_rows_is_rejected(B, N, H, D):
    """The plain versions on mh_inputs pass compare_with_plain; dQ moved
    on the one-column sample's rows only (planted_faults' third argument)
    is rejected, and so are the existing faults."""
    q, k, v, b = main_path.mh_inputs(B, N, H, D, torch.float32, 6, "cpu")
    got, want = main_path.mh_attention_against_plain(q, k, v, b, H,
                                                     D ** -0.5)
    assert want["loose_rows"]["dq"][0].all()
    assert not main_path.compare_with_plain(got, want)["beyond_bounds"]
    ignored, _ = main_path.mh_attention_against_plain(q, k, v, None, H,
                                                      D ** -0.5)
    faults = main_path.planted_faults(got, ignored, want)
    moved = faults["dq_one_column_rows_off"]["dq"] - got["dq"]
    assert moved[0].abs().min() > F32_ATOL["dq"] and not moved[1:].any()
    for name, outputs in faults.items():
        res = main_path.compare_with_plain(outputs, want)
        assert res["beyond_bounds"], name
    assert "dq" in main_path.compare_with_plain(
        faults["dq_one_column_rows_off"], want)["beyond_bounds"]


@pytest.mark.parametrize("sample,beyond", [(0, False), (1, True)])
def test_a_row_held_to_f64_outside_the_one_column_rows_fails(sample,
                                                             beyond):
    """A dV row where the plain version is 0.1 off float64 and the kernel
    0.01 (held to float64 by f32_rows_beyond's rule) passes in the
    one-column sample and fails in any other."""
    q, k, v, b = main_path.mh_inputs(2, 40, 1, 16, torch.float32, 2, "cpu")
    got, want = main_path.mh_attention_against_plain(q, k, v, b, 1, 0.25)
    want = dict(want, dv=want["dv"].clone())
    got = dict(got, dv=got["dv"].clone())
    row = want["exact"]["dv"][sample, 5]
    want["dv"][sample, 5] = (row + 0.1).float()
    got["dv"][sample, 5] = (row + 0.01).float()
    res = main_path.compare_with_plain(got, want)
    assert ("dv" in res["beyond_bounds"]) == beyond, res
    assert res["rows_held_to_f64"]["dv"] == (0 if beyond else 1)
    held = main_path.f32_rows_beyond(got["dv"], want["dv"],
                                     want["exact"]["dv"], F32_ATOL["dv"])
    assert held["held_to_f64"] == 1 and held["beyond"] == 0
    assert held["held"][sample, 5] and int(held["held"].sum()) == 1
