"""The numerics of the column-split f32 backward above head dim 256, whose
products run in 3xTF32 on the tensor cores
(mofo_tpu_torch/csrc/wgmma_tf32_split.cuh's split_dkv_tf32 and
split_dq_tf32), emulated on the CPU, where the kernels cannot run; the
index algebra of their groups, roles and walks; and the sources' routing.

The emulated walks do what the kernels do. D is kC = D / 64 chunks, the
output G = ceil(kC / 4) balanced groups (group g: chunks [g kC / G, (g +
1) kC / G)), each written by its own blocks: dK/dV's dV and dK blocks of
64 kv rows walk the q tiles, dQ's blocks of 64 query rows the kv tiles.
A score S^T (S) is a sum of one 3xTF32 product a 64-column chunk pair,
each into a fresh sum added in f32; dP^T (dP) starts at -delta and takes
one k-step of 8 columns at a time, each k-step summed in f32 into its
chunk's part, each part joining the sum by an exact two-sum whose error
opens the next chunk's part; P = exp(s + bias - lse) (base e), dS = P (dP
- delta); then each of the group's 64-column chunks of the output takes
one product a tile (dV_c += P^T dO_c, dK_c += dS^T (q * q_scale)_c, dQ_c
+= dS (K * k_scale)_c), into a fresh sum added in f32. A 3xTF32 product
is lo.hi + hi.lo + hi.hi, small terms first (the rna split of
tests/test_torch_tf32_split.py); 1xTF32 is the fault the precision check
must reject.

The emulation is held against mofo_tpu's interpret-mode kernels within
main_path.F32_ATOL (flash_attention_mh with a kv bias at 384 and 768,
flash_attention_qkv at 320, flash_attention (K4) at 320: the calls of
tests/test_torch_wide_head_dim.py), and against one float64 run: within
PRECISION_FACTOR of the plain f32 version's error, which 1xTF32 misses.
The card runs the checks on the kernels themselves (tests/test_torch_gpu.py,
chip_smoke.py's f32_precision and wide_head_dims phases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mofo_tpu.ops.flash_attention import flash_attention as jax_hm
from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu.ops.flash_attention import flash_attention_qkv as jax_qkv
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
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


TILE = CHUNK = 64  # rows of every tile, columns of a chunk of D
KSTEP = 8  # columns of D a k-step takes
GROUP_CHUNKS = 4  # chunks of the widest group: 256 columns
ENTRIES = 7  # the ring's (hi, lo) entries
SMEM = 232_448  # shared memory a block may take
WIDE_DIMS = [320, 384, 512, 768, 1024, 1088]


def groups(kc: int) -> list:
    """split_group_tf32 for every g: [(first chunk, chunks), ...]."""
    G = -(-kc // GROUP_CHUNKS)
    return [(g * kc // G, (g + 1) * kc // G - g * kc // G) for g in range(G)]


def _heads(x, H):
    B, N, A = x.shape
    return x.reshape(B, N, H, A // H).transpose(0, 2, 1, 3)


def _merge(x):
    B, H, N, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B, N, H * D)


def _t(x):
    return x.swapaxes(-1, -2)


def score_walk(a, b, mm):
    """a @ b^T over the last axis, one product a 64-column chunk, each
    into a fresh sum added in f32 (score_walk)."""
    s = mm(a[..., :CHUNK], _t(b[..., :CHUNK]))
    for c in range(CHUNK, a.shape[-1], CHUNK):
        s = s + mm(a[..., c:c + CHUNK], _t(b[..., c:c + CHUNK]))
    return s


def two_sum(a, b):
    """s + err = a + b exactly, s = fl(a + b) (f32 arrays)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def dp_walk(a, b, delta, mm=mm3, carried=True):
    """a @ b^T - delta as dp_walk forms it: from -delta, one k-step of 8
    columns at a time into its chunk's part, each part joining by an exact
    two-sum whose error opens the next part. carried=False: the walk of
    wgmma_tf32_wide.cuh's add_dp_chunk (the parts added to dP alone, delta
    subtracted at the end), for comparison."""
    shape = a.shape[:-1] + b.shape[-2:-1]
    dp = np.broadcast_to(-delta, shape).astype(np.float32) if carried \
        else np.zeros(shape, np.float32)
    carry = np.zeros(shape, np.float32)
    for c in range(0, a.shape[-1], CHUNK):
        part = carry
        for k in range(c, c + CHUNK, KSTEP):
            part = part + mm(a[..., k:k + KSTEP], _t(b[..., k:k + KSTEP]))
        if carried:
            dp, carry = two_sum(dp, part)
        else:
            dp = dp + part
    return dp if carried else dp - delta


def dkv_kernel(q, k, v, kv_bias, lse, delta, dout, scale, H, mm=mm3,
               carried=True):
    """split_dkv_tf32 as it runs (both roles, every group): q, k, v, dout
    (B, N, H D), lse and delta (B, H, N), kv_bias (B, N) or None. The dV
    and dK blocks of a group form the same S^T in the same order as every
    other group's. Returns (dk, dv)."""
    qh, kh, vh, do = (_heads(x, H) for x in (q, k, v, dout))
    B, _, N, D = qh.shape
    qs = qh * np.float32(scale)
    brow = (np.zeros((B, N), np.float32) if kv_bias is None
            else kv_bias)[:, None, :, None]  # the block's own kv rows
    dk, dv = np.zeros(kh.shape, np.float32), np.zeros(vh.shape, np.float32)
    for i in range(0, N, TILE):  # q tiles (rows past N add exact zeros)
        rows = slice(i, i + TILE)
        l_t, d_t = lse[:, :, None, rows], delta[:, :, None, rows]
        pt = np.exp(score_walk(kh, qs[:, :, rows], mm) + brow - l_t)
        dst = pt * dp_walk(vh, do[:, :, rows], d_t, mm, carried)
        for c0, n in groups(D // CHUNK):
            for c in range(CHUNK * c0, CHUNK * (c0 + n), CHUNK):
                dv[..., c:c + CHUNK] += mm(pt, do[:, :, rows, c:c + CHUNK])
                dk[..., c:c + CHUNK] += mm(dst, qs[:, :, rows, c:c + CHUNK])
    return _merge(dk), _merge(dv)


def dq_kernel(q, k, v, kv_bias, lse, delta, dout, scale, k_scale, H,
              mm=mm3):
    """split_dq_tf32 as it runs: returns dq (B, N, H D)."""
    qh, kh, vh, do = (_heads(x, H) for x in (q, k, v, dout))
    B, _, N, D = qh.shape
    qs = qh * np.float32(scale)
    ks = kh * np.float32(k_scale)  # K scaled before its split
    bias = np.zeros((B, N), np.float32) if kv_bias is None else kv_bias
    dq = np.zeros(qh.shape, np.float32)
    for j in range(0, N, TILE):  # kv tiles
        cols = slice(j, j + TILE)
        dp = dp_walk(do, vh[:, :, cols], delta[..., None], mm)
        s = score_walk(qs, kh[:, :, cols], mm) + bias[:, None, None, cols]
        ds = np.exp(s - lse[..., None]) * dp
        for c0, n in groups(D // CHUNK):
            for c in range(CHUNK * c0, CHUNK * (c0 + n), CHUNK):
                dq[..., c:c + CHUNK] += mm(ds, ks[:, :, cols, c:c + CHUNK])
    return _merge(dq)


def backward(q, k, v, kv_bias, dout, scale, H, mm=mm3, stats=None):
    """(dq, dk, dv) of the emulated kernels, lse from the port's plain
    forward and delta from fa.mh_delta (as the kernels' callers hand them
    over) unless `stats` gives them."""
    s = fa._rounded(scale, torch.float32)
    if stats is None:
        t = [None if x is None else torch.from_numpy(x)
             for x in (q, k, v, kv_bias)]
        out, lse = fa.attention_mh_fwd_plain(*t, scale, H)
        stats = (lse.numpy(), fa.mh_delta(out, torch.from_numpy(dout),
                                          H).numpy())
    lse, delta = stats
    dk, dv = dkv_kernel(q, k, v, kv_bias, lse, delta, dout, s, H, mm)
    return dq_kernel(q, k, v, kv_bias, lse, delta, dout, s, s, H, mm), dk, dv


def _inputs(B, N, H, D, bias=True, seed=0, std=1.0):
    """q, k, v (B, N, H D) f32 and a 0 / -1e30 kv bias row in which sample
    0 keeps one valid column (main_path.mh_inputs' masks) and every sample
    at least one; None without `bias`."""
    rng = np.random.RandomState(seed)
    q, k, v = ((std * rng.randn(B, N, H * D)).astype(np.float32)
               for _ in range(3))
    kv_bias = None
    if bias:
        valid = rng.rand(B, N) < 0.6
        valid[0] = False
        valid[0, N // 2] = True
        valid[1:, N // 3] = True
        kv_bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, kv_bias


def _close(got, want, names=("dq", "dk", "dv")):
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=F32_ATOL[n],
                                   rtol=0, err_msg=n)


# --- against mofo_tpu's interpret-mode kernels -------------------------------


@pytest.mark.parametrize("B,N,H,D", [(2, 70, 2, 384), (1, 100, 1, 768)])
def test_walks_match_the_tpu_k3(B, N, H, D):
    """K3 with the kv bias (the BB-focused MCA at 2 and 1 heads) against
    mofo_tpu's flash_attention_mh in interpret mode, within F32_ATOL, for a
    cotangent of std 1; masked kv rows get exactly zero dK and dV."""
    scale = D ** -0.5
    q, k, v, b = _inputs(B, N, H, D, std=0.5, seed=D)
    dout = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def fwd(q, k, v):
        return jax_mh(q, k, v, scale=scale, num_heads=H,
                      kv_bias=jnp.asarray(b), interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), *map(jnp.asarray, (q, k, v)))
    got = backward(q, k, v, b, dout, scale, H)
    _close(got, vjp(jnp.asarray(dout)))
    masked = b != 0
    assert not got[1][masked].any() and not got[2][masked].any()


def test_walks_match_the_tpu_k1k2():
    """K1/K2 at 320 (through K3's entry points: q, k and v column views of
    one fused qkv, no bias) against mofo_tpu's flash_attention_qkv in
    interpret mode."""
    B, N, H, D = 1, 70, 2, 320
    scale = D ** -0.5
    rng = np.random.RandomState(7)
    qkv = rng.randn(B, N, 3 * H * D).astype(np.float32)
    dout = rng.randn(B, N, H * D).astype(np.float32)
    A = H * D

    def fwd(x):
        return jax_qkv(x, scale=scale, num_heads=H, interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), jnp.asarray(qkv))
    (dqkv,) = vjp(jnp.asarray(dout))
    dqkv = np.asarray(dqkv)
    q, k, v = (np.ascontiguousarray(qkv[..., i * A:(i + 1) * A])
               for i in range(3))
    _close(backward(q, k, v, None, dout, scale, H),
           [dqkv[..., i * A:(i + 1) * A] for i in range(3)])


def test_walks_match_the_tpu_k4():
    """K4 at 320 ((B H, N, D) planes: one head a plane, no bias, its LSE a
    natural log) against mofo_tpu's flash_attention in interpret mode."""
    B, H, N, D = 1, 2, 70, 320
    scale = D ** -0.5
    rng = np.random.RandomState(11)
    q, k, v, dout = (rng.randn(B, H, N, D).astype(np.float32)
                     for _ in range(4))

    def fwd(q, k, v):
        return jax_hm(q, k, v, scale=scale, interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g).reshape(B * H, N, D) for g in
            vjp(jnp.asarray(dout))]
    planes = [x.reshape(B * H, N, D) for x in (q, k, v, dout)]
    t = [torch.from_numpy(x) for x in planes]
    out, lse = fa.attention_hm_fwd_plain(*t[:3], scale)
    stats = (lse.numpy()[:, None], fa.hm_delta(out, t[3]).numpy()[:, None])
    _close(backward(*planes[:3], None, planes[3], scale, 1, stats=stats),
           want)


# --- against float64 -----------------------------------------------------------


def _errors_vs_f64(q, k, v, b, H, scale, mm) -> tuple:
    """Max abs error of dq, dk, dv against main_path's float64 backward,
    for the plain f32 version and for the emulated kernels through `mm`;
    both take the f64 run's out and lse rounded to f32 and delta from
    them (main_path.mh_f32_precision's inputs)."""
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, b, dout)]
    ref = attention_mh_f64(*t, scale, H)
    out, lse = ref["out"].float(), ref["lse"].float()
    plain = fa.attention_mh_bwd_plain(*t[:4], out, lse, t[4], scale, H)
    stats = (lse.numpy(), fa.mh_delta(out, t[4], H).numpy())
    got = backward(q, k, v, b, dout, scale, H, mm, stats)
    names = ("dq", "dk", "dv")
    return ({n: float(np.abs(p.double().numpy() - ref[n].numpy()).max())
             for n, p in zip(names, plain)},
            {n: float(np.abs(g.astype(np.float64) - ref[n].numpy()).max())
             for n, g in zip(names, got)})


@pytest.mark.parametrize("B,N,H,D,bias", [(2, 100, 2, 384, True),
                                          (1, 70, 1, 768, True),
                                          (2, 100, 1, 320, False)])
def test_walks_are_as_precise_as_f32(B, N, H, D, bias):
    """Against one float64 run, each emulated output is within
    PRECISION_FACTOR of the plain f32 version's error, and 1xTF32 misses
    that bound."""
    x = _inputs(B, N, H, D, bias=bias, seed=3)
    plain, tf32x3 = _errors_vs_f64(*x, H, D ** -0.5, mm3)
    _, tf32 = _errors_vs_f64(*x, H, D ** -0.5, mm1)
    for n in plain:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > PRECISION_FACTOR * plain[n], (n, tf32, plain)


def test_dp_walk_carries_its_rounding_error():
    """Where P is 1 (a one-column sample) and the cotangent is 2 out, dP
    and delta are both about 2 |v|^2 = 2 D and dS = P (dP - delta) is what
    is left of their difference. At D = 1024 an f32 sum at that size
    rounds by 2.4e-4 an ulp: dp_walk starts at -delta and carries each
    chunk's rounding error into the next chunk, so dP - delta keeps only
    the k-step sums' roundings, several times less than what the walk
    that adds the chunks to dP alone (wgmma_tf32_wide.cuh's add_dp_chunk)
    leaves. Rows near 2 w + noise against columns near w, delta the
    float64 row sums' rounded mean, the errors against float64's dP -
    delta over 64 x 64 entries."""
    D = 1024
    rng = np.random.RandomState(13)
    w = rng.randn(D)
    b = (w + 0.01 * rng.randn(TILE, D)).astype(np.float32)
    a = (2 * w + 0.01 * rng.randn(TILE, D)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    delta = exact.mean(-1, keepdims=True).astype(np.float32)
    want = exact - delta
    rms = {carried: float(np.sqrt(np.mean(
        (dp_walk(a, b, delta, mm3, carried) - want) ** 2)))
        for carried in (True, False)}
    assert rms[True] * 3 < rms[False], rms


# --- the index algebra -----------------------------------------------------------


def split_entry(role: str, kc: int, c0: int, r: int) -> tuple:
    """wgmma_tf32_split.cuh's split_entry_tf32(role, kC, c0, r): (tensor,
    chunk, transposed, own rows), tensor 0 q, 1 k, 2 v, 3 dO."""
    pair_entries = (2 if role == "dv" else 4) * kc
    if r >= pair_entries:
        return ({"dq": 1, "dv": 3, "dk": 0}[role], c0 + r - pair_entries,
                True, False)
    b = bool(r & 1)
    scores = role == "dv" or r >= 2 * kc
    x = b != (role == "dq")
    return ((0 if x else 1) if scores else (3 if x else 2), (r >> 1) % kc,
            False, not b)


def walk(role: str, kc: int, c0: int, n: int) -> list:
    return [split_entry(role, kc, c0, r)
            for r in range((2 if role == "dv" else 4) * kc + n)]


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_every_output_column_has_one_writer(D):
    """G = ceil(D / 256) groups (chip_smoke.split_groups), balanced over
    the chunks, 3 or 4 chunks the widest (the kernels' template NG), as
    main_path.split_group_columns lays them out in f32; across groups x
    roles (dV, dK and dQ blocks) every column of dV, dK and dQ is written
    once."""
    kc = D // CHUNK
    gs = groups(kc)
    assert len(gs) == chip_smoke.split_groups(D)
    assert max(n for _, n in gs) in (3, 4)
    assert max(n for _, n in gs) - min(n for _, n in gs) <= 1
    assert main_path.split_group_columns(D, True) == \
        [(CHUNK * c0, CHUNK * n) for c0, n in gs]
    for role in ("dv", "dk", "dq"):
        cols = [CHUNK * e[1] + x for c0, n in gs
                for e in walk(role, kc, c0, n) if e[2]
                for x in range(CHUNK)]
        assert sorted(cols) == list(range(D)), role


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_chunk_products_per_tile_pair(D):
    """A (kv, q) tile pair's chunk products, summed over the groups' blocks:
    a pair of entries or one transposed entry each, (3 G + 2) kC for dK/dV
    and (2 G + 1) kC for dQ: chip_smoke.products(G), on which
    bound_recompute_ms rests."""
    kc = D // CHUNK
    gs = groups(kc)

    def products(role):
        return sum(sum(1 for e in walk(role, kc, c0, n) if e[2]) +
                   sum(1 for e in walk(role, kc, c0, n) if not e[2]) // 2
                   for c0, n in gs)

    want = chip_smoke.products(len(gs))
    assert products("dv") + products("dk") == want["dkv"] * kc
    assert products("dq") == want["dq"] * kc


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_the_walks(D):
    """Each pair is (A at the block's own rows, B at the tile's), one
    chunk of each: the dV block (K_c, q_c) -> S^T; the dK block (V_c,
    dO_c) -> dP^T, then (K_c, q_c); the dQ block (dO_c, V_c) -> dP, then
    (q_c, K_c) -> S; every chunk once a walk; then the group's chunks
    transposed at the tile's rows: dO (dV), q (dK), K (dQ). The producer
    multiplies q by q_scale and K transposed by k_scale only."""
    kc = D // CHUNK
    pairs = {"dv": [(1, 0)], "dk": [(2, 3), (1, 0)], "dq": [(3, 2), (0, 1)]}
    closing = {"dv": 3, "dk": 0, "dq": 1}
    for c0, n in groups(kc):
        for role, ps in pairs.items():
            w = walk(role, kc, c0, n)
            for p, (ta, tb) in enumerate(ps):
                got = w[2 * kc * p:2 * kc * (p + 1)]
                assert got[0::2] == [(ta, c, False, True) for c in range(kc)]
                assert got[1::2] == [(tb, c, False, False)
                                     for c in range(kc)]
            assert w[len(ps) * 2 * kc:] == [(closing[role], c0 + c, True,
                                             False) for c in range(n)]
            scaled = {e[0] for e in w if e[0] == 1 and e[2]}
            assert scaled == ({1} if role == "dq" else set())


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_per_tile_values_live_long_enough(D):
    """Tile j's values (dK/dV: the q tile's LSE and delta; dQ: the kv
    tile's bias row) live in slot j % 2, written when the producer splits
    the tile's first entry e0(j) = ept j, whose load starts once the
    consumer is done with entry e0(j) - ENTRIES; tile j - 2's values are
    read before its pair walks end (dp_walk's first chunk and the P
    after the scores): e0(j) - ENTRIES >= e0(j - 2) + pair entries. The
    ring holds a pair and its refill: ENTRIES > 2."""
    kc = D // CHUNK
    for c0, n in groups(kc):
        for role in ("dv", "dk", "dq"):
            pairs = (2 if role == "dv" else 4) * kc
            ept = pairs + n
            for j in range(2, 30):
                assert ept * j - ENTRIES >= ept * (j - 2) + pairs
    assert ENTRIES > 2


def test_the_block_fits_shared_memory():
    """1024 bytes of alignment, ENTRIES (hi, lo) 64 x 64 f32 entries, the
    per-tile values two tiles deep (1 KB), 2 ENTRIES + 1 barriers: at most
    the 232,448 bytes a block may take, with no room for an eighth entry;
    and a resident 64 x D (hi, lo) strip (512 D bytes) leaves no room for
    a ring of three entries (a pair and one load in flight) at any D above
    256."""
    entry = 2 * CHUNK * CHUNK * 4
    smem = 1024 + ENTRIES * entry + 4 * CHUNK * 4 + (2 * ENTRIES + 1) * 8
    assert smem == 231_544 <= SMEM
    assert smem + entry > SMEM
    for D in WIDE_DIMS:
        assert 1024 + 512 * D + 3 * entry > SMEM


def test_the_sources_route_the_f32_backward_above_256():
    """No FMA column-split backward is left (nor its forward, nor
    flash_split_f32.cuh, which held them), and split_dkv / split_dq in
    K3's f32 launchers (mh_flash_attention_f32.cu) launch
    wgmma_tf32_split.cuh's kernels, whose constants are the ones emulated
    here; K4's f32 backward reaches them through those launchers (its own
    split_dkv / split_dq are bf16 only), and K4's split_fwd launches the
    f32 one itself, as K3's does (tests/test_torch_tf32_fwd.py)."""
    src = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    for name, text in src.items():
        assert "split_bwd_dq_f32" not in text, name
        assert "split_bwd_dkv_f32" not in text, name
        assert "launch_split_dq_f32" not in text, name
        assert "launch_split_dkv_f32" not in text, name
    assert "wgmma_tf32_split.cuh" in _build.HEADERS
    # K3's f32 launchers are mh_flash_attention_f32.cu's, and K4's f32
    # backward is theirs (tests/test_torch_tf32_k4_bwd.py)
    for name in ("mh_flash_attention_f32.cu", "hm_flash_attention.cu"):
        text = src[name]
        assert '#include "wgmma_tf32_split.cuh"' in text
        dkv = text[text.index("int split_dkv("):text.index("int split_dq(")]
        dq = text[text.index("int split_dq("):text.index("}  // namespace",
                                                         text.index(
                                                             "int split_dq("))]
        k3 = name == "mh_flash_attention_f32.cu"
        assert ("launch_split_dkv_tf32(" in dkv) == k3, name
        assert ("launch_split_dq_tf32(" in dq) == k3, name
    hm = src["hm_flash_attention.cu"]
    assert "!is_bf16 ? mh_f32_dkv(" in hm and "!is_bf16 ? mh_f32_dq(" in hm
    header = src["wgmma_tf32_split.cuh"]
    assert f"kSplitEntries = {ENTRIES};" in header
    assert f"kSplitGroupChunks = {GROUP_CHUNKS};" in header
    for kernel in ("split_dkv_tf32(", "split_dq_tf32("):
        assert kernel in header
    assert "flash_split_f32.cuh" not in src
    assert "flash_split_f32.cuh" not in _build.HEADERS
    for name in ("mh_flash_attention_f32.cu", "hm_flash_attention.cu"):
        text = src[name]
        fwd = text[text.index("int split_fwd("):text.index("int split_dkv(")]
        assert "launch_split_fwd_tf32<" in fwd, name
        assert "split_fwd_f32" not in text, name
