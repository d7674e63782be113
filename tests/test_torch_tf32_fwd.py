"""The numerics of the f32 forwards whose products run in 3xTF32 on the
tensor cores, emulated on the CPU, where the kernels cannot run:

  - the narrow forward (mofo_tpu_torch/csrc/wgmma_tf32_fwd.cuh's fwd_f32):
    K1 at every head dim up to 128 and K3 there with its bias row;
  - the column-split forward above head dim 256
    (csrc/wgmma_tf32_split.cuh's split_fwd_tf32): K1/K2 through K3's entry
    points, K3 with its kv bias, and K4 in two passes;

the index algebra of the column-split forward's groups and walks; and the
sources' routing.

The emulated walks do what the kernels do. q * q_scale in f32; per 64-row
kv tile the scores S = (q * q_scale) K^T through one 3xTF32 product over
D (narrow) or one a 64-column chunk pair, each into a fresh sum added in
f32 (column-split); the bias row after the fold; an online softmax in
base e (K4: pass 1 the row statistics, pass 2 P = exp(s - m) / l); then
P V, a 3xTF32 product a 64-column chunk of the output into a fresh sum
added in f32; 1 / l dividing the output at the end (K4: none); the LSE
m + log(l). The output of the column-split forward is G = ceil(D / 256)
balanced groups of 64-column chunks, each written by its own blocks, which
all form the same S. A 3xTF32 product is lo.hi + hi.lo + hi.hi, small terms
first (the rna split of tests/test_torch_tf32_split.py); 1xTF32 is the
fault the precision check must reject.

The emulations are held against mofo_tpu's interpret-mode kernels within
main_path.F32_ATOL (out; the LSE against the port's plain version, which
the other CPU tests hold against them), and against one float64 run:
within PRECISION_FACTOR of the plain f32 version's error, which 1xTF32
misses. The card runs the checks on the kernels themselves
(tests/test_torch_gpu.py, chip_smoke.py's f32_precision and
wide_head_dims phases).
"""

import re

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
from test_torch_tf32_colsplit import (
    CHUNK,
    ENTRIES,
    SMEM,
    TILE,
    WIDE_DIMS,
    _heads,
    _inputs,
    _merge,
    _t,
    groups,
    score_walk,
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


def fwd_walk(q, k, v, kv_bias, scale, H, mm=mm3, two_pass=False):
    """The f32 forward as the kernel at q's head dim runs it: q, k, v (B,
    N, H D) f32, kv_bias (B, N) or None. Returns (out (B, N, H D), lse (B,
    H, N))."""
    qh, kh, vh = (_heads(x, H) for x in (q, k, v))
    B, _, N, D = qh.shape
    qs = qh * np.float32(scale)
    bias = np.zeros((B, N), np.float32) if kv_bias is None else kv_bias
    wide = D > 256

    def scores(j):
        cols = slice(j, j + TILE)
        s = score_walk(qs, kh[:, :, cols], mm) if wide else \
            mm(qs, _t(kh[:, :, cols]))
        return s + bias[:, None, None, cols]

    def pv(o, p, j):
        """o += P V_j a 64-column chunk (a group's chunks, every group's
        above 256; the narrow kernel's chains of 64 output columns)."""
        step = min(CHUNK, D)
        for c in range(0, D, step):
            o[..., c:c + step] += mm(p, vh[:, :, j:j + TILE, c:c + step])

    m = np.full(qh.shape[:3] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    o = np.zeros(qh.shape, np.float32)
    for j in range(0, N, TILE):
        s = scores(j)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdims=True)
        m = m_new
        if not two_pass:
            o = o * corr
            pv(o, p, j)
    if two_pass:
        for j in range(0, N, TILE):
            pv(o, np.exp(scores(j) - m) / l, j)
    else:
        o = o / l
    return _merge(o), (m + np.log(l))[..., 0]


def _plain_mh(q, k, v, b, scale, H):
    t = [None if x is None else torch.from_numpy(x) for x in (q, k, v, b)]
    out, lse = fa.attention_mh_fwd_plain(*t, scale, H)
    return out.numpy(), lse.numpy()


def _close(name, got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL[name],
                               rtol=0, err_msg=name)


# --- against mofo_tpu's interpret-mode kernels -------------------------------


@pytest.mark.parametrize("B,N,H,D", [(2, 70, 2, 384), (1, 100, 1, 768),
                                     (2, 70, 2, 128), (2, 100, 2, 64)])
def test_forward_walks_match_the_tpu_k3(B, N, H, D):
    """K3 with the kv bias (the BB-focused MCA at 2 and 1 heads: the
    column-split forward; at 8 and 16 heads: the narrow one) against
    mofo_tpu's flash_attention_mh in interpret mode, within F32_ATOL; the
    LSE against the port's plain version."""
    scale = D ** -0.5
    q, k, v, b = _inputs(B, N, H, D, std=0.5, seed=D)
    want = jax_mh(*map(jnp.asarray, (q, k, v)), scale=scale, num_heads=H,
                  kv_bias=jnp.asarray(b), interpret=True)
    out, lse = fwd_walk(q, k, v, b, fa._rounded(scale, torch.float32), H)
    _close("out", out, want)
    _close("lse", lse, _plain_mh(q, k, v, b, scale, H)[1])


@pytest.mark.parametrize("D", [320, 64])
def test_forward_walks_match_the_tpu_k1(D):
    """K1 at 320 (through K3's entry points: q, k and v column views of one
    fused qkv, no bias: the column-split forward) and at 64 (the narrow
    one) against mofo_tpu's flash_attention_qkv in interpret mode."""
    B, N, H = 1, 70, 2
    scale = D ** -0.5
    qkv = np.random.RandomState(7).randn(B, N, 3 * H * D).astype(np.float32)
    want = jax_qkv(jnp.asarray(qkv), scale=scale, num_heads=H,
                   interpret=True)
    A = H * D
    q, k, v = (np.ascontiguousarray(qkv[..., i * A:(i + 1) * A])
               for i in range(3))
    out, lse = fwd_walk(q, k, v, None, fa._rounded(scale, torch.float32), H)
    _close("out", out, want)
    _close("lse", lse, fa.attention_qkv_fwd_plain(
        torch.from_numpy(qkv), scale, H)[1].numpy())


def test_forward_walk_matches_the_tpu_k4():
    """K4 at 320 ((B H, N, D) planes, no bias, two passes: p / l before
    P.V) against mofo_tpu's flash_attention in interpret mode."""
    B, H, N, D = 1, 2, 70, 320
    scale = D ** -0.5
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_hm(*map(jnp.asarray, (q, k, v)), scale=scale,
                             interpret=True)).reshape(B * H, N, D)
    planes = [x.reshape(B * H, N, D) for x in (q, k, v)]
    out, lse = fwd_walk(*planes, None, fa._rounded(scale, torch.float32), 1,
                        two_pass=True)
    _close("out", out, want)
    _close("lse", lse[:, 0], fa.attention_hm_fwd_plain(
        *map(torch.from_numpy, planes), scale)[1].numpy())


# --- against float64 -----------------------------------------------------------


def _fwd_errors_vs_f64(q, k, v, b, H, scale, mm, two_pass=False):
    """Max abs error of out and lse against main_path's float64 forward for
    the plain f32 version and for the emulated kernel through `mm`."""
    dout = np.zeros_like(q)
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, b, dout)]
    ref = attention_mh_f64(*t, scale, H)
    plain = _plain_mh(q, k, v, b, scale, H)
    got = fwd_walk(q, k, v, b, fa._rounded(scale, torch.float32), H, mm,
                   two_pass)
    return ({n: float(np.abs(p.astype(np.float64) - ref[n].numpy()).max())
             for n, p in zip(("out", "lse"), plain)},
            {n: float(np.abs(g.astype(np.float64) - ref[n].numpy()).max())
             for n, g in zip(("out", "lse"), got)})


@pytest.mark.parametrize("B,N,H,D,bias,two_pass", [
    (2, 100, 2, 384, True, False), (2, 70, 1, 768, True, False),
    (2, 100, 4, 128, True, False), (2, 100, 4, 64, True, False),
    (2, 100, 1, 320, False, True)])
def test_forward_walks_are_as_precise_as_f32(B, N, H, D, bias, two_pass):
    """Against one float64 run, the emulated out and lse are within
    PRECISION_FACTOR of the plain f32 version's error, and 1xTF32 misses
    that bound (K4's two passes: one head a plane, its function K3's
    without a bias, as main_path.hm_f32_precision holds it)."""
    x = _inputs(B, N, H, D, bias=bias, seed=3)
    plain, tf32x3 = _fwd_errors_vs_f64(*x, H, D ** -0.5, mm3, two_pass)
    _, tf32 = _fwd_errors_vs_f64(*x, H, D ** -0.5, mm1, two_pass)
    for n in plain:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > PRECISION_FACTOR * plain[n], (n, tf32, plain)


# --- the column-split forward's index algebra --------------------------------


def fwd_entry(kc: int, c0: int, r: int) -> tuple:
    """wgmma_tf32_split.cuh's split_entry_tf32(kRoleFwd, kC, c0, r):
    (tensor, chunk, transposed, own rows), tensor 0 q, 1 k, 2 v."""
    if r >= 2 * kc:
        return (2, c0 + r - 2 * kc, True, False)
    return (1 if r & 1 else 0, r >> 1, False, not r & 1)


def fwd_step(two_pass: bool, kc: int, n: int, T: int, e: int) -> tuple:
    """split_fwd_step: step e of a block's walk as (tile, r), the tile
    counted over both passes."""
    pairs = 2 * kc
    e1 = pairs * T if two_pass else 0
    if e < e1:
        return e // pairs, e % pairs
    return (T if two_pass else 0) + (e - e1) // (pairs + n), \
        (e - e1) % (pairs + n)


def fwd_walk_entries(two_pass: bool, kc: int, c0: int, n: int, T: int):
    """Every entry of a block's walk over T kv tiles: (tile, entry)."""
    total = (2 * kc * T if two_pass else 0) + (2 * kc + n) * T
    return [(fwd_step(two_pass, kc, n, T, e)[0],
             fwd_entry(kc, c0, fwd_step(two_pass, kc, n, T, e)[1]))
            for e in range(total)]


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_every_forward_output_column_has_one_writer(D, two_pass):
    """G = ceil(D / 256) balanced groups (main_path.split_group_columns in
    f32, the group fault's layout); the transposed V chunks that close a
    walk write the output: across the groups every column of out is
    written once a kv tile (in pass 2 alone with two passes), and group 0
    alone writes the LSE."""
    kc = D // CHUNK
    gs = groups(kc)
    assert len(gs) == chip_smoke.split_groups(D)
    assert main_path.split_group_columns(D, True) == \
        [(CHUNK * c0, CHUNK * n) for c0, n in gs]
    T = 3
    for tile in range(T):
        cols = [CHUNK * e[1] + x for c0, n in gs
                for t, e in fwd_walk_entries(two_pass, kc, c0, n, T)
                if e[2] and t % T == tile for x in range(CHUNK)]
        assert sorted(cols) == list(range(D))
    lse_writers = [g for g in range(len(gs)) if g == 0]
    assert lse_writers == [0]


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_forward_chunk_products_per_tile_pair(D):
    """A (q, kv) tile pair's chunk products over the groups' blocks, a
    pair of entries or one transposed entry each: (G + 1) kC in one pass,
    (2 G + 1) kC in K4's two: chip_smoke.products(G)["fwd"], on which
    bound_recompute_ms rests."""
    kc = D // CHUNK
    gs = groups(kc)
    for two_pass in (False, True):
        T = 4
        got = sum(sum(1 for _, e in w if e[2]) +
                  sum(1 for _, e in w if not e[2]) // 2
                  for w in (fwd_walk_entries(two_pass, kc, c0, n, T)
                            for c0, n in gs))
        want = chip_smoke.products(len(gs), two_pass=two_pass)["fwd"]
        assert got == want * kc * T, (two_pass, got)


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_the_forward_walk(D):
    """Each pair is (q_c at the block's own query rows, K_c at the tile's),
    every chunk once a tile; then the group's V chunks transposed at the
    tile's rows; pass 1 of K4's walk takes the pairs alone. The producer
    multiplies q by q_scale alone (split_mul_tf32: K transposed would take
    k_scale; the forward transposes V only)."""
    kc = D // CHUNK
    for c0, n in groups(kc):
        for two_pass in (False, True):
            T = 2
            w = fwd_walk_entries(two_pass, kc, c0, n, T)
            tiles = sorted({t for t, _ in w})
            assert tiles == list(range(2 * T if two_pass else T))
            for tile in tiles:
                ent = [e for t, e in w if t == tile]
                assert ent[0::2][:kc] == [(0, c, False, True)
                                          for c in range(kc)]
                assert ent[1::2][:kc] == [(1, c, False, False)
                                          for c in range(kc)]
                closing = [] if two_pass and tile < T else \
                    [(2, c0 + c, True, False) for c in range(n)]
                assert ent[2 * kc:] == closing
            assert not any(e[0] == 1 and e[2] for _, e in w)


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_forward_bias_rows_live_long_enough(D):
    """Tile t's bias row lives in slot t % 4, written when the producer
    splits the tile's first entry e0(t), whose load starts once the
    consumer is done with entry e0(t) - ENTRIES; above 256 even tile t -
    2's row is read after its pair walk: e0(t) - ENTRIES >= e0(t - 2) + 2
    kC, over both passes of K4's walk too (at 192 and 256:
    tests/test_torch_tf32_k4_fwd_k3_dkv.py)."""
    kc = D // CHUNK
    for c0, n in groups(kc):
        for two_pass in (False, True):
            T = 6
            w = fwd_walk_entries(two_pass, kc, c0, n, T)
            e0 = [next(i for i, (t, _) in enumerate(w) if t == tile)
                  for tile in range(2 * T if two_pass else T)]
            for t in range(2, len(e0)):
                assert e0[t] - ENTRIES >= e0[t - 2] + 2 * kc


def test_the_forwards_fit_shared_memory():
    """The column-split forward takes the backward's layout (1024 bytes of
    alignment, ENTRIES (hi, lo) 64 x 64 entries, four tiles' bias rows in
    its 1 KB of per-tile values, 2 ENTRIES + 1 barriers): 231,544 bytes.
    The narrow forward (FwdF32): 1024 bytes of alignment, its q tiles,
    its entries (a (hi, lo) pair of 64 x D tiles each), a 64-float bias row
    a slot and 3 entries + 1 barriers, at most 232,448 bytes at every head
    dim it takes, with no room for a third entry at 128."""
    entry = 2 * CHUNK * CHUNK * 4
    assert 1024 + ENTRIES * entry + 4 * CHUNK * 4 + \
        (2 * ENTRIES + 1) * 8 == 231_544 <= SMEM

    def narrow(D, entries):
        wgs, q_tiles = (1, 2) if D == 128 else (2, 1)
        tile = 64 * D * 4
        return 1024 + (wgs * q_tiles + 2 * entries) * tile + \
            entries * 64 * 4 + (3 * entries + 1) * 8
    sizes = {16: narrow(16, 8), 32: narrow(32, 8), 64: narrow(64, 5),
             128: narrow(128, 2)}
    assert sizes == {16: 77_000, 32: 150_728, 64: 199_040, 128: 198_200}
    assert max(sizes.values()) <= SMEM
    assert narrow(128, 3) > SMEM
    header = (_build.CSRC / "wgmma_tf32_fwd.cuh").read_text()
    assert "kEntries = D == 128 ? 2 : D == 64 ? 5 : 8;" in header


# --- the sources -----------------------------------------------------------------


def test_the_sources_route_the_f32_forwards():
    """No FMA f32 forward is left (split_fwd_f32, mh_fwd_f32, their shared
    memory and flash_split_f32.cuh are gone): K1 launches
    wgmma_tf32_fwd.cuh's kernel without the bias flag and K3 with it up to
    128 (K3's f32 launchers in mh_flash_attention_f32.cu, which its entry
    point calls for float); K3's and K4's f32 split_fwd launch
    wgmma_tf32_split.cuh's split_fwd_tf32 (K4 in two passes)."""
    src = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    assert "flash_split_f32.cuh" not in src
    assert "wgmma_tf32_fwd.cuh" in _build.HEADERS
    for name, text in src.items():
        code = re.sub(r"//[^\n]*", "", text)  # the notes may name them
        for gone in ("split_fwd_f32", "mh_fwd_f32", "flash_split_f32.cuh",
                     "launch_split_fwd_f32"):
            assert gone not in code, (name, gone)
    qkv, hm = src["qkv_flash_attention.cu"], src["hm_flash_attention.cu"]
    mh = src["mh_flash_attention_f32.cu"]  # K3's f32 launchers
    for text in (qkv, mh):
        assert '#include "wgmma_tf32_fwd.cuh"' in text
    run_fwd = qkv[qkv.index("int run_fwd("):qkv.index("int fused_maps(")]
    assert "launch_fwd_f32<D, false>(" in run_fwd
    entry = src["mh_flash_attention.cu"]
    assert "smem_fwd_f32" not in entry + mh  # nor K4's (it went too)
    fwd_entry = entry[entry.index('extern "C" int mh_attn_fwd('):]
    assert "!bf16 ? mh_f32_fwd(" in fwd_entry
    fwd = mh[mh.index("int fwd("):mh.index("int bwd_dkv(")]
    assert "launch_fwd_f32<D, true>(" in fwd
    assert "launch_fwd_tf32<D>(" in fwd
    for text, two_pass in ((mh, "false"), (hm, "true")):
        split_fwd = text[text.index("int split_fwd("):
                         text.index("int split_dkv(")]
        assert f"launch_split_fwd_tf32<{two_pass}>(" in split_fwd
    header = src["wgmma_tf32_split.cuh"]
    assert "split_fwd_tf32(" in header and "kRoleFwd" in header


def test_the_sum_probe_needs_a_card():
    """tools/tf32_sum_probe.py (the tensor cores' TF32 sums, and the
    one-column row at D = 1024) refuses to run without a CUDA device, and
    its kernel is one k-step of wgmma_tf32.cuh's products."""
    from mofo_tpu_torch.tools import tf32_sum_probe

    assert tf32_sum_probe.main([]) == 2
    assert '#include "wgmma_tf32.cuh"' in tf32_sum_probe.SOURCE
    assert "wgmma_tf32_ss(acc, " in tf32_sum_probe.SOURCE


def test_the_sum_model_follows_the_probe():
    """tools/tf32_sum_probe.py's numpy model of a tensor-core k-step gives
    what the one-k-step probe read on the card for the same sums (1 + 0.75
    ulp and its negative cut to +-1; [1, -1, 2^-25] keeps 2^-25 and [1, -1,
    2^-26] gives 0; -3 * 2^-26 comes back as -2^-25), and its run of the
    column-split backward's dP walk over the one-column row at D = 1024
    (N = 65) is biased low, as the split alone is (its dropped lo.lo term),
    with each variant's bias smaller than the kernel walk's."""
    from mofo_tpu_torch.tools import tf32_sum_probe as P

    def one(c, *prods):
        a = np.zeros((1, 8), np.float32)
        a[0, :len(prods)] = prods
        return float(P.model_sum(np.full((1, 1), c, np.float32), a,
                                 np.ones((1, 8), np.float32))[0, 0])
    u = 2.0 ** -23
    assert one(0.0, 1.0, 0.75 * u) == 1.0
    assert one(0.0, -1.0, -0.75 * u) == -1.0
    assert one(0.0, 1.0, -1.0, 2.0 ** -25) == 2.0 ** -25
    assert one(0.0, 1.0, -1.0, 2.0 ** -26) == 0.0
    assert one(1.0, -1.0, 2.0 ** -25) == 2.0 ** -25
    assert one(0.0, 1.0, -1.0, -3 * 2.0 ** -26) == -(2.0 ** -25)
    res = P.model_one_column()
    walk = res["walk_err"]
    assert res["split_err"] < 0 and all(e < 0 for e in walk.values()), res
    assert abs(walk["centred_lolo"]) < abs(walk["centred"]) < \
        abs(walk["kernel"]), res
