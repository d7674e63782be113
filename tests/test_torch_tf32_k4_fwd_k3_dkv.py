"""The numerics of K4's f32 forward up to head dim 256 and of K3's f32
dK/dV up to 128, whose products run in 3xTF32 on the tensor cores,
emulated on the CPU, where the kernels cannot run:

  - K4's forward in two passes: up to 128 the narrow forward
    (mofo_tpu_torch/csrc/wgmma_tf32_fwd.cuh's fwd_f32<D, false, true>,
    K1's and K3's kernel), at 192 and 256 the column-split one at one
    output group (csrc/wgmma_tf32_split.cuh's split_fwd_tf32<NG, true>);
  - K3's dK/dV with its kv bias on K2's kernel
    (csrc/wgmma_tf32_dkv.cuh's bwd_dkv_f32<D, true>);

the walks' index algebra, the blocks' shared memory, the sources' routing
and the tools that time and trace these kernels.

The emulated walks do what the kernels do. K4's forward: q * q_scale in
f32; pass 1 per 64-row kv tile S = (q * q_scale) K^T through one 3xTF32
product over D (narrow) or one a 64-column chunk pair, each into a fresh
sum added in f32 (column-split), the ragged tile's columns past N at
-inf, the row's m and l by an online softmax in base e; pass 2 the same S,
P = exp(s - m) / l, O += P V a 64-column chunk of the output at a time
into a fresh sum added in f32; no 1 / l at the end; the LSE m + log(l).
K3's dK/dV: delta = rowsum(dO * O) from the caller (fa.mh_delta); per q
tile (64 rows, 32 at D = 128) S^T = K (q * q_scale)^T through one 3xTF32
product over D and dP^T = V dO^T one a k-step of 8 columns, each into a
fresh sum added in f32, lo.lo included (K2's, without the bias, one
product over D), P^T = exp(S^T + bias - lse) with the kv row's bias after
the fold, dS^T = P^T (dP^T - delta), dV += P^T dO
and dK += dS^T (q * q_scale), each a 64-column chain of the output into a
fresh sum added in f32. A 3xTF32 product is lo.hi + hi.lo + hi.hi, small
terms first (tests/test_torch_tf32_split.py's rna split); 1xTF32 is the
fault the precision checks must reject.

The walks are held against mofo_tpu's interpret-mode kernels within
main_path.F32_ATOL (the LSE against the port's plain version, which the
other CPU tests hold against them; K3's dK and dV with dout = 2 out row by
row as main_path.f32_rows_beyond holds them), and against one float64
run: within PRECISION_FACTOR of the plain f32 version's error, which
1xTF32 misses. The card runs the same checks on the kernels themselves
(tests/test_torch_gpu.py, chip_smoke.py's f32_precision phase).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mofo_tpu.ops.flash_attention import flash_attention as jax_hm
from mofo_tpu.ops.flash_attention import flash_attention_mh as jax_mh
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import f32_ab
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
    attention_mh_f64,
    f32_rows_beyond,
    mh_backward_f64,
)
from mofo_tpu_torch.tools.profile_step import _group
from test_torch_tf32_colsplit import (
    CHUNK,
    ENTRIES,
    SMEM,
    _heads,
    _inputs,
    _merge,
    _t,
    groups,
    score_walk,
)
from test_torch_tf32_fwd import fwd_walk, fwd_walk_entries
from test_torch_tf32_split import mm1, mm3, split

NARROW_DIMS = (16, 32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


# --- the emulated walks ----------------------------------------------------------


def k4_fwd_walk(q, k, v, scale, mm=mm3):
    """K4's f32 forward as its kernel at the head dim runs it, on (B H, N,
    D) planes: two passes over 64-row kv tiles; S through one product over
    D up to 128 (the narrow kernel), one a 64-column chunk pair at 192 and
    256 (the column-split kernel at one group). (out (B H, N, D), lse (B
    H, N))."""
    qs = q * np.float32(scale)
    N, D = q.shape[1:]

    def scores(j):
        kt = k[:, j:j + CHUNK]
        s = mm(qs, _t(kt)) if D <= 128 else score_walk(qs, kt, mm)
        return s  # a ragged tile has no columns past N here

    m = np.full(q.shape[:2] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    for j in range(0, N, CHUNK):  # pass 1: the row's m and l
        s = scores(j)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        l = l * np.exp(m - m_new) + np.exp(s - m_new).sum(-1, keepdims=True)
        m = m_new
    o = np.zeros(q.shape, np.float32)
    step = min(CHUNK, D)
    for j in range(0, N, CHUNK):  # pass 2: P = exp(s - m) / l, P V
        p = np.exp(scores(j) - m) / l
        for c in range(0, D, step):
            o[..., c:c + step] += mm(p, v[:, j:j + CHUNK, c:c + step])
    return o, (m + np.log(l))[..., 0]


def mm4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in 3xTF32 with the lo.lo term too (the biased dK/dV kernel's
    dP^T k-steps): lo.lo + lo.hi + hi.lo + hi.hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bl + al @ bh + ah @ bl + ah @ bh


def _stepped(a, b, mm, step):
    """a @ b^T over the last axis, `step` columns a product, each into a
    fresh sum added in f32."""
    s = mm(a[..., :step], _t(b[..., :step]))
    for c in range(step, a.shape[-1], step):
        s = s + mm(a[..., c:c + step], _t(b[..., c:c + step]))
    return s


def dkv_walk(q, k, v, kv_bias, out, lse, dout, scale, H, mm=mm3):
    """bwd_dkv_f32<D, kBias> as it runs on q, k, v, out, dout (B, N, H D),
    lse (B, H, N) and the (B, N) kv bias or None: (dk, dv). With the bias
    dP^T is summed one k-step (8 columns of D) a fresh sum, with the lo.lo
    term in 3xTF32 (mm4), without it in one chain over D."""
    qh, kh, vh, do = (_heads(x, H) for x in (q, k, v, dout))
    qs = qh * np.float32(scale)
    B, _, N, D = qh.shape
    bias = np.zeros((B, N), np.float32) if kv_bias is None else kv_bias
    brow = bias[:, None, :, None]  # the block's kv rows
    delta = (do * _heads(out, H)).sum(-1)
    bq = 32 if D == 128 else 64  # DkvF32's kBQ
    step = min(CHUNK, D)
    dk, dv = np.zeros(kh.shape, np.float32), np.zeros(vh.shape, np.float32)
    for i in range(0, N, bq):
        rows = slice(i, i + bq)
        pt = np.exp((mm(kh, _t(qs[:, :, rows])) + brow) -
                    lse[:, :, None, rows])
        dpt = _stepped(vh, do[:, :, rows], mm, D) if kv_bias is None else \
            _stepped(vh, do[:, :, rows], mm4 if mm is mm3 else mm, 8)
        dst = pt * (dpt - delta[:, :, None, rows])
        for c in range(0, D, step):
            dv[..., c:c + step] += mm(pt, do[:, :, rows, c:c + step])
            dk[..., c:c + step] += mm(dst, qs[:, :, rows, c:c + step])
    return _merge(dk), _merge(dv)


def _close(name, got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL[name],
                               rtol=0, err_msg=name)


# --- against mofo_tpu's interpret-mode kernels -------------------------------


@pytest.mark.parametrize("D,N", [(16, 70), (32, 100), (64, 100), (128, 70),
                                 (256, 70), (64, 1)])
def test_k4_forward_walk_matches_the_tpu_k4(D, N):
    """K4's two-pass forward at every narrow head dim and at 256 (the
    column-split kernel at one group), ragged N and N = 1, against
    mofo_tpu's flash_attention in interpret mode within F32_ATOL on out;
    the LSE against the port's plain version within F32_ATOL."""
    B, H = 1, 2
    scale = D ** -0.5
    rng = np.random.RandomState(D + N)
    q, k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_hm(*map(jnp.asarray, (q, k, v)), scale=scale,
                             interpret=True)).reshape(B * H, N, D)
    planes = [x.reshape(B * H, N, D) for x in (q, k, v)]
    out, lse = k4_fwd_walk(*planes, fa._rounded(scale, torch.float32))
    _close("out", out, want)
    _close("lse", lse, fa.attention_hm_fwd_plain(
        *map(torch.from_numpy, planes), scale)[1].numpy())


def test_the_narrow_k4_walk_is_the_forward_walk_in_two_passes():
    """Up to 128, K4's walk is tests/test_torch_tf32_fwd.py's forward walk
    of the narrow kernel with two_pass set (one head a plane, no bias):
    the same kernel, bit for bit in the emulation."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(3, 100, 64).astype(np.float32) for _ in range(3))
    out, lse = k4_fwd_walk(q, k, v, 0.125)
    out2, lse2 = fwd_walk(q, k, v, None, 0.125, 1, two_pass=True)
    np.testing.assert_array_equal(out, out2)
    np.testing.assert_array_equal(lse, lse2[:, 0])


def _k3_fwd_bwd(q, k, v, b, H, scale, dout):
    """mofo_tpu's f32 K3 in interpret mode: out and (dq, dk, dv) of sum(out
    * dout); and vjp for another cotangent."""
    def fwd(q, k, v):
        return jax_mh(q, k, v, scale=scale, num_heads=H,
                      kv_bias=jnp.asarray(b), interpret=True)

    out, vjp = jax.vjp(jax.jit(fwd), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), vjp(jnp.asarray(dout)), vjp


@pytest.mark.parametrize("B,N,H,D,scale", [
    (2, 100, 2, 64, None), (2, 70, 1, 128, None), (2, 100, 2, 64, 0.1),
    (2, 70, 2, 128, 0.1), (2, 1, 2, 64, None), (2, 1, 1, 128, None)])
def test_k3_dkv_walk_matches_the_tpu_k3(B, N, H, D, scale):
    """K3's dK/dV with the kv bias (sample 0 keeps one unmasked column) at
    64 and 128, ragged N, scale 0.1 and N = 1, on the narrow forward's out
    and lse (test_torch_tf32_fwd.fwd_walk with the bias row), against
    mofo_tpu's flash_attention_mh in interpret mode: with a cotangent of
    std 1 within F32_ATOL, masked kv rows exactly zero; with sum(out^2)'s
    cotangent 2 out row by row as main_path.f32_rows_beyond holds them
    (within F32_ATOL of the TPU kernel's, except in a row where the TPU
    kernel is beyond F32_ATOL of float64: there within PRECISION_FACTOR of
    its error against float64: dV of the one-column sample sums N like
    terms, and at N = 1 dS is rounding noise)."""
    scale = scale or D ** -0.5
    s = fa._rounded(scale, torch.float32)
    q, k, v, b = _inputs(B, N, H, D, seed=D + N)
    dout = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    out_j, (_, dk_j, dv_j), vjp = _k3_fwd_bwd(q, k, v, b, H, scale, dout)
    out, lse = fwd_walk(q, k, v, b, s, H)
    _close("out", out, out_j)
    dk, dv = dkv_walk(q, k, v, b, out, lse, dout, s, H)
    _close("dk", dk, dk_j)
    _close("dv", dv, dv_j)
    masked = b != 0
    assert not dk[masked].any() and not dv[masked].any()

    _, dk_j, dv_j = vjp(2 * jnp.asarray(out_j))
    got = dict(zip(("dk", "dv"), dkv_walk(q, k, v, b, out, lse, 2 * out, s,
                                          H)))
    t = [torch.from_numpy(x) for x in (q, k, v, b)]
    ref = attention_mh_f64(*t, torch.from_numpy(dout), scale, H)
    exact = dict(zip(("dq", "dk", "dv"), mh_backward_f64(
        *t, ref["out"], ref["lse"], 2 * ref["out"], scale, H)))
    for n, want in (("dk", dk_j), ("dv", dv_j)):
        held = f32_rows_beyond(torch.from_numpy(got[n]), torch.from_numpy(
            np.array(want)), exact[n], F32_ATOL[n])
        assert held["beyond"] == 0, (n, held)


def test_k2_is_k3_without_the_bias():
    """K2's instance (the bias flag off) is K3's walk with no bias row:
    test_torch_tf32_split.py's K2 emulation on the same q tiles gives the
    same dK and dV bit for bit at head dim 64."""
    from test_torch_tf32_split import dkv_kernel as k2_dkv

    q, k, v, _ = _inputs(2, 100, 2, 64, bias=False, seed=1)
    dout = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    out, lse = fwd_walk(q, k, v, None, 0.125, 2)
    qkv = np.concatenate([q, k, v], -1)
    want = k2_dkv(qkv, out, lse, dout, 0.125, 2)
    got = dkv_walk(q, k, v, None, out, lse, dout, 0.125, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- against float64 -----------------------------------------------------------


def _k4_errors_vs_f64(q, k, v, scale, mm=None):
    """Max abs error of out and lse against K4's function in float64 (K3's,
    main_path.attention_mh_f64, one head a plane, no bias) for the plain
    f32 version (mm None) or the emulated walk through `mm`."""
    t = [torch.from_numpy(x) for x in (q, k, v)]
    ref = attention_mh_f64(*t, None, torch.zeros_like(t[0]), scale, 1)
    if mm is None:
        got = [x.numpy() for x in fa.attention_hm_fwd_plain(*t, scale)]
    else:
        got = k4_fwd_walk(q, k, v, fa._rounded(scale, torch.float32), mm)
    return {n: float(np.abs(g.astype(np.float64) - r).max())
            for n, g, r in zip(("out", "lse"), got,
                               (ref["out"].numpy(), ref["lse"][:, 0].numpy()))}


@pytest.mark.parametrize("BH,N,D", [(2, 100, 16), (2, 100, 32), (3, 100, 64),
                                    (2, 100, 128), (1, 100, 256)])
def test_k4_forward_walk_is_as_precise_as_f32(BH, N, D):
    """Against one float64 run, the emulated out and lse (tolerance:
    within PRECISION_FACTOR of the plain f32 version's error), and 1xTF32
    beyond that bound on both."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(BH, N, D).astype(np.float32) for _ in range(3))
    scale = D ** -0.5
    plain = _k4_errors_vs_f64(q, k, v, scale)
    tf32x3 = _k4_errors_vs_f64(q, k, v, scale, mm3)
    tf32 = _k4_errors_vs_f64(q, k, v, scale, mm1)
    for n in plain:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > PRECISION_FACTOR * plain[n], (n, tf32, plain)


def _dkv_errors_vs_f64(q, k, v, b, H, scale, mm=None):
    """Max abs error of dk and dv against attention_mh_f64, the backward on
    the f64 run's out and lse rounded to f32 (main_path.mh_f32_precision's
    inputs), for the plain f32 version (mm None) or the walk through
    `mm`."""
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, b)]
    ref = attention_mh_f64(*t, torch.from_numpy(dout), scale, H)
    out, lse = ref["out"].float(), ref["lse"].float()
    if mm is None:
        _, dk, dv = (x.numpy() for x in fa.attention_mh_bwd_plain(
            *t, out, lse, torch.from_numpy(dout), scale, H))
    else:
        dk, dv = dkv_walk(q, k, v, b, out.numpy(), lse.numpy(), dout,
                          fa._rounded(scale, torch.float32), H, mm)
    return {n: float(np.abs(g.astype(np.float64) - ref[n].numpy()).max())
            for n, g in (("dk", dk), ("dv", dv))}


@pytest.mark.parametrize("B,N,H,D,scale", [
    (2, 100, 4, 64, None), (2, 100, 2, 128, None), (2, 100, 2, 128, 0.1)])
def test_k3_dkv_walk_is_as_precise_as_f32(B, N, H, D, scale):
    """Against one float64 run, the emulated dK and dV with the kv bias
    (tolerance: within PRECISION_FACTOR of the plain f32 version's
    error), and 1xTF32 beyond that bound on both."""
    scale = scale or D ** -0.5
    x = _inputs(B, N, H, D, seed=3)
    plain = _dkv_errors_vs_f64(*x, H, scale)
    tf32x3 = _dkv_errors_vs_f64(*x, H, scale, mm3)
    tf32 = _dkv_errors_vs_f64(*x, H, scale, mm1)
    for n in plain:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > PRECISION_FACTOR * plain[n], (n, tf32, plain)


# --- the walks' index algebra --------------------------------------------------


def fwd_entry(two_pass: bool, T: int, e: int) -> tuple:
    """wgmma_tf32_fwd.cuh's fwd_entry_f32: entry e as (V_j?, j)."""
    if two_pass and e < T:
        return False, e
    e2 = e - T if two_pass else e
    return bool(e2 & 1), e2 >> 1


@pytest.mark.parametrize("T", [1, 2, 25])
def test_the_narrow_forward_walk(T):
    """One pass: K_j and V_j as entries 2j and 2j + 1 (K1's and K3's walk
    as before). Two passes: K_j alone as entry j, then K_j and V_j as
    entries T + 2j and T + 2j + 1: every K tile twice, every V tile once,
    3 T entries, and pass 2 in pass 1's tile order."""
    one = [fwd_entry(False, T, e) for e in range(2 * T)]
    assert one == [(v, j) for j in range(T) for v in (False, True)]
    two = [fwd_entry(True, T, e) for e in range(3 * T)]
    assert two[:T] == [(False, j) for j in range(T)]
    assert two[T:] == one
    header = (_build.CSRC / "wgmma_tf32_fwd.cuh").read_text()
    assert "const int n = (kTwoPass ? 3 : 2) * T;" in header
    assert "const int e = kTwoPass ? j : 2 * j;" in header
    assert "const int e = T + 2 * j;" in header


@pytest.mark.parametrize("D", [192, 256])
def test_k4_at_192_and_256_is_one_column_split_group(D):
    """At 192 and 256 K4's forward is the column-split kernel at one group
    of 3 or 4 chunks (NG 3 or 4, no recompute): every output column
    written once a kv tile, in pass 2 alone, and (2 G + 1) kC = 3 kC chunk
    products a tile pair, chip_smoke.products(1, two_pass=True)["fwd"] =
    3, the two passes' floor that tools/f32_ab.py's hm rows carry."""
    kc = D // CHUNK
    assert groups(kc) == [(0, kc)]
    assert chip_smoke.split_groups(D) == 0  # the least work at 256 and below
    T = 3
    w = fwd_walk_entries(True, kc, 0, kc, T)
    for tile in range(T):
        cols = [CHUNK * e[1] + x for t, e in w if e[2] and t % T == tile
                for x in range(CHUNK)]
        assert sorted(cols) == list(range(D))
    products = sum(1 for _, e in w if e[2]) + \
        sum(1 for _, e in w if not e[2]) // 2
    assert chip_smoke.products(1, two_pass=True)["fwd"] == 3
    assert products == 3 * kc * T


@pytest.mark.parametrize("D", [192, 256, 320, 384, 512, 768])
def test_the_split_forward_bias_rows_live_four_tiles(D):
    """The column-split forward stages tile t's bias row in slot t % 4
    when the producer splits the tile's first entry e0(t), whose load
    starts once the consumer is done with entry e0(t) - ENTRIES; tile t -
    4's row is read after its pair walk: e0(t) - ENTRIES >= e0(t - 4) + 2
    kC over both passes. Two slots would not do at 192: pass 1's walk is 6
    entries a tile there, and tile t + 2's load could start while tile t's
    row is read."""
    kc = D // CHUNK
    for c0, n in groups(kc):
        for two_pass in (False, True):
            T = 8
            w = fwd_walk_entries(two_pass, kc, c0, n, T)
            e0 = [next(i for i, (t, _) in enumerate(w) if t == tile)
                  for tile in range(2 * T if two_pass else T)]
            for t in range(4, len(e0)):
                assert e0[t] - ENTRIES >= e0[t - 4] + 2 * kc
    if D == 192:
        w = fwd_walk_entries(True, kc, 0, kc, 8)
        e0 = [next(i for i, (t, _) in enumerate(w) if t == tile)
              for tile in range(4)]
        assert e0[2] - ENTRIES < e0[0] + 2 * kc
    header = (_build.CSRC / "wgmma_tf32_split.cuh").read_text()
    fwd = header[header.index("split_fwd_tf32(const"):]
    assert fwd.count("(st.tile & 3) * kChunk") == 1
    assert fwd.count("(tile & 3) * kChunk") == 1


def dkv_entries(T: int) -> list:
    """bwd_dkv_f32's ring walk: entry e as (kind, q tile); kinds 0 q *
    q_scale, 1 dO, 2 dO transposed, 3 q * q_scale transposed."""
    return [(e & 3, e >> 2) for e in range(4 * T)]


def test_the_dkv_walk():
    """Four entries a q tile (q * scale and dO as loaded, dO and q * scale
    transposed; the first carries the tile's LSE and delta), q tiles in
    order; the kernel's mul is q_scale on kinds 0 and 3 alone."""
    assert dkv_entries(2) == [(0, 0), (1, 0), (2, 0), (3, 0),
                              (0, 1), (1, 1), (2, 1), (3, 1)]
    header = (_build.CSRC / "wgmma_tf32_dkv.cuh").read_text()
    assert "const float mul = kind == 0 || kind == 3 ? q_scale : 1.f;" in \
        header
    assert "kind == 0 || kind == 3 ? &tq : &tdo" in header


# --- the blocks' shared memory ---------------------------------------------------


def dkv_smem(D: int) -> int:
    """DkvF32<D>::smem(): 1024 bytes of alignment, 4 kWGs K / V tiles, the
    ring's 2 kEntries q-side tiles, their LSE and delta, 3 kEntries + 1
    barriers."""
    wgs, bq = (1, 32) if D == 128 else (2, 64)
    entries = {16: 8, 32: 6}.get(D, 3)
    return 1024 + (4 * wgs * 64 * D + 2 * entries * bq * D +
                   2 * entries * bq) * 4 + (3 * entries + 1) * 8


def fwd_smem(D: int) -> int:
    """FwdF32<D>::smem(), the same in one pass and in two."""
    wgs, q_tiles = (1, 2) if D == 128 else (2, 1)
    entries = {128: 2, 64: 5}.get(D, 8)
    return 1024 + (wgs * q_tiles + 2 * entries) * 64 * D * 4 + \
        entries * 64 * 4 + (3 * entries + 1) * 8


def test_the_blocks_fit_shared_memory():
    """The dK/dV block at every head dim up to 128 (the bias flag adds
    none: the bias of a thread's two kv rows lives in registers) and the
    forward's, at most SMEM = 232,448 bytes; the header's constants are the
    ones counted here."""
    dkv = {D: dkv_smem(D) for D in NARROW_DIMS}
    assert dkv == {16: 103_624, 32: 168_088, 64: 232_016, 128: 231_248}
    fwd = {D: fwd_smem(D) for D in NARROW_DIMS}
    assert fwd == {16: 77_000, 32: 150_728, 64: 199_040, 128: 198_200}
    assert max(dkv.values()) <= SMEM and max(fwd.values()) <= SMEM
    header = (_build.CSRC / "wgmma_tf32_dkv.cuh").read_text()
    assert "kEntries = D == 16 ? 8 : D == 32 ? 6 : 3;" in header
    assert "kBQ = D == 128 ? 32 : 64;" in header
    assert "kWGs = D == 128 ? 1 : 2;" in header
    for D, want in dkv.items():
        assert f"{want:,}" in header, D


# --- the sources -----------------------------------------------------------------


def _code(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)  # the notes may name them


def test_the_sources_route_k4_forward_and_k3_dkv():
    """No FMA f32 forward and no FMA K2 / K3 dK/dV is left: hm_fwd_f32,
    smem_fwd_f32 and mh_bwd_dkv_f32 are gone, and K3's f32 launchers
    (mh_flash_attention_f32.cu) no longer include flash_tiles.cuh nor keep
    smem_dkv_f32, load_stats or kFmaRows. K4's run_fwd launches the
    two-pass narrow kernel up to 128 and the column-split one in two passes
    at 192 and 256 (their refusal lifted for it alone); K2 and K3 launch
    wgmma_tf32_dkv.cuh's bwd_dkv_f32 with the bias flag off and on (K3 off
    without a bias)."""
    src = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    assert "wgmma_tf32_dkv.cuh" in _build.HEADERS
    for name, text in src.items():
        code = _code(text)
        for gone in ("hm_fwd_f32", "smem_fwd_f32", "mh_bwd_dkv_f32"):
            assert gone not in code, (name, gone)
        if name != "wgmma_tf32_dkv.cuh":
            assert not re.search(r"\bbwd_dkv_f32\b", code), name
    mh = src["mh_flash_attention_f32.cu"]
    assert '#include "flash_tiles.cuh"' not in mh
    for gone in ("smem_dkv_f32", "load_stats", "kFmaRows"):
        assert gone not in _code(mh), gone
    for name in ("qkv_flash_attention.cu", "mh_flash_attention_f32.cu"):
        assert '#include "wgmma_tf32_dkv.cuh"' in src[name]
    qkv = src["qkv_flash_attention.cu"]
    run_dkv = qkv[qkv.index("int run_dkv("):qkv.index("int run_dq(")]
    assert "launch_dkv_f32<D, false>(" in run_dkv
    bwd_dkv = mh[mh.index("int bwd_dkv("):mh.index("int bwd_dq(")]
    assert "launch_dkv_f32<D, true>(" in bwd_dkv
    assert "launch_dkv_f32<D, false>(" in bwd_dkv
    assert "launch_dkv_tf32<D>(" in bwd_dkv
    hm = src["hm_flash_attention.cu"]
    assert '#include "wgmma_tf32_fwd.cuh"' in hm
    run_fwd = hm[hm.index("int run_fwd("):hm.index("int run_dkv(")]
    assert "launch_fwd_f32<D, false, true>(" in run_fwd
    assert "launch_split_fwd_tf32<true>(" in run_fwd
    split = src["wgmma_tf32_split.cuh"]
    assert "D <= (strip_dims ? 2 : 4) * kChunk" in split
    launchers = split[split.index("int launch_split_dkv_tf32("):]
    assert launchers.count("kTwoPass);") == 1  # the forward's call alone
    header = src["wgmma_tf32_dkv.cuh"]
    assert "template <int D, bool kBias>" in header
    assert "kBias ? st[nt][e] + kvb[e >> 1] : st[nt][e]" in header


# --- the tools ---------------------------------------------------------------------


def test_f32_ab_has_this_slice_rows():
    """tools/f32_ab.py times K4 at the ViT-S decoder, 128 and 256, the f32
    BB-focused step at 16 heads and the f32 ViT-S pretrain step (the
    pretrain_step kind takes a model name); the rows that were there
    stay."""
    rows = f32_ab.MEASUREMENTS
    assert rows["hm_vits"] == ("hm", (96, 1568, 64), "float32")
    assert rows["hm_d128"] == ("hm", (48, 1568, 128), "float32")
    assert rows["hm_d256"] == ("hm", (24, 1568, 256), "float32")
    assert rows["bb_step_h16"] == ("bb_step", (10, 16), "float32")
    assert rows["vits_step"] == (
        "pretrain_step", (32, "pretrain_videomae_small_patch16_224"),
        "float32")
    for kept in ("mca_h8", "mca_h16", "bb_step_h8", "hm_d512", "pretrain_step"):
        assert kept in rows


def test_the_profile_files_the_shared_f32_kernels_by_family():
    """tools/profile_step.py's groups: the narrow forward in two passes is
    K4's, with the bias flag K3's, with neither K1's; the dK/dV kernel with
    the bias flag K3's, without K2's; demangled names and mangled ones."""
    k1, k3, k4 = ("attention, K1/K2 (port kernels)",
                  "masked attention, K3 (port kernels)",
                  "head-major attention, K4 (port kernels)")
    anon = "void (anonymous namespace)::"
    cases = {
        anon + "fwd_f32<64, false, true>(CUtensorMap_st)": k4,
        "_ZN12_GLOBAL__N_17fwd_f32ILi128ELb0ELb1EEEv14CUtensorMap_st": k4,
        anon + "fwd_f32<128, true, false>(CUtensorMap_st)": k3,
        "_ZN12_GLOBAL__N_17fwd_f32ILi64ELb1ELb0EEEv14CUtensorMap_st": k3,
        anon + "fwd_f32<64, false, false>(CUtensorMap_st)": k1,
        anon + "bwd_dkv_f32<128, true>(CUtensorMap_st)": k3,
        "_ZN12_GLOBAL__N_111bwd_dkv_f32ILi64ELb1EEEv14CUtensorMap_st": k3,
        anon + "bwd_dkv_f32<64, false>(CUtensorMap_st)": k1,
        "_ZN12_GLOBAL__N_111bwd_dkv_f32ILi64ELb0EEEv14CUtensorMap_st": k1,
        anon + "split_fwd_tf32<4, true>(CUtensorMap_st)": k4,
        anon + "hm_bwd_dkv_f32<64, 64, 64>(float const*)": k4,
    }
    for name, want in cases.items():
        assert _group(name) == want, name
