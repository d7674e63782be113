"""K4's f32 backward (dK/dV and dQ) on K3's 3xTF32 launchers, emulated on
the CPU, where the kernels cannot run; the sources' route; and the profile
groups of every kernel the sources define.

hm_flash_attention.cu's f32 hm_attn_bwd_dkv and hm_attn_bwd_dq call K3's
launchers mh_f32_dkv and mh_f32_dq (mh_f32.cuh) with K4's (BH, N, D)
planes as K3's (B, N, H D) at B = BH, H = 1, every row stride D and no kv
bias. So at each head dim K4 runs the walk of the kernel it now shares:

  - up to 128, K2's unbiased dK/dV (csrc/wgmma_tf32_dkv.cuh's
    bwd_dkv_f32<D, false>; tests/test_torch_tf32_k4_fwd_k3_dkv.dkv_walk
    without a bias) and the narrow dQ without the bias
    (csrc/wgmma_tf32_dq.cuh's mh_dq_f32<D, false>;
    tests/test_torch_tf32_dq.dq_kernel);
  - at 192 and 256, the chunked dK/dV and dQ (csrc/wgmma_tf32_wide.cuh's
    mh_dkv_tf32 and mh_dq_tf32; tests/test_torch_tf32_mh.dkv_kernel and
    test_torch_tf32_dq.dq_kernel);
  - above 256, the column-split ones (tests/test_torch_tf32_colsplit.py
    holds them for K4 at 320).

Those emulations are imported, not copied. They take delta = rowsum(dO *
O) from the caller (fa.hm_delta, K3's (B, H, N) at H = 1) and the LSE in
natural-log units. They are held against mofo_tpu's K4 in interpret mode
(flash_attention and its gradient) within main_path.F32_ATOL, and
against one float64 run (main_path.attention_mh_f64 with one head and no
bias, K4's function in f32): within PRECISION_FACTOR of the plain f32
version's error, which 1xTF32 misses. The card runs the same checks on the
kernels themselves (tests/test_torch_gpu.py, chip_smoke.py's
f32_precision phase).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mofo_tpu.ops.flash_attention import flash_attention as jax_hm
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import f32_ab, main_path
from mofo_tpu_torch.tools.main_path import (
    F32_ATOL,
    PRECISION_FACTOR,
    attention_mh_f64,
)
from mofo_tpu_torch.tools.profile_step import _CSRC_KERNELS, _group
from mofo_tpu_torch.tools.tf32_sum_probe import model_sum
from test_torch_tf32_dq import dq_kernel
from test_torch_tf32_k4_fwd_k3_dkv import dkv_walk
from test_torch_tf32_mh import dkv_kernel as chunked_dkv
from test_torch_tf32_split import mm1, mm3, split

GRADS = ("dq", "dk", "dv")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


# --- the emulated backward -----------------------------------------------------


def k4_backward(q, k, v, dout, out, lse, scale, mm=mm3):
    """K4's f32 backward as its kernels run it on (BH, N, D) planes, given
    the forward's out (BH, N, D) and lse (BH, N): K3's walks at B = BH, H
    = 1, no bias. (dq, dk, dv)."""
    s = fa._rounded(scale, torch.float32)
    lse3 = lse[:, None]  # K3's (B, H, N)
    delta = fa.hm_delta(torch.from_numpy(out),
                        torch.from_numpy(dout)).numpy()[:, None]
    walk = dkv_walk if q.shape[-1] <= 128 else chunked_dkv
    dk, dv = walk(q, k, v, None, out, lse3, dout, s, 1, mm)
    dq = dq_kernel(q, k, v, None, lse3, delta, dout, s, s, 1, mm)
    return dq, dk, dv


# --- against mofo_tpu's interpret-mode kernel --------------------------------

# (D, N): every built head dim up to 256 at a ragged N, and N = 1
GEOMS = [(16, 70), (32, 100), (64, 130), (128, 70), (192, 100), (256, 70),
         (64, 1), (256, 1)]


@pytest.mark.parametrize("D,N", GEOMS)
def test_k4_backward_walks_match_the_tpu_k4(D, N):
    """dQ, dK and dV of the emulated kernels against the gradient of
    mofo_tpu's flash_attention in interpret mode, within F32_ATOL, for a
    cotangent of std 1; the walks take the port's plain forward's out and
    LSE, as the card's backward takes its forward's."""
    B, H = 1, 2
    scale = D ** -0.5
    rng = np.random.RandomState(D + N)
    q, k, v, dout = (rng.randn(B, H, N, D).astype(np.float32)
                     for _ in range(4))

    def fwd(q, k, v):
        return jax_hm(q, k, v, scale=scale, interpret=True)

    _, vjp = jax.vjp(jax.jit(fwd), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g).reshape(B * H, N, D)
            for g in vjp(jnp.asarray(dout))]
    planes = [x.reshape(B * H, N, D) for x in (q, k, v, dout)]
    out, lse = fa.attention_hm_fwd_plain(
        *map(torch.from_numpy, planes[:3]), scale)
    got = k4_backward(*planes, out.numpy(), lse.numpy(), scale)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g, w, atol=F32_ATOL[name], rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("D,N", [(16, 70), (64, 100), (256, 70)])
def test_k4_f32_backward_is_k3_at_one_head(D, N):
    """The route's premise: in f32 K4's plain backward on (BH, N, D) is
    K3's plain backward on the same planes as (B, N, H D) at H = 1 with no
    bias (they differ only in rounding p / l, which f32 does not)."""
    rng = np.random.RandomState(N)
    q, k, v, dout = (torch.from_numpy(rng.randn(3, N, D).astype(np.float32))
                     for _ in range(4))
    scale = D ** -0.5
    out, lse = fa.attention_hm_fwd_plain(q, k, v, scale)
    k4 = fa.attention_hm_bwd_plain(q, k, v, out, lse, dout, scale)
    k3 = fa.attention_mh_bwd_plain(q, k, v, None, out, lse[:, None], dout,
                                   scale, 1)
    for name, a, b in zip(GRADS, k4, k3):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


# --- against float64 -----------------------------------------------------------


def _errors_vs_f64(q, k, v, dout, scale, mm=None) -> dict:
    """Max abs error of dq, dk, dv against K4's function in float64 (K3's
    attention_mh_f64 at one head, no bias), the backward on the f64 run's
    out and lse rounded to f32 (main_path.hm_f32_precision's inputs), for
    the plain f32 version (mm None) or the emulated kernels through
    `mm`."""
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    ref = attention_mh_f64(*t[:3], None, t[3], scale, 1)
    out, lse = ref["out"].float(), ref["lse"][:, 0].float()
    if mm is None:
        got = [g.numpy() for g in fa.attention_hm_bwd_plain(
            *t[:3], out, lse, t[3], scale)]
    else:
        got = k4_backward(q, k, v, dout, out.numpy(), lse.numpy(), scale,
                          mm)
    return {n: float(np.abs(g.astype(np.float64) - ref[n].numpy()).max())
            for n, g in zip(GRADS, got)}


@pytest.mark.parametrize("BH,N,D", [(2, 100, 16), (2, 100, 32),
                                    (3, 100, 64), (2, 100, 128),
                                    (1, 100, 192), (1, 100, 256),
                                    (3, 1, 64), (2, 1, 256)])
def test_k4_backward_walks_are_as_precise_as_f32(BH, N, D):
    """Against one float64 run, the emulated dQ, dK and dV within
    PRECISION_FACTOR of the plain f32 version's error, and 1xTF32 beyond
    that bound on each. At N = 1 (P = 1: dS is rounding noise around 0, dV
    = dO) the walks are held to F32_ATOL of float64 instead."""
    rng = np.random.RandomState(3)
    q, k, v, dout = (rng.randn(BH, N, D).astype(np.float32)
                     for _ in range(4))
    scale = D ** -0.5
    tf32x3 = _errors_vs_f64(q, k, v, dout, scale, mm3)
    if N == 1:
        for n in GRADS:
            assert tf32x3[n] <= F32_ATOL[n], (n, tf32x3)
        return
    plain = _errors_vs_f64(q, k, v, dout, scale)
    tf32 = _errors_vs_f64(q, k, v, dout, scale, mm1)
    for n in GRADS:
        assert tf32x3[n] <= PRECISION_FACTOR * plain[n], (n, tf32x3, plain)
        assert tf32[n] > PRECISION_FACTOR * plain[n], (n, tf32, plain)


# --- the sources -----------------------------------------------------------------


def _code(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)  # the notes may name them


def _sources() -> dict:
    return {p.name: p.read_text() for p in _build.CSRC.iterdir()}


def test_flash_tiles_is_gone():
    """The FMA tile helpers' header went with its last users."""
    assert not (_build.CSRC / "flash_tiles.cuh").exists()
    assert "flash_tiles.cuh" not in _build.HEADERS
    for name, text in _sources().items():
        assert "flash_tiles.cuh" not in _code(text), name


@pytest.mark.parametrize("gone", ["hm_bwd_dkv_f32", "hm_bwd_dq_f32",
                                  "smem_dkv_f32", "smem_dq_f32", "f32_rows",
                                  "load_f32", "gemm", "load_stats"])
def test_the_fma_backward_is_gone(gone):
    """K4's FMA kernels, their shared-memory sizes and row counts, and the
    FMA tile load and product appear in no source's code."""
    for name, text in _sources().items():
        assert not re.search(rf"\b{gone}\b", _code(text)), (name, gone)


def _entry(text: str, name: str) -> str:
    body = text[text.index(f'extern "C" int {name}('):]
    return " ".join(body[:body.index("\n}\n")].split())


def test_k4_f32_backward_calls_k3_launchers():
    """hm_attn_bwd_dkv and hm_attn_bwd_dq send float to mh_f32_dkv and
    mh_f32_dq with one head a plane (B = BH, H = 1), every row stride D
    and a null bias, and return what they return: no fallback. The
    launchers' declarations are one header, which their definitions'
    source includes too."""
    src = _sources()
    hm = src["hm_flash_attention.cu"]
    assert '#include "mh_f32.cuh"' in hm
    dkv = _entry(hm, "hm_attn_bwd_dkv")
    assert ("if (int e = !is_bf16 ? mh_f32_dkv(q, k, v, nullptr, dout, l, "
            "d_, dk, dv, BH, N, 1, D, D, D, D, D, q_scale, st)") in dkv
    dq = _entry(hm, "hm_attn_bwd_dq")
    assert ("if (int e = !is_bf16 ? mh_f32_dq(q, k, v, nullptr, dout, l, "
            "d_, dq, BH, N, 1, D, D, D, D, D, q_scale, k_scale, st)") in dq
    for body in (dkv, dq):
        assert body.count("return e;") == 1
        assert body.endswith("return (int)cudaGetLastError();")
    # the bf16 paths alone are left to hm's own launchers
    for fn in ("int run_dkv(", "int run_dq(", "int split_dkv(",
               "int split_dq("):
        body = hm[hm.index(fn):]
        assert "is_bf16" not in body[:body.index("\n}\n")], fn
    assert "mh_f32.cuh" in _build.HEADERS
    for name in ("mh_flash_attention.cu", "mh_flash_attention_f32.cu"):
        assert '#include "mh_f32.cuh"' in src[name], name
    for name, text in src.items():
        decls = re.findall(r"^int mh_f32_\w+\(", _code(text), re.M)
        want = {"mh_f32.cuh": 3, "mh_flash_attention_f32.cu": 3}.get(name, 0)
        assert len(decls) == want, name


def test_no_kernel_of_the_port_runs_on_fmas():
    """Every __global__ kernel of the sources is fed by TMA (takes a
    CUtensorMap) for the tensor cores, but the bf16 backward's prep
    passes, which only read rows and write delta and scaled copies."""
    kernels = _global_kernels()
    assert kernels
    for name, (_, params) in kernels.items():
        assert "CUtensorMap" in params or "prep" in name, name


# --- the profile's groups ----------------------------------------------------------

# the values each template parameter takes in the instances the sources
# launch (wgmma_tiles.cuh's by_head_dim; wgmma_tf32_split.cuh's NG groups
# of chunks; the prep pass's chunks a head)
_VALUES = {"D": (16, 32, 64, 128, 192, 256), "NG": (1, 2, 3, 4),
           "kHeadChunks": (2, 4, 8, 16, 24, 32)}


def _global_kernels() -> dict:
    """name -> (template parameters [(type, name)], parameter list) of
    every __global__ kernel the sources define."""
    found = {}
    pattern = re.compile(r"(?:template <([^>]*)>\s*)?__global__ void "
                         r"__launch_bounds__\([^)]*\)\)?\s*(\w+)\(([^)]*)\)")
    for name, text in _sources().items():
        for m in pattern.finditer(_code(text)):
            tparams = [tuple(p.split()) for p in (m.group(1) or "").split(",")
                       if p.strip()]
            found[m.group(2)] = (tparams, m.group(3))
    return found


def _instances(tparams: list) -> list:
    """Every combination of the template arguments, as ints (bools 0 /
    1)."""
    combos = [[]]
    for kind, name in tparams:
        values = (0, 1) if kind == "bool" else _VALUES.get(name, (64,))
        combos = [c + [x] for c in combos for x in values]
    return combos


# nvcc's name for a source's anonymous namespace (the build's ptxas report)
NVCC_NS = "_GLOBAL__N__4b625b1c_22_qkv_flash_attention_cu_a6315100"


def _names(base: str, tparams: list, args: list) -> list:
    """The instance's name as the profiler may report it: demangled, and
    mangled in nvcc's and in gcc's anonymous namespace."""
    shown = ", ".join(("true" if a else "false") if kind == "bool"
                      else str(a) for (kind, _), a in zip(tparams, args))
    targs = "".join(f"Lb{a}E" if kind == "bool" else f"Li{a}E"
                    for (kind, _), a in zip(tparams, args))
    if tparams:
        demangled = (f"void (anonymous namespace)::{base}<{shown}>"
                     "(CUtensorMap_st, CUtensorMap_st, float*, int)")
        rest = f"{len(base)}{base}I{targs}EEv14CUtensorMap_stS1_Pfi"
    else:
        demangled = (f"void (anonymous namespace)::{base}"
                     "(__nv_bfloat16 const*, int)")
        rest = f"{len(base)}{base}EPK13__nv_bfloat16i"
    return [demangled, f"_ZN{len(NVCC_NS)}{NVCC_NS}{rest}",
            f"_ZN12_GLOBAL__N_1{rest}"]


def test_the_profile_knows_every_kernel_of_the_sources():
    assert set(_CSRC_KERNELS) == set(_global_kernels())


@pytest.mark.parametrize("base", sorted(_CSRC_KERNELS))
def test_the_profile_files_every_instance_under_the_port(base):
    """Each instance of each __global__ kernel of csrc/, demangled and
    mangled, lands in a "(port kernels)" group, never in "other" (the
    model's elementwise tail), and the same one under every name."""
    tparams, _ = _global_kernels()[base]
    for args in _instances(tparams):
        groups = {_group(name) for name in _names(base, tparams, args)}
        assert len(groups) == 1, (base, args, groups)
        assert groups.pop().endswith("(port kernels)"), (base, args)


K1, K3, K4 = ("attention, K1/K2 (port kernels)",
              "masked attention, K3 (port kernels)",
              "head-major attention, K4 (port kernels)")
K234 = "attention shared by K2, K3 and K4 (port kernels)"
ANON = "void (anonymous namespace)::"


@pytest.mark.parametrize("name,group", [
    # K4's f32 backward at the ViT-S decoder, shared with K2 (and K3
    # without a kv bias); at 192 / 256 and above 256 the same
    (ANON + "bwd_dkv_f32<64, false>(CUtensorMap_st)", K234),
    ("_ZN12_GLOBAL__N_19mh_dq_f32ILi64ELb0EEEv14CUtensorMap_st", K234),
    (ANON + "mh_dq_f32<128, true>(CUtensorMap_st)", K3),
    (ANON + "mh_dkv_tf32<256>(CUtensorMap_st)", K234),
    ("_ZN12_GLOBAL__N_110mh_dq_tf32ILi192EEEv14CUtensorMap_st", K234),
    (ANON + "split_dkv_tf32<4>(CUtensorMap_st)", K234),
    (ANON + "split_dq_tf32<3>(CUtensorMap_st)", K234),
    # the forwards: two passes K4's, the bias flag K3's, K1's otherwise;
    # the chunked and column-split ones K1's and K3's
    (ANON + "fwd_f32<64, false, true>(CUtensorMap_st)", K4),
    (ANON + "split_fwd_tf32<3, false>(CUtensorMap_st)",
     "attention shared by K1 and K3 (port kernels)"),
    (ANON + "mh_fwd_tf32<256>(CUtensorMap_st)",
     "attention shared by K1 and K3 (port kernels)"),
    # bf16: base e K4's, the bias flag K3's
    (ANON + "bwd_dkv_bf16<true, false, 64>(CUtensorMap_st)", K4),
    ("_ZN12_GLOBAL__N_111bwd_dq_bf16ILb0ELb1ELb1ELi64EEEv14CUtensorMap_st",
     K3),
    (ANON + "bwd_dq_bf16<false, false, false, 64>(CUtensorMap_st)", K1),
    (ANON + "fwd_bf16<64>(CUtensorMap_st)", K1),
    (ANON + "hm_fwd_bf16<64>(CUtensorMap_st)", K4),
    (ANON + "strip_bwd_dkv_bf16<256, false>(CUtensorMap_st)",
     "attention shared by K2 and K3 (port kernels)"),
    (ANON + "strip_bwd_dq_bf16<256, true, false>(CUtensorMap_st)", K4),
    (ANON + "split_fwd_bf16<true>(CUtensorMap_st)", K4),
    (ANON + "bwd_prep_bf16<32>(__nv_bfloat16 const*)", K234),
    # as nvcc mangles them (the build's ptxas report)
    ("_ZN54_GLOBAL__N__0c5e648b_21_mh_flash_attention_cu_d85e900011bwd_dq_"
     "bf16ILb0ELb0ELb1ELi128EEEv14CUtensorMap_stS1_S1_S1_S1_iiPKfS3_S3_P13__"
     "nv_bfloat16iiif", K3),
    (f"_ZN{len(NVCC_NS)}{NVCC_NS}11bwd_dkv_f32ILi64ELb0EEEv14CUtensorMap_st",
     K234),
    # not the port's
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32",
     "gemm (cuBLAS)"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>()",
     "foreach"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>(int)", "other"),
])
def test_the_profile_files_each_instance_by_family(name, group):
    assert _group(name) == group


# --- the tools ---------------------------------------------------------------------


def test_f32_ab_times_and_checks_this_slice():
    """tools/f32_ab.py's rows of this slice stay (K4 at the ViT-S decoder,
    128 and 256; the f32 ViT-S step; the controls), and its precision rows
    are chip_smoke.py's K4 geometries up to 256."""
    rows = f32_ab.MEASUREMENTS
    for kept in ("hm_vits", "hm_d128", "hm_d256", "vits_step",
                 "pretrain_step", "bb_step_h8"):
        assert kept in rows
    for label in ("d64", "d128", "ragged_d256"):
        assert rows[f"prec_k4_{label}"] == (
            "hm_precision", chip_smoke.HM_F32_PRECISION_CHECKS[label],
            "float32")


def test_the_precision_check_requires_the_fault_on_k4_dk_and_dv():
    """chip_smoke.py's f32_precision requires the 1xTF32 fault beyond the
    bound on dK and dV at every K4 geometry (the parent's FMA runs showed
    it there): a report with the fault on dQ, out and lse alone fails."""
    for label in chip_smoke.HM_F32_PRECISION_CHECKS:
        need = chip_smoke.F32_FAULT_BEYOND[f"k4_{label}"]
        assert {"out", "lse", "dk", "dv"} <= set(need), label
    res = {"beyond": [], "fault_beyond": ["out", "lse", "dq"]}
    assert not chip_smoke.fault_caught("k4_d64", res)
    res["fault_beyond"] += ["dk", "dv"]
    assert chip_smoke.fault_caught("k4_d64", res)
    assert not chip_smoke.fault_caught("k4_d64", dict(res, beyond=["dk"]))


# --- the tensor cores' sums at head dim 128 --------------------------------------


def _tc_chain(c, a, b, small=None):
    """c (R, C) += a (R, K) b (C, K)^T in 3xTF32 as the tensor cores sum
    it (tools/tf32_sum_probe.model_sum: every addend of a k-step cut
    toward zero against the largest, the sum cut to f32), one k-step of 8
    at a time: lo.hi, hi.lo into `small` if given, hi.hi into c."""
    (ah, al), (bh, bl) = split(a), split(b)
    for k in range(0, a.shape[1], 8):
        ks = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl)):
            if small is None:
                c = model_sum(c, x[:, ks], y[:, ks])
            else:
                small = model_sum(small, x[:, ks], y[:, ks])
        c = model_sum(c, ah[:, ks], bh[:, ks])
    return c if small is None else (c + small).astype(np.float32)


def _tc_dkv_128(q, k, v, dout, lse, delta, scale, s_apart):
    """bwd_dkv_f32<128, false> on one (N, 128) plane under the tensor-core
    sum model: 32-row q tiles; S^T one chain over D (its small terms apart
    with s_apart), dP^T one chain with its small terms apart, dV and dK
    one chain a tile and 64 output columns, added in f32. dk."""
    N = q.shape[0]
    qs = q * np.float32(scale)
    dk = np.zeros(q.shape, np.float32)
    for i in range(0, N, 32):
        r = slice(i, i + 32)
        zero = np.zeros((N, len(qs[r])), np.float32)
        st = _tc_chain(zero, k, qs[r], zero if s_apart else None)
        dpt = _tc_chain(zero, v, dout[r], zero)
        p = np.exp(st - lse[None, r])
        ds = (p * (dpt - delta[None, r])).astype(np.float32)
        for c in range(0, 128, 64):
            dk[:, c:c + 64] += _tc_chain(np.zeros((N, 64), np.float32), ds,
                                         qs[r, c:c + 64].T.copy())
    return dk


def test_the_unbiased_dkv_sums_s_small_terms_apart_at_128():
    """At (4, 100) x 128 on hm_f32_precision's inputs (the GPU case that
    put dK beyond the bound when S^T was one chain), the tensor-core sum
    model of bwd_dkv_f32<128, false> keeps dK within PRECISION_FACTOR of
    the plain version's error against float64 with S^T's small terms
    apart (kSApart), and the one chain's error is well above that."""
    D = 128
    q, k, v = main_path.hm_inputs(4, 100, torch.float32, 5, "cpu", D=D)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    ref = attention_mh_f64(q, k, v, None, dout, D ** -0.5, 1)
    out, lse = ref["out"].float(), ref["lse"][:, 0].float()
    _, plain, _ = fa.attention_hm_bwd_plain(q, k, v, out, lse, dout,
                                            D ** -0.5)
    delta = fa.hm_delta(out, dout).numpy()
    s = fa._rounded(D ** -0.5, torch.float32)
    exact = ref["dk"].numpy()

    def err(dk):
        return float(np.abs(dk.astype(np.float64) - exact).max())

    bound = PRECISION_FACTOR * err(plain.numpy())
    walks = {apart: err(np.stack([_tc_dkv_128(
        *(x[h].numpy() for x in (q, k, v, dout)), lse[h].numpy(), delta[h],
        s, apart) for h in range(4)])) for apart in (True, False)}
    assert walks[True] <= bound, (walks, bound)
    assert walks[False] > 1.5 * walks[True], walks
