"""The port's CUDA kernels on the card (`gpu` marker; each case skips when
no CUDA device is present).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(--noconftest skips tests/conftest.py, which sets up JAX.) The kernels are
held against their plain PyTorch versions with the bounds of
mofo_tpu_torch/tools/main_path.py (the ones chip_smoke.py uses), which the
CPU tests hold against the JAX package.
"""

import json

import numpy as np
import pytest
import torch

from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.data.filelist import ClipEntry, MotionBoxIndex
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import masking
from mofo_tpu_torch.cli import finetune_mofo, motion_factory, pretrain_mofo
from mofo_tpu_torch.factory import flow, motion_maps
from mofo_tpu_torch.tools.main_path import (
    AUG_SHARE,
    VITS_MODEL,
    MemoryReader,
    attention_against_plain,
    augment_against_cpu,
    build_finetune_step,
    check_against_plain,
    check_hm_prep,
    check_mh_prep,
    check_prep,
    compare_with_plain,
    count_pads,
    f32_precision,
    f32_rows_beyond,
    finetune_model,
    forced_draws,
    frame_ids,
    group_unwritten,
    hm_attention_against_plain,
    hm_f32_precision,
    hm_inputs,
    hm_planted_faults,
    masked_kv_grad,
    memory_box_json,
    mh_attention_against_plain,
    mh_f32_precision,
    mh_inputs,
    moved_draws,
    planted_faults,
    synthetic_clips_u8,
    synthetic_finetune_batch,
)
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.finetune_step import make_finetune_step
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

pytestmark = pytest.mark.gpu
D = 64  # the registry presets' head dim
SCALE = D ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, N, H, dtype, device, seed=0, d=D):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * H * d, generator=g).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H", [(2, 160, 12), (1, 1568, 6), (2, 100, 2),
                                   (1, 64, 1), (2, 3136, 6), (2, 3136, 12),
                                   (1, 4608, 12), (2, 1568, 16),
                                   (2, 1568, 3), (2, 1568, 4), (2, 160, 8),
                                   (1, 4608, 16), (1, 8192, 16)])
def test_kernels_match_plain(cuda, dtype, B, N, H):
    """K1/K2 at the steps' geometries, at the long sequences the TPU
    kernels are gated at (32 frames, 384^2), ViT-L's 16 heads (also over
    vit_large_patch16_384's 4608 and _512's 8192 tokens) and the heads a
    rank holds at model 2 (the ViT-B decoder's 3, ViT-L's 4 and 8)."""
    got, want = attention_against_plain(_qkv(B, N, H, dtype, cuda), H, SCALE)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_autograd_runs_the_kernels(cuda):
    x = _qkv(2, 100, 2, torch.float32, cuda, seed=1)
    qkv = x.clone().requires_grad_(True)
    fa.reset_launch_counts()
    (fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=2) ** 2).sum() \
        .backward()
    # f32: no prep pass (delta is mh_delta's reduction)
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_F32_KERNELS, 1)}
    ref = x.cpu().clone().requires_grad_(True)
    (fa.flash_attention_qkv(ref, scale=SCALE, num_heads=2) ** 2).sum() \
        .backward()
    np.testing.assert_allclose(qkv.grad.cpu().numpy(), ref.grad.numpy(),
                               atol=5e-4, rtol=0)


@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("N", [1, 65, 200, 1568])
@pytest.mark.parametrize("hd,H", [(16, 8), (32, 4), (64, 2), (128, 2),
                                  (192, 2), (256, 1)])
def test_3xtf32_kernels_at_every_head_dim(cuda, hd, H, N, scale):
    """K1's f32 forward and K2's f32 dK/dV (3xTF32 on wgmma) at each head
    dim they take (192 and 256 through K3's entry points, on its chunked
    kernels), ragged N, at D^-1/2 and at 0.1; the planted faults rejected
    (above N = 1, where dQ is rounding noise around 0)."""
    got, want = attention_against_plain(
        _qkv(2, N, H, torch.float32, cuda, seed=hd + N, d=hd), H,
        scale or hd ** -0.5)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    if N > 1:
        for fault, outputs in planted_faults(got).items():
            assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("hd,H", [(16, 8), (32, 6), (64, 6), (128, 4),
                                  (192, 4), (256, 3)])
def test_3xtf32_kernels_are_as_precise_as_f32(cuda, hd, H):
    """Against a float64 run each output of the 3xTF32 kernels is within
    PRECISION_FACTOR of the plain f32 version's error; the plain version
    with TF32 on misses that bound."""
    res = f32_precision(_qkv(2, 1568, H, torch.float32, cuda, seed=5, d=hd),
                        H, hd ** -0.5)
    assert res["beyond"] == [], res
    assert "dq" in res["fault_beyond"], res


def _check_at_edge(got, want, N):
    """check_against_plain, except at N = 1: there P = 1, so dS = dP - delta
    is f32 rounding noise around 0, and so are dQ and dK (of either
    version); they are held to 1e-4 absolute, out, lse and dV to the
    bounds."""
    if N > 1:
        check_against_plain(got, want)
        return
    assert set(compare_with_plain(got, want)["beyond_bounds"]) <= {"dq", "dk"}
    assert max(got[k].float().abs().max().item() for k in ("dq", "dk")) \
        <= 1e-4


@pytest.mark.parametrize("H", [2, 6, 12, 16])
@pytest.mark.parametrize("N", [1, 63, 65, 100, 160, 1568, 3136])
def test_k2_backward_at_tile_edges(cuda, N, H):
    """The bf16 forward (TMA-fed wgmma, online softmax) and backward (prep
    pass, TMA-fed wgmma dK/dV and dQ kernels) at N on both sides of their
    64-row tiles and 128-row blocks, against the plain versions; the prep
    pass against its own."""
    x = _qkv(2, N, H, torch.bfloat16, cuda, seed=N + H)
    got, want = attention_against_plain(x, H, SCALE)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    check_prep(x, got["out"], (2 * got["out"].float()).to(x.dtype), H, SCALE)
    for fault, outputs in planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("N", [65, 160])
def test_k2_backward_with_a_scale_not_a_power_of_two(cuda, N):
    """scale 0.1: the prep pass writes k * scale and dQ reads that copy."""
    x = _qkv(2, N, 2, torch.bfloat16, cuda, seed=5)
    got, want = attention_against_plain(x, 2, 0.1)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert check_prep(x, got["out"], (2 * got["out"].float()).to(x.dtype),
                      2, 0.1)["ks"] is True


def test_bf16_autograd_runs_the_prep_pass(cuda):
    x = _qkv(2, 100, 2, torch.bfloat16, cuda, seed=2)
    qkv = x.clone().requires_grad_(True)
    fa.reset_launch_counts()
    (fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=2).float() ** 2) \
        .sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_KERNELS, 1)}
    # one writer per output, no atomics: the same call gives the same bits
    out, lse = fa.qkv_attn_fwd(x, SCALE, 2)
    want = fa.qkv_attn_bwd(x, out, lse, (2 * out.float()).to(x.dtype),
                           SCALE, 2)
    assert torch.equal(qkv.grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(16, 8), (32, 4), (128, 2)])
@pytest.mark.parametrize("N", [1, 65, 200, 1568])
def test_kernels_at_flat_head_dims(cuda, hd, H, N, dtype):
    """K1/K2 at the flat head dims 16, 32 and 128 (A = 128 or 256), scale
    D^-0.5 (at 32 and 128 no power of two: dQ reads the prep pass's k *
    scale), against the plain versions at both sides of the tiles."""
    x = _qkv(2, N, H, dtype, cuda, seed=hd + N, d=hd)
    got, want = attention_against_plain(x, H, hd ** -0.5)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    if dtype == torch.bfloat16:
        assert check_prep(x, got["out"], (2 * got["out"].float()).to(dtype),
                          H, hd ** -0.5)["ks"] is (True if hd != 16 else None)
    if N > 1:
        for fault, outputs in planted_faults(got).items():
            assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_autograd_at_head_dim_128_runs_the_kernels(cuda):
    x = _qkv(2, 200, 2, torch.bfloat16, cuda, seed=3, d=128)
    qkv = x.clone().requires_grad_(True)
    fa.reset_launch_counts()
    (fa.flash_attention_qkv(qkv, scale=128 ** -0.5, num_heads=2).float()
     ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_KERNELS, 1)}


# --- head dims up to 256: built widths and zero-padded ones ---------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(96, 4), (256, 1)])
@pytest.mark.parametrize("N", [65, 200])
def test_qkv_at_a_padded_and_a_built_wide_head_dim(cuda, hd, H, N, dtype):
    """K1/K2 at 96 (zero-padded to 128) and at 256 (K3's strip kernels on
    the fused layout; scale 1/16, and 96's no power of two) against the
    plain versions at the unpadded D; faults rejected."""
    x = _qkv(2, N, H, dtype, cuda, seed=hd + N, d=hd)
    got, want = attention_against_plain(x, H, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(100, 2), (192, 1), (16, 4)])
@pytest.mark.parametrize("N", [65, 200])
def test_mh_at_a_padded_and_a_built_head_dim(cuda, hd, H, N, dtype):
    """K3 with the kv bias at 100 (zero-padded to 128), 192 (the strip
    kernels) and 16 (one 32-byte box) against the plain versions at the
    unpadded D; masked kv rows get zero dK/dV; faults rejected."""
    q, k, v, b = mh_inputs(2, N, H, hd, dtype, hd + N, cuda)
    got, want = mh_attention_against_plain(q, k, v, b, H, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert masked_kv_grad(got, b) == 0.0
    ignored, _ = mh_attention_against_plain(q, k, v, None, H, hd ** -0.5)
    for fault, outputs in planted_faults(got, ignored).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [48, 128, 160, 192, 256])
@pytest.mark.parametrize("N", [65, 200])
def test_hm_at_a_padded_and_a_built_head_dim(cuda, hd, N, dtype):
    """K4 at 48 (zero-padded to 64), 128 (two 64-column boxes), 160
    (zero-padded to 192), 192 and 256 (the two-pass strip forward and the
    backward on strips) against the plain versions at the unpadded D;
    faults rejected."""
    q, k, v = hm_inputs(4, N, dtype, hd + N, cuda, D=hd)
    got, want = hm_attention_against_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in hm_planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("family", ["qkv", "mh", "hm"])
def test_autograd_pads_an_unbuilt_head_dim_only(cuda, family):
    """Each public entry point at head dim 48 (bf16): one launch of each
    kernel, the inputs padded (1 copy for qkv, 3 for q, k, v) and the
    backward's dout (1), the gradients those of the padded route's kernels
    bit for bit; at 64 no copy."""
    for hd, copies in ((48, 2 if family == "qkv" else 4), (64, 0)):
        H = 2
        if family == "qkv":
            x = [_qkv(2, 100, H, torch.bfloat16, cuda, seed=1, d=hd)]
            fn = lambda a: fa.flash_attention_qkv(  # noqa: E731
                a, scale=hd ** -0.5, num_heads=H)
            route = lambda: attention_against_plain(  # noqa: E731
                x[0], H, hd ** -0.5)[0]
            names, grads = fa.QKV_KERNELS, ("dq", "dk", "dv")
        elif family == "mh":
            q, k, v, _ = mh_inputs(2, 100, H, hd, torch.bfloat16, 1, cuda,
                                   bias=False)
            x = [q, k.contiguous(), v.contiguous()]
            fn = lambda *a: fa.flash_attention_mh(  # noqa: E731
                *a, scale=hd ** -0.5, num_heads=H)
            route = lambda: mh_attention_against_plain(  # noqa: E731
                *x, None, H, hd ** -0.5)[0]
            names, grads = fa.MH_KERNELS, ("dq", "dk", "dv")
        else:
            x = list(hm_inputs(2 * H, 100, torch.bfloat16, 1, cuda, D=hd))
            fn = lambda *a: fa.flash_attention(  # noqa: E731
                *(t.reshape(2, H, 100, hd) for t in a), scale=hd ** -0.5)
            route = lambda: hm_attention_against_plain(  # noqa: E731
                *x, hd ** -0.5)[0]
            names, grads = fa.HM_KERNELS, ("dq", "dk", "dv")
        ts = [t.clone().requires_grad_(True) for t in x]
        fa.reset_launch_counts()
        with count_pads() as pads:
            out = fn(*ts)
            (out.float() ** 2).sum().backward()
        assert pads["copies"] == copies
        assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                    **dict.fromkeys(names, 1)}
        got = route()
        if family == "qkv":
            assert torch.equal(ts[0].grad, torch.cat(
                [got[g] for g in grads], dim=-1))
        else:
            for t, g in zip(ts, grads):
                assert torch.equal(t.grad.reshape(got[g].shape), got[g])


def test_a_head_dim_above_256_is_refused(cuda):
    """Above 256 no head dim is refused any more: K1/K2 at 264 (zero-padded
    to 320) and K4 at 320 (the column-split kernels' own width) run the
    kernels, one launch of each, and match their plain versions at D."""
    for hd, run, family in (
            (264, lambda t: fa.flash_attention_qkv(
                t, scale=264 ** -0.5, num_heads=2), fa.QKV_KERNELS),
            (320, lambda t: fa.flash_attention(
                *t.reshape(1, 2, 100, 3 * 320).split(320, -1),
                scale=320 ** -0.5), fa.HM_KERNELS)):
        x = _qkv(1, 100, 2, torch.bfloat16, cuda, seed=hd, d=hd)
        fa.reset_launch_counts()
        out = run(x)
        assert out.shape[-1] == (2 * hd if hd == 264 else hd)
        assert fa.launch_counts["qkv_attn_fwd" if hd == 264
                                else "hm_attn_fwd"] == 1
    got, want = attention_against_plain(
        _qkv(2, 200, 2, torch.bfloat16, cuda, seed=5, d=264), 2, 264 ** -0.5)
    check_against_plain(got, want)
    got, want = hm_attention_against_plain(
        *hm_inputs(4, 200, torch.bfloat16, 6, cuda, D=320), 320 ** -0.5)
    check_against_plain(got, want)


# --- head dims above 256: the column-split kernels -------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(264, 2), (320, 2), (512, 1)])
@pytest.mark.parametrize("N", [65, 200])
def test_qkv_above_256(cuda, hd, H, N, dtype):
    """K1/K2 above 256 (K3's column-split kernels on the fused layout; 264
    zero-padded to 320) against the plain versions at the unpadded D; the
    faults rejected, one output group left unwritten among them."""
    x = _qkv(2, N, H, dtype, cuda, seed=hd + N, d=hd)
    got, want = attention_against_plain(x, H, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    if dtype == torch.bfloat16:
        xw, out = got["at_width"]
        check_prep(xw, out, (2 * out.float()).to(dtype), H, hd ** -0.5)
    faults = dict(planted_faults(got), unwritten=group_unwritten(got, H))
    for fault, outputs in faults.items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(341, 3), (384, 2), (768, 1), (1024, 1)])
@pytest.mark.parametrize("N", [65, 200])
def test_mh_above_256(cuda, hd, H, N, dtype):
    """K3 with the kv bias at the MCA's head dims above 256 (341 padded to
    384) and 1024 against the plain versions at the unpadded D; masked kv
    rows get zero dK/dV; faults rejected."""
    q, k, v, b = mh_inputs(2, N, H, hd, dtype, hd + N, cuda)
    got, want = mh_attention_against_plain(q, k, v, b, H, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert masked_kv_grad(got, b) == 0.0
    if dtype == torch.bfloat16:
        qw, kw, _, _, out = got["at_width"]
        check_mh_prep(qw, kw, out, (2 * out.float()).to(dtype), H,
                      hd ** -0.5)
    faults = dict(planted_faults(got), unwritten=group_unwritten(got, H))
    for fault, outputs in faults.items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [320, 512, 1024])
@pytest.mark.parametrize("N", [65, 200])
def test_hm_above_256(cuda, hd, N, dtype):
    """K4 above 256 (two passes in the forward, base e) against the plain
    versions; faults rejected."""
    q, k, v = hm_inputs(4, N, dtype, hd + N, cuda, D=hd)
    got, want = hm_attention_against_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    if dtype == torch.bfloat16:
        qw, kw, _, out = got["at_width"]
        check_hm_prep(qw, kw, out, (2 * out.float()).to(dtype), hd ** -0.5)
    faults = dict(hm_planted_faults(got), unwritten=group_unwritten(got, 1))
    for fault, outputs in faults.items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("family,shape", [
    ("qkv", (2, 1568, 2, 320)), ("mh", (4, 1568, 2, 384)),
    ("mh", (2, 1568, 1, 768)), ("mh", (4, 1, 1, 384)),
    ("hm", (4, 1568, 320))])
def test_column_split_3xtf32_backward_is_as_precise_as_f32(cuda, family,
                                                           shape):
    """The column-split f32 backward (wgmma_tf32_split.cuh, 3xTF32 on
    wgmma) of K1/K2 at 320, K3 with the kv bias at the MCA's 384 and 768
    (and N = 1) and K4 at 320: against a float64 run each output within
    PRECISION_FACTOR of the plain f32 version's error, the plain version
    with TF32 on beyond it on dQ, dK and dV. At N = 1 (the plain version
    exact, dS rounding noise) against the plain versions as
    _check_at_edge holds them. Above N = 1 the fault that leaves dK's last
    output group unwritten (the dK blocks run apart from the dV blocks) is
    rejected by the against-plain bounds."""
    if family == "qkv":
        B, N, H, d = shape
        x = _qkv(B, N, H, torch.float32, cuda, seed=5, d=d)
        res = f32_precision(x, H, d ** -0.5)
        got, want = attention_against_plain(x, H, d ** -0.5)
    elif family == "mh":
        B, N, H, d = shape
        q, k, v, b = mh_inputs(B, N, H, d, torch.float32, 5, cuda)
        res = mh_f32_precision(q, k, v, b, H, d ** -0.5)
        got, want = mh_attention_against_plain(q, k, v, b, H, d ** -0.5)
    else:
        BH, N, d = shape
        H = 1
        q, k, v = hm_inputs(BH, N, torch.float32, 5, cuda, D=d)
        res = hm_f32_precision(q, k, v, d ** -0.5)
        got, want = hm_attention_against_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    if N == 1:
        _check_at_edge(got, want, N)
        return
    assert res["beyond"] == [], res
    assert {"dq", "dk", "dv"} <= set(res["fault_beyond"]), res
    check_against_plain(got, want)
    fault = group_unwritten(got, H, ("dk",))
    assert compare_with_plain(fault, want)["beyond_bounds"] == ["dk"]


@pytest.mark.parametrize("N", [1568, 100, 1])
@pytest.mark.parametrize("family,shape", [
    ("mh", (4, 16, 64)), ("mh", (4, 8, 128)), ("mh", (4, 2, 384)),
    ("mh", (2, 1, 768)), ("qkv", (2, 2, 320)), ("hm", (4, 1, 512)),
    ("hm", (4, 3, 64)), ("hm", (4, 1, 128)), ("hm", (4, 1, 256))])
def test_3xtf32_forwards_are_as_precise_as_f32(cuda, family, shape, N):
    """The f32 forwards on 3xTF32 wgmma: K3's up to head dim 128 with its
    bias row (csrc/wgmma_tf32_fwd.cuh, K1's kernel), K4's there in two
    passes (the same kernel) and at 256 (the column-split kernel at one
    output group, two passes), and the column-split one above 256
    (csrc/wgmma_tf32_split.cuh) of K3 at the MCA's 384 and 768, K1/K2 at
    320 and K4 at 512 (two passes). Long, ragged and N = 1.
    Against a float64 run every output within PRECISION_FACTOR of the
    plain f32 version's error, and the plain version with TF32 on beyond
    that bound on out and lse; then against the plain versions. At N = 1
    (the plain version exact, dS rounding noise) against the plain
    versions as _check_at_edge holds them. Above 256 the fault that leaves
    the forward's last output group unwritten is rejected, on out alone."""
    B, H, d = shape
    if family == "qkv":
        x = _qkv(B, N, H, torch.float32, cuda, seed=5, d=d)
        res = f32_precision(x, H, d ** -0.5)
        got, want = attention_against_plain(x, H, d ** -0.5)
    elif family == "mh":
        q, k, v, b = mh_inputs(B, N, H, d, torch.float32, 5, cuda)
        res = mh_f32_precision(q, k, v, b, H, d ** -0.5)
        got, want = mh_attention_against_plain(q, k, v, b, H, d ** -0.5)
    else:
        q, k, v = hm_inputs(B * H, N, torch.float32, 5, cuda, D=d)
        res = hm_f32_precision(q, k, v, d ** -0.5)
        got, want = hm_attention_against_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    if N == 1:
        _check_at_edge(got, want, N)
        return
    assert res["beyond"] == [], res
    assert {"out", "lse"} <= set(res["fault_beyond"]), res
    check_against_plain(got, want)
    if fa.head_dim_width(d) > fa.HEAD_DIMS[-1]:
        fault = group_unwritten(got, H, ("out",))
        assert compare_with_plain(fault, want)["beyond_bounds"] == ["out"]


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="head dim 48"):
        fa.qkv_attn_fwd(torch.zeros(1, 8, 3 * 2 * 48, device=cuda), 1.0, 2)
    with pytest.raises(ValueError, match="dtype"):
        fa.qkv_attn_fwd(torch.zeros(1, 8, 3 * D, device=cuda,
                                    dtype=torch.float16), 1.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.qkv_attn_fwd(torch.zeros(1, 3 * D, 8, device=cuda).transpose(1, 2),
                        1.0, 1)


def test_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step of a small 64-dim-head model: loss and gradient norm on
    the card (kernels) against the CPU (plain versions). attn_impl="pallas"
    keeps the kernels at its 4 and 8 tokens: K1/K2 in the encoder (A = 128)
    and K4 in the decoder (A = 64)."""
    geo = dict(img_size=32, num_frames=4, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=64,
               decoder_depth=1, decoder_num_heads=1,
               decoder_num_classes=1536, attn_impl="pallas")
    cfg = PretrainConfig(input_size=32, num_frames=4, batch_size=2,
                         dtype="float32", motion_loss_weight=True,
                         masking=MaskingConfig(mask_type="tube_bb",
                                               mask_ratio=0.5))
    gen = torch.Generator().manual_seed(3)
    clip = torch.randn(2, 4, 32, 32, 3, generator=gen)
    xy1 = torch.rand(2, 4, 2, generator=gen) * 12
    boxes = torch.cat([xy1, xy1 + 12], dim=-1)
    mask = masking.motion_tube_mask(boxes, temporal_positions=2,
                                    patches_per_side=2, mask_ratio=0.5,
                                    generator=gen)
    lr = np.full(2, 1e-3, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = create_model("pretrain_videomae_base_patch16_224",
                             device=dev, **geo)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {"clip": clip.to(dev), "boxes": boxes.to(dev)}, None,
                    0.5, mask=mask.to(dev))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert min(fa.launch_counts[k]
               for k in fa.QKV_F32_KERNELS + fa.HM_F32_KERNELS) >= 1
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", [(10, 1568, 3, 256), (10, 1568, 12, 64),
                                     (4, 100, 1, 256), (4, 100, 2, 64),
                                     (2, 3136, 12, 64)])
def test_mh_kernels_match_plain(cuda, dtype, B, N, H, D, bias):
    """K3 at chip_smoke.py's geometries (the MCA is 3 x 256): within the
    bounds, masked kv rows with zero dK/dV, planted faults rejected; in
    bf16 the backward's prep pass against its plain version."""
    q, k, v, b = mh_inputs(B, N, H, D, dtype, 0, cuda, bias)
    got, want = mh_attention_against_plain(q, k, v, b, H, D ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    if dtype == torch.bfloat16:
        res = check_mh_prep(q, k, got["out"], (2 * got["out"].float()).to(
            dtype), H, D ** -0.5)
        assert res["ks"] is None  # 1/8 and 1/16: dQ scales its accumulator
    assert masked_kv_grad(got, b) == 0.0
    ignored = None
    if bias:
        ignored, _ = mh_attention_against_plain(q, k, v, None, H, D ** -0.5)
    for fault, outputs in planted_faults(got, ignored, want).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("fused_kv", [True, False])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
@pytest.mark.parametrize("N", [1, 63, 65, 100, 1568])
def test_mh_forward_at_tile_edges(cuda, N, H, D, bias, fused_kv):
    """The bf16 K3 forward (TMA-fed wgmma, online softmax) and backward
    (prep pass, TMA-fed wgmma dK/dV and dQ kernels) at N on both sides of
    their 64-row tiles and 128-row blocks, with k and v as column views of
    one (B, N, 2A) tensor or as tensors of their own, against the plain
    versions."""
    q, k, v, b = mh_inputs(3, N, H, D, torch.bfloat16, N + D, cuda, bias)
    if not fused_kv:
        k, v = k.contiguous(), v.contiguous()
    assert (k.stride(1) == 2 * H * D) == fused_kv
    got, want = mh_attention_against_plain(q, k, v, b, H, D ** -0.5)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    if bias and N > 1:
        ignored, _ = mh_attention_against_plain(q, k, v, None, H, D ** -0.5)
        assert compare_with_plain(ignored, want)["beyond_bounds"]


@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
@pytest.mark.parametrize("N", [65, 100, 1568])
def test_mh_backward_with_a_scale_not_a_power_of_two(cuda, N, H, D):
    """scale 0.1: at head dim 64 the prep pass writes k * scale and dQ reads
    that copy; at 256 dQ folds the scale into its K strip in place."""
    q, k, v, b = mh_inputs(3, N, H, D, torch.bfloat16, 5, cuda)
    got, want = mh_attention_against_plain(q, k, v, b, H, 0.1)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert masked_kv_grad(got, b) == 0.0
    res = check_mh_prep(q, k, got["out"], (2 * got["out"].float()).to(
        q.dtype), H, 0.1)
    assert res["ks"] is (True if D == 64 else None)


@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
def test_mh_kernels_take_q_as_a_column_view(cuda, H, D):
    """q, k and v as column views of one (B, N, 3A) tensor: the prep pass
    and the forward read q on its own row stride too."""
    A = H * D
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 100, 3 * A, generator=g).to(torch.bfloat16).to(cuda)
    q, k, v = x[..., :A], x[..., A:2 * A], x[..., 2 * A:]
    assert q.stride(1) == 3 * A
    got, want = mh_attention_against_plain(q, k, v, None, H, D ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    check_mh_prep(q, k, got["out"], (2 * got["out"].float()).to(q.dtype), H,
                  D ** -0.5)


@pytest.mark.parametrize("H,D", [(2, 64), (1, 256)])
def test_mh_bf16_autograd_runs_the_prep_pass(cuda, H, D):
    q, k, v, b = mh_inputs(2, 100, H, D, torch.bfloat16, 2, cuda)
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention_mh(*ts, scale=D ** -0.5, num_heads=H, kv_bias=b)
     .float() ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.MH_KERNELS, 1)}
    # one writer per output, no atomics: the same call gives the same bits
    out, lse = fa.mh_attn_fwd(q, k, v, b, D ** -0.5, H)
    want = fa.mh_attn_bwd(q, k, v, b, out, lse, (2 * out.float()).to(
        q.dtype), D ** -0.5, H)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)


def test_mh_autograd_runs_the_kernels(cuda):
    q, k, v, b = mh_inputs(2, 100, 1, 256, torch.float32, 1, cuda)
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention_mh(*ts, scale=0.0625, num_heads=1, kv_bias=b)
     ** 2).sum().backward()
    # f32: delta is mh_delta's reduction, no prep pass
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.MH_F32_KERNELS, 1)}
    refs = [t.detach().cpu().clone().requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention_mh(*refs, scale=0.0625, num_heads=1,
                           kv_bias=b.cpu()) ** 2).sum().backward()
    # within 5e-4 of the CPU's gradients, held row by row as
    # main_path.f32_rows_beyond holds K3's outputs: where the CPU's own row
    # is more than 5e-4 off the same loss's float64 gradient (dV of sample
    # 0's one unmasked column sums 100 like terms, |dV| ~ 500), within
    # PRECISION_FACTOR of the CPU's error against float64
    exact = [t.detach().cpu().double().requires_grad_(True)
             for t in (q, k, v)]
    s = (exact[0] * fa._rounded(0.0625, torch.float32)) @ \
        exact[1].transpose(-1, -2) + b.cpu().double()[:, None, :]
    ((torch.softmax(s, -1) @ exact[2]) ** 2).sum().backward()
    for t, r, e in zip(ts, refs, exact):
        held = f32_rows_beyond(t.grad.cpu(), r.grad, e.grad, 5e-4)
        assert held["beyond"] == 0, held


@pytest.mark.parametrize("B,N,H,D,scale", [
    (4, 1568, 3, 256, None), (4, 1568, 4, 192, None), (4, 100, 1, 256, None),
    (4, 100, 1, 256, 0.1), (3, 200, 2, 192, 0.1), (4, 1568, 8, 128, None),
    (4, 1568, 16, 64, None), (4, 100, 2, 64, 0.1), (3, 200, 4, 32, None),
    (3, 130, 8, 16, 0.1)])
def test_k3_3xtf32_kernels_are_as_precise_as_f32(cuda, B, N, H, D, scale):
    """K3's f32 dQ at every head dim (3xTF32 on wgmma; the narrow kernel up
    to 128) and its forward and dK/dV at 256 and 192 (D streamed in
    64-column chunks): the MCA at a reduced batch, the MCA at 4, 8 and 16
    heads, the ragged N, scale 0.1, with the kv bias and k, v column views
    of one fused kv; dK/dV up to 128 on K2's kernel with its bias flag
    (csrc/wgmma_tf32_dkv.cuh). Against a float64 run each output is within
    PRECISION_FACTOR of the plain f32 version's error (dQ among them); the
    plain version with TF32 on misses that bound, on dK and dV too at the
    MCA's 8 x 128 and 16 x 64 (where the FMA kernel's run showed it)."""
    q, k, v, b = mh_inputs(B, N, H, D, torch.float32, 5, cuda)
    assert k.stride(1) == 2 * H * D
    res = mh_f32_precision(q, k, v, b, H, scale or D ** -0.5)
    assert res["beyond"] == [], res
    assert "dq" in res["fault_beyond"], res
    if (N, H, D) in ((1568, 8, 128), (1568, 16, 64)):
        assert {"dk", "dv"} <= set(res["fault_beyond"]), res


@pytest.mark.parametrize("fused_kv", [True, False])
@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("N", [1, 65, 100, 1568])
@pytest.mark.parametrize("H,D", [(1, 256), (2, 192), (2, 128), (2, 64),
                                 (4, 16)])
def test_k3_3xtf32_kernels_at_tile_edges(cuda, H, D, N, scale, fused_kv):
    """The same kernels against their plain versions at N on both sides of
    their 64-row tiles (32-row kv tiles in dQ at 128) and N = 1 (there held
    as _check_at_edge holds it: the plain version is exact, and dS is
    rounding noise around 0), with the kv bias, k and v fused or apart.
    Above N = 1 masked kv rows get zero dK/dV and the planted faults are
    rejected, dQ moved on the one-column sample's rows among them (at N =
    1 a sample may have its one column masked: then that row takes every
    query, in the plain version too)."""
    q, k, v, b = mh_inputs(2, N, H, D, torch.float32, N + D, cuda)
    if not fused_kv:
        k, v = k.contiguous(), v.contiguous()
    fa.reset_launch_counts()
    got, want = mh_attention_against_plain(q, k, v, b, H, scale or D ** -0.5)
    torch.cuda.synchronize()
    assert fa.launch_counts["mh_attn_fwd"] == 1
    assert fa.launch_counts["mh_attn_bwd_dkv"] == 1
    assert fa.launch_counts["mh_attn_bwd_dq"] == 1
    _check_at_edge(got, want, N)
    if N > 1:
        assert masked_kv_grad(got, b) == 0.0
        ignored, _ = mh_attention_against_plain(q, k, v, None, H,
                                                scale or D ** -0.5)
        faults = planted_faults(got, ignored, want)
        assert "dq_one_column_rows_off" in faults
        for fault, outputs in faults.items():
            assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_mh_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    # the launchers take built head dims only (flash_attention_mh pads 48
    # to 64 first; 128 is built now) and no kernel takes one above 256
    for width in (48, 264):
        y = torch.zeros(1, 8, width, device=cuda)
        with pytest.raises(ValueError, match=f"head dim {width}"):
            fa.mh_attn_fwd(y, y, y, None, 1.0, 1)
    x = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        h = x.half()
        fa.mh_attn_fwd(h, h, h, None, 1.0, 2)
    with pytest.raises(ValueError, match="kv_bias"):
        fa.mh_attn_fwd(x, x, x, torch.zeros(1, 8, device=cuda,
                                            dtype=torch.bfloat16), 1.0, 2)
    with pytest.raises(ValueError, match="packed"):
        t = torch.zeros(8, 1, 128, device=cuda).transpose(0, 1)
        fa.mh_attn_fwd(x, t, x, None, 1.0, 2)
    with pytest.raises(ValueError, match="aligned"):
        # a bf16 view whose rows start 2 bytes off a 16-byte boundary
        t = torch.zeros(1, 8, 136, device=cuda, dtype=torch.bfloat16)
        fa.mh_attn_fwd(x.bfloat16(), t[..., 1:129], x.bfloat16(), None, 1.0,
                       2)
    stat = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="bf16 backward's"):
        fa.mh_attn_bwd_prep(x, x, x, x, 1.0, 2)  # f32 has no prep pass
    h = x.bfloat16()
    with pytest.raises(ValueError, match="q \\* q_scale"):
        fa.mh_attn_bwd_dq(h, h, h, None, h, stat, h, h, 1.0, 2,
                          prep=(stat, None, None))
    with pytest.raises(ValueError, match="float32"):
        fa.mh_attn_bwd_dkv(h, h, h, None, h, stat, h, h, h, 1.0, 2,
                           prep=(stat.double(), h, None))
    with pytest.raises(ValueError, match="like q"):
        fa.mh_attn_bwd_dkv(h, h, h, None, h, stat, h, h, h, 1.0, 2,
                           prep=(stat, h[:, :4], None))


def test_bb_finetune_step_on_the_card_matches_the_cpu(cuda):
    """One f32 BB-focused MCA step of a small model (MCA 1 x 256): loss
    and gradient norm on the card (kernels) against the CPU. 128 tokens
    (16 frames at 64^2) keep the backbone on the flat K1/K2 route."""
    cfg = FinetuneConfig(batch_size=2, input_size=64, num_frames=16,
                         dtype="float32", drop_path=0.0, mixup=0.0,
                         cutmix=0.0)
    batch = synthetic_finetune_batch(2, torch.Generator().manual_seed(2),
                                     "cpu")
    batch = {"clip": batch["clip"][:, :, :64, :64],
             "boxes": batch["boxes"] / 3.5, "label": batch["label"]}
    lr = np.full(2, 1e-4, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = finetune_model(cfg, device=dev, depth=2, embed_dim=256,
                               num_heads=4, mca_num_heads=1)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr, layer_decay=0.75)
        step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                                  device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {k: v.to(dev) for k, v in batch.items()}, None)
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
        if dev == "cuda":
            assert min(fa.launch_counts[k]
                       for k in fa.QKV_F32_KERNELS + fa.MH_F32_KERNELS) >= 1
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N", [(32, 3, 1568), (2, 6, 1568), (4, 3, 100),
                                   (2, 6, 3136)])
def test_hm_kernels_match_plain(cuda, dtype, B, H, N):
    """K4 at chip_smoke.py's geometries (the ViT-S runner's decoder is
    B=32, H=3): within the bounds, planted faults rejected."""
    q, k, v = hm_inputs(B * H, N, dtype, 0, cuda)
    got, want = hm_attention_against_plain(q, k, v, SCALE)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in hm_planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("N", [1, 63, 65, 100, 1568, 3136])
def test_hm_forward_at_tile_edges(cuda, N):
    """The redesigned bf16 K4 forward (two TMA-fed wgmma passes) at N on
    both sides of its 64-row tiles and 128-row blocks, against the plain
    version (and the backward with it), planted faults rejected."""
    q, k, v = hm_inputs(6, N, torch.bfloat16, N, cuda)
    got, want = hm_attention_against_plain(q, k, v, SCALE)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    for fault, outputs in hm_planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("N", [1, 63, 65, 100, 1568, 3136])
def test_hm_backward_at_tile_edges(cuda, N):
    """The redesigned bf16 K4 backward (prep pass, TMA-fed wgmma dK/dV and
    dQ kernels) at N on both sides of its 64-row tiles and 128-row blocks,
    against the plain versions; the prep pass against its own."""
    q, k, v = hm_inputs(5, N, torch.bfloat16, N + 1, cuda)
    got, want = hm_attention_against_plain(q, k, v, SCALE)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    res = check_hm_prep(q, k, got["out"], (2 * got["out"].float()).to(
        q.dtype), SCALE)
    assert res["ks"] is None  # 0.125: dQ scales its accumulator
    for fault, outputs in hm_planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


@pytest.mark.parametrize("N", [65, 100, 1568])
def test_hm_backward_with_a_scale_not_a_power_of_two(cuda, N):
    """scale 0.1: the prep pass writes k * scale and dQ reads that copy."""
    q, k, v = hm_inputs(5, N, torch.bfloat16, 5, cuda)
    got, want = hm_attention_against_plain(q, k, v, 0.1)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert check_hm_prep(q, k, got["out"], (2 * got["out"].float()).to(
        q.dtype), 0.1)["ks"] is True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("N", [1, 65, 200, 1568])
def test_hm_kernels_at_head_dims_16_and_32(cuda, hd, N, dtype):
    """K4 at the tiny presets' head dims (64- and 32-byte rows, their own
    swizzles in bf16), forward and backward at N on both sides of the
    tiles, scale D^-0.5 (at 32 no power of two: dQ's scaled-K copy):
    within the bounds, the prep pass against its own, faults rejected."""
    q, k, v = hm_inputs(4, N, dtype, hd + N, cuda, D=hd)
    got, want = hm_attention_against_plain(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    _check_at_edge(got, want, N)
    if dtype == torch.bfloat16:
        res = check_hm_prep(q, k, got["out"], (2 * got["out"].float()).to(
            q.dtype), hd ** -0.5)
        assert res["ks"] is (True if hd == 32 else None)
    faults = hm_planted_faults(got)
    if N == 1:  # dQ is rounding noise around 0 there (_check_at_edge)
        del faults["dq_zero"]
    for fault, outputs in faults.items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_hm_autograd_at_head_dim_16_runs_the_kernels(cuda):
    q, k, v = hm_inputs(4, 160, torch.bfloat16, 3, cuda, D=16)
    ts = [t.reshape(2, 2, 160, 16).clone().requires_grad_(True)
          for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention(*ts, scale=0.25).float() ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_KERNELS, 1)}


def test_hm_bf16_autograd_runs_the_prep_pass(cuda):
    q, k, v = hm_inputs(6, 100, torch.bfloat16, 2, cuda)
    ts = [t.reshape(2, 3, 100, D).clone().requires_grad_(True)
          for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention(*ts, scale=SCALE).float() ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_KERNELS, 1)}
    # one writer per output, no atomics: the same call gives the same bits
    out, lse = fa.hm_attn_fwd(q, k, v, SCALE)
    want = fa.hm_attn_bwd(q, k, v, out, lse, (2 * out.float()).to(q.dtype),
                          SCALE)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad.reshape(w.shape), w)


def test_hm_autograd_runs_the_kernels(cuda):
    q, k, v = hm_inputs(6, 100, torch.float32, 1, cuda)
    ts = [t.reshape(2, 3, 100, D).clone().requires_grad_(True)
          for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention(*ts, scale=SCALE) ** 2).sum().backward()
    # f32: delta is hm_delta's reduction, no prep pass
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_F32_KERNELS, 1)}
    refs = [t.detach().cpu().clone().requires_grad_(True) for t in ts]
    (fa.flash_attention(*refs, scale=SCALE) ** 2).sum().backward()
    for t, r in zip(ts, refs):
        np.testing.assert_allclose(t.grad.cpu().numpy(), r.grad.numpy(),
                                   atol=5e-4, rtol=0)


def test_hm_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 8, 48, device=cuda)  # built for 16, 32 and 64
    with pytest.raises(ValueError, match="head dim"):
        fa.hm_attn_fwd(x, x, x, 1.0)
    h = torch.zeros(2, 8, D, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.hm_attn_fwd(h, h, h, 1.0)
    x = torch.zeros(2, 8, D, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(8, 2, D, device=cuda).transpose(0, 1)
        fa.hm_attn_fwd(x, t, x, 1.0)
    stat = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError, match="bf16 backward's"):
        fa.hm_attn_bwd_prep(x, x, x, x, 1.0)  # f32 has no prep pass
    h = x.bfloat16()
    with pytest.raises(ValueError, match="q \\* scale"):
        fa.hm_attn_bwd_dq(h, h, h, h, stat, h, h, 1.0,
                          prep=(stat, None, None))
    with pytest.raises(ValueError, match="float32"):
        fa.hm_attn_bwd_dkv(h, h, h, h, stat, h, h, h, 1.0,
                           prep=(stat.double(), h, None))
    with pytest.raises(ValueError, match="like q"):
        fa.hm_attn_bwd_dkv(h, h, h, h, stat, h, h, h, 1.0,
                           prep=(stat, h[:, :4], None))


def test_vits_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step at ViT-S widths (384 / 6 heads, 192 / 3 heads), 2+1
    blocks, 8 frames at 112^2: the decoder runs K4 on 196 tokens."""
    geo = dict(img_size=112, num_frames=8, encoder_depth=2, decoder_depth=1)
    cfg = PretrainConfig(input_size=112, num_frames=8, batch_size=2,
                         dtype="float32", motion_loss_weight=True,
                         masking=MaskingConfig(mask_type="tube_bb"))
    gen = torch.Generator().manual_seed(4)
    clip = torch.randn(2, 8, 112, 112, 3, generator=gen)
    xy1 = torch.rand(2, 8, 2, generator=gen) * 50
    boxes = torch.cat([xy1, xy1 + 40], dim=-1)
    mask = masking.motion_tube_mask(boxes, temporal_positions=4,
                                    patches_per_side=7, generator=gen)
    lr = np.full(2, 1e-3, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = create_model(VITS_MODEL, device=dev, **geo)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {"clip": clip.to(dev), "boxes": boxes.to(dev)}, None,
                    0.5, mask=mask.to(dev))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_F32_KERNELS, 1)}
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


def test_runner_saves_and_resumes_on_the_card(cuda, tmp_path):
    """The pretrain runner on the card, 2 epochs at once and 1 + 1 resumed
    from checkpoint-0: the same steps, checkpoints and losses."""
    argv = ["--model", VITS_MODEL, "--decoder_depth", "1", "--synthetic",
            "4", "--batch_size", "2", "--input_size", "112", "--num_frames",
            "8", "--epochs", "2", "--warmup_epochs", "0", "--save_ckpt_freq",
            "1", "--decode_height", "128", "--decode_width", "160",
            "--dtype", "float32"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    run = lambda out: pretrain_mofo.main(pretrain_mofo.get_args(  # noqa
        argv + ["--output_dir", str(out)], mofo_defaults=True))
    fa.reset_launch_counts()
    assert run(whole).step == 4
    assert fa.launch_counts["hm_attn_fwd"] == 4  # 1 decoder Block, 4 steps
    cut.mkdir()
    (cut / "checkpoint-0.pth").write_bytes(
        (whole / "checkpoint-0.pth").read_bytes())
    state = run(cut)
    assert state.step == 4 and state.opt_state.count == 4
    assert sorted(p.name for p in cut.glob("*.pth")) == [
        "checkpoint-0.pth", "checkpoint-1.pth"]
    logs = [[json.loads(line) for line in (d / "log.txt").read_text()
             .splitlines()] for d in (whole, cut)]
    assert [x["epoch"] for x in logs[1]] == [1]
    np.testing.assert_allclose(logs[1][0]["train_loss"],
                               logs[0][1]["train_loss"], rtol=1e-4)


@pytest.mark.parametrize("pipeline", ["finetune", "eval", "view0", "view1",
                                      "view2"])
def test_augmentation_on_the_card_matches_the_cpu(cuda, pipeline):
    """The finetune runner's augmentations at a small decode size (8 clips
    of 16 x 72 x 96, out 64) on the card against the CPU with the same
    draws, which force all 15 RandAugment ops in both interpolations (8
    clips of 4 layers are enough slots)."""
    batch = synthetic_clips_u8(8, torch.Generator().manual_seed(1), "cpu",
                               hw=(72, 96))
    draws = forced_draws(8, (72, 96), out_size=64)
    got = {}
    for dev in ("cpu", "cuda"):
        b = {k: v.to(dev) for k, v in batch.items()}
        if pipeline == "finetune":
            got[dev] = A.finetune_augment(None, b["clip"], 64,
                                          boxes=b["boxes"],
                                          draws=moved_draws(draws, dev))
        elif pipeline == "eval":
            got[dev] = A.eval_augment(b["clip"], 64, 64, boxes=b["boxes"])
        else:
            got[dev] = A.test_view_augment(b["clip"], int(pipeline[-1]), 64,
                                           64, boxes=b["boxes"])
    res = augment_against_cpu(got["cuda"], got["cpu"])
    assert res["share_within"] >= AUG_SHARE, res
    assert res["boxes_max_abs_err"] <= 1e-3, res


@pytest.mark.parametrize("route", ["qkv", "mh_d64", "mh_d256", "hm"])
def test_fp16_boundary_runs_the_bf16_kernels(cuda, route):
    """An fp16 caller of each kernel family gets the bf16 kernels' numbers
    in f16, and f16 gradients, through the kernels (launches counted)."""
    g = torch.Generator().manual_seed(0)
    bias = None
    if route == "qkv":
        shapes = [(2, 200, 3 * 128)]
        call = lambda x: fa.flash_attention_qkv(  # noqa: E731
            x, scale=0.125, num_heads=2)
        kernels = fa.QKV_KERNELS
    elif route.startswith("mh"):
        H, D = (2, 64) if route == "mh_d64" else (1, 256)
        shapes = [(2, 200, H * D)] * 3
        bias = torch.where(torch.rand(2, 200, generator=g) < 0.5, 0.0,
                           -1e30).to(cuda)
        bias[:, 0] = 0.0
        call = lambda q, k, v: fa.flash_attention_mh(  # noqa: E731
            q, k, v, scale=D ** -0.5, num_heads=H, kv_bias=bias)
        kernels = fa.MH_KERNELS
    else:
        shapes = [(2, 3, 200, 64)] * 3
        call = lambda q, k, v: fa.flash_attention(q, k, v,  # noqa: E731
                                                  scale=0.125)
        kernels = fa.HM_KERNELS
    xs = [torch.randn(s, generator=g).half().to(cuda) for s in shapes]
    width = shapes[0][-1] // 3 if route == "qkv" else shapes[0][-1]
    weight = torch.linspace(-1, 1, width, device=cuda)
    runs = {}
    for dtype in (torch.float16, torch.bfloat16):
        ins = [x.to(dtype).clone().requires_grad_(True) for x in xs]
        fa.reset_launch_counts()
        out = call(*ins).to(torch.float16)
        (out.float() * weight).sum().backward()
        assert all(fa.launch_counts[k] == 1 for k in kernels), route
        runs[dtype] = (out.detach(), [t.grad for t in ins])
    (out16, grads16), (out_bf, grads_bf) = runs[torch.float16], runs[
        torch.bfloat16]
    assert out16.dtype == torch.float16 and torch.equal(out16, out_bf)
    for a, b in zip(grads16, grads_bf):
        assert a.dtype == torch.float16 and torch.equal(a, b.half())


def test_fp16_finetune_step_and_its_skip_on_the_card(cuda):
    """Two fp16 BB-focused MCA steps (ViT-B width, 2 Blocks, B=2) under the
    loss scale, then a step with one clip scaled to inf: skipped, the scale
    halved, the parameters, moments and count as they were."""
    _, state, step, gen, batch, _ = build_finetune_step(2, depth=2,
                                                        dtype="float16")
    fa.reset_launch_counts()
    for _ in range(2):
        state, m = step(state, batch, gen)
        assert float(m["loss_scale"]) == 128.0 and float(m["skipped"]) == 0
        assert np.isfinite(float(m["loss"]))
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_KERNELS, 4),
                                **dict.fromkeys(fa.MH_KERNELS, 2)}
    opt = state.opt_state
    kept = {n: p.detach().clone() for n, p in state.params.items()}
    mu = {n: t.clone() for n, t in opt.mu.items()}
    bad = dict(batch, clip=batch["clip"].clone())
    bad["clip"][0] = float("inf")
    state, m = step(state, bad, gen)
    assert float(m["skipped"]) == 1.0 and float(m["loss_scale"]) == 64.0
    assert opt.count == 2 and state.step == 3
    for n, p in state.params.items():
        assert torch.equal(p.detach(), kept[n]) and torch.equal(opt.mu[n],
                                                                mu[n]), n


def test_finetune_step_with_augmentation_on_the_card(cuda):
    """The BB-focused MCA step on uint8 clips augmented inside the step
    (RandAugment, crop, flip, erasing; ViT-B width, 2 Blocks, B=2)."""
    model, state, step, gen, batch, _ = build_finetune_step(2, depth=2,
                                                            augment=True)
    assert batch["clip"].dtype == torch.uint8
    before = model.head.weight.detach().clone()
    fa.reset_launch_counts()
    state, m = step(state, batch, gen)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert not torch.equal(model.head.weight, before)
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_KERNELS, 2),
                                **dict.fromkeys(fa.MH_KERNELS, 1)}


def test_finetune_runner_on_the_card(cuda, tmp_path, capsys):
    """cli.finetune_mofo on the card (ViT-B BB-focused MCA at 64^2, 128
    tokens on the flat route): one epoch, checkpoint-best, the multi-view
    test, the kernels launched by the train steps and the eval calls."""
    argv = ["--synthetic", "4", "--batch_size", "2", "--input_size", "64",
            "--epochs", "1", "--warmup_epochs", "0", "--decode_height", "72",
            "--decode_width", "96", "--output_dir", str(tmp_path)]
    fa.reset_launch_counts()
    state = finetune_mofo.main(finetune_mofo.get_args(argv,
                                                      bb_defaults=True))
    assert state.step == 2
    assert (tmp_path / "checkpoint-best.pth").is_file()
    assert capsys.readouterr().out.count("Final test: Acc@1") == 1
    # 2 train steps; eval calls: 2 validation batches + the 4 synthetic
    # clips tested one view each, in 2 batches
    assert fa.launch_counts["qkv_attn_bwd_dq"] == 2 * 12
    assert fa.launch_counts["mh_attn_bwd_dq"] == 2
    assert fa.launch_counts["qkv_attn_fwd"] == (2 + 2 + 2) * 12
    assert fa.launch_counts["mh_attn_fwd"] == 2 + 2 + 2


def _memory_clips(tmp_path, n=6):
    """n listed videos (1 KB placeholders) served by MemoryReader, with
    their motion boxes at a 64 x 80 decode."""
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"v{i}.mp4"))
        (tmp_path / f"v{i}.mp4").write_bytes(b"\0" * 1024)
    (tmp_path / "bb.json").write_text(json.dumps(memory_box_json(paths,
                                                                 (64, 80))))
    return ([ClipEntry(p, i % 3) for i, p in enumerate(paths)],
            MotionBoxIndex.from_file(str(tmp_path / "bb.json")))


@pytest.mark.parametrize("kind,workers", [
    ("test", 2), ("validation", 2), ("train", 1), ("pretrain", 1)])
def test_memory_datasets_reach_the_card_as_on_the_cpu(cuda, tmp_path, kind,
                                                      workers):
    """The in-memory datasets through PrefetchLoader onto the card (one
    thread or two) equal the CPU's batches after the same np.random.seed:
    frames, ids, labels, tags and boxes."""
    entries, boxes = _memory_clips(tmp_path)
    kw = dict(decode_size=(64, 80), boxes=boxes, reader=MemoryReader,
              num_frames=4)
    ds = (P.PretrainClipDataset(entries, sampling_rate=4, **kw)
          if kind == "pretrain" else
          P.FinetuneClipDataset(entries, mode=kind, **kw))
    got = {}
    for device, n in ((cuda, workers), ("cpu", 1)):
        np.random.seed(3)
        got[str(device)] = list(P.PrefetchLoader(
            ds, 4, device=device, drop_last=False, num_workers=n))
    assert len(got["cuda"]) == len(got["cpu"]) == -(-len(ds) // 4)
    for a, b in zip(got["cuda"], got["cpu"]):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].device.type == "cuda"
            assert torch.equal(a[k].cpu(), b[k]), k


def test_the_loader_pins_its_host_batches_for_the_card(cuda, tmp_path):
    entries, boxes = _memory_clips(tmp_path)
    ds = P.FinetuneClipDataset(entries, mode="validation", num_frames=4,
                               decode_size=(64, 80), boxes=boxes,
                               reader=MemoryReader)
    batch = P.PrefetchLoader(ds, 4, device=cuda)._fetch(np.arange(4), None)
    assert all(v.is_pinned() for v in batch.values())
    ids = frame_ids(batch["clip"].numpy())
    assert ids.shape == (4, 4) and (ids >= 0).all()
    host = P.PrefetchLoader(ds, 4, device="cpu")._fetch(np.arange(4), None)
    assert not any(v.is_pinned() for v in host.values())


def _textured_pair(H, W, shift, seed):
    g = np.random.RandomState(seed)
    base = (g.rand(H + 16, W + 16) * 255).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
            + np.roll(base, 1, (0, 1))) / 4
    dx, dy = shift
    return base[8:8 + H, 8:8 + W], base[8 - dy:8 - dy + H, 8 - dx:8 - dx + W]


@pytest.mark.parametrize("H,W,P", [(64, 64, 1), (50, 70, 3), (256, 320, 2)])
def test_tvl1_on_the_card_matches_the_cpu(cuda, H, W, P):
    """The factory's TV-L1 (tensor ops, no kernel of the port) on the card
    against the CPU: max 1e-3 px, p99 1e-4 (chip_smoke's bounds); a batch
    of pairs equals each pair alone on the card."""
    pairs = [_textured_pair(H, W, (2, 1), seed) for seed in range(P)]
    prev = np.stack([a for a, _ in pairs])
    nxt = np.stack([b for _, b in pairs])
    kw = dict(n_iters=30) if H > 64 else {}
    card = flow.tvl1_flow(prev, nxt, device=cuda, **kw)
    assert card.device.type == "cuda" and card.shape == (P, H, W, 2)
    cpu = flow.tvl1_flow(prev, nxt, device="cpu", **kw)
    d = (card.cpu() - cpu).abs().numpy()
    assert d.max() <= 1e-3 and np.percentile(d, 99) <= 1e-4
    one = flow.tvl1_flow(prev[-1], nxt[-1], device=cuda, **kw)
    assert torch.equal(one, card[-1])


def test_motion_boundary_on_the_card_matches_the_cpu(cuda):
    x = torch.randn(7, 48, 40, generator=torch.Generator().manual_seed(0))
    torch.backends.cudnn.allow_tf32 = True  # no convolution library is used
    try:
        got = motion_maps.motion_boundary(x.to(cuda)).cpu()
        sts = motion_maps.motion_sts(x[:, :40].to(cuda), 5, 40).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    np.testing.assert_allclose(got.numpy(),
                               motion_maps.motion_boundary(x).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(sts.numpy(),
                               motion_maps.motion_sts(x[:, :40], 5,
                                                      40).numpy(),
                               atol=1e-5, rtol=0)


def test_motion_factory_on_the_card_matches_the_cpu(cuda, tmp_path):
    import cv2

    path = tmp_path / "sq.mp4"
    g = np.random.RandomState(0)
    bg = g.randint(0, 120, (64, 64, 3)).astype(np.uint8)
    fg = g.randint(130, 256, (20, 20, 3)).astype(np.uint8)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 64))
    for i in range(8):
        frame = bg.copy()
        frame[12 + 2 * i:32 + 2 * i, 10 + 3 * i:30 + 3 * i] = fg
        w.write(frame)
    w.release()
    got = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.json")
        res = motion_factory.main(motion_factory.get_args(
            ["--data_path", str(path), "--output", out, "--device",
             device]))
        assert not res["skipped"]
        with open(out) as f:
            got[device] = json.load(f)
    assert got["cuda"] == got["cpu"] and len(got["cpu"]["sq"]) == 8


# --- first-order only: the kernel routes refuse a double backward ----------


def _routes(cuda):
    """(input, output) of each kernel route's autograd function on the
    card: K1/K2 bf16, K3 at head dim 64 with a bias row, K4 at 32."""
    g = torch.Generator().manual_seed(4)

    def leaf(*shape):
        return torch.randn(shape, generator=g).to(cuda, torch.bfloat16) \
            .requires_grad_(True)

    qkv = leaf(2, 160, 3 * 2 * D)
    q, k, v = (leaf(2, 160, 2 * D) for _ in range(3))
    hq, hk, hv = (leaf(2, 2, 160, 32) for _ in range(3))
    return {
        "qkv": (qkv, fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=2)),
        "mh": (q, fa.flash_attention_mh(
            q, k, v, scale=SCALE, num_heads=2,
            kv_bias=torch.zeros(2, 160, device=cuda))),
        "hm": (hq, fa.flash_attention(hq, hk, hv, scale=32 ** -0.5)),
    }


@pytest.mark.parametrize("route", ["qkv", "mh", "hm"])
def test_kernel_routes_refuse_a_double_backward(cuda, route):
    x, out = _routes(cuda)[route]
    w = torch.randn(out.shape[-1], device=cuda,
                    dtype=torch.bfloat16).requires_grad_(True)
    with pytest.raises(RuntimeError, match="first-order only"):
        torch.autograd.grad(((out * w).sum(-1).float() ** 2).sum(), [x, w],
                            create_graph=True)


@pytest.mark.parametrize("route", ["qkv", "mh", "hm"])
def test_first_order_kernel_backward_is_the_wrappers_own(cuda, route):
    """The marked backwards return what the wrappers compute, bit for
    bit."""
    x, out = _routes(cuda)[route]
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        5)).to(cuda, out.dtype)
    fn = out.grad_fn if route != "hm" else out.grad_fn.next_functions[0][0]
    saved = fn.saved_tensors  # the function's own (K4's under a reshape)
    got, = torch.autograd.grad(out, x, dout)
    if route == "qkv":
        want = fa.qkv_attn_bwd(*saved, dout, SCALE, 2)
    elif route == "mh":
        want = fa.mh_attn_bwd(*saved, dout, SCALE, 2)[0]
    else:
        want = fa.hm_attn_bwd(*saved, dout.reshape(saved[-2].shape),
                              32 ** -0.5)[0].reshape(x.shape)
    assert torch.equal(got, want)


# --- the optimizer zoo and AdaHessian on the card --------------------------


@pytest.mark.parametrize("opt", ["lamb", "adafactor", "adamp", "sgdp",
                                 "lookahead_adamw", "novograd"])
def test_zoo_update_on_the_card_matches_the_cpu(cuda, opt):
    model = create_model(VITS_MODEL, device="cpu", seed=3, encoder_depth=1,
                         decoder_depth=1)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(6)
    grads = [{n: torch.randn(p.shape, generator=g) for n, p in
              params.items()} for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = {n: t.to(dev).clone() for n, t in params.items()}
        tx = optim.create_optimizer(p, opt=opt, lr_schedule=np.full(
            3, 1e-3, np.float32), clip_grad=1.0, layer_decay=0.75)
        st = tx.init(p)
        for gr in grads:
            tx.update({n: t.to(dev) for n, t in gr.items()}, st, p)
        out[dev] = {n: t.cpu() for n, t in p.items()}
    for n, want in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][n].numpy(), want.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)


def test_adahessian_step_on_the_card_runs_no_kernel(cuda):
    cfg = PretrainConfig(model=VITS_MODEL, batch_size=2, dtype="bfloat16",
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True)
    model = create_model(VITS_MODEL, device=cuda, seed=3, encoder_depth=1,
                         decoder_depth=1, attn_impl="xla",
                         dtype=torch.bfloat16)
    lr = np.full(2, 1e-4, np.float32)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                opt="adahessian", lr_schedule=lr)
    step = make_pretrain_step(model, tx, cfg, lr, second_order=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    from mofo_tpu_torch.tools.main_path import synthetic_batch
    batch = synthetic_batch(2, gen, "cuda")
    fa.reset_launch_counts()
    state, m = step(TrainState.create(model, tx), batch, gen, 0.5)
    assert not any(fa.launch_counts.values())
    assert np.isfinite(float(m["loss"])) and state.opt_state.count == 1
    assert all(torch.isfinite(h).all() for h in state.opt_state.nu.values())


def test_tensor_parallel_functions_on_cuda_tensors(cuda, tmp_path):
    """copy_to, reduce_from, gather_from (a model axis) and gather_fsdp (an
    fsdp axis) on CUDA tensors, forward and backward, in 2 ranks sharing
    the card over gloo (python -m mofo_tpu_torch.tools.mesh_ranks tp),
    against what they are defined to compute: exact, as each sums two
    values."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mofo_tpu_torch.tools.mesh_ranks", "tp",
         str(tmp_path)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0"))
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for r in range(2):
        with open(tmp_path / f"tp-{r}.json") as f:
            errs = json.load(f)
        assert len(errs) == 7 and all(v == 0.0 for v in errs.values()), errs
