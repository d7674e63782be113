"""Multihead flash attention, forward and backward, as hand-written CUDA
kernels for Hopper.

Two interfaces of mofo_tpu/ops/flash_attention.py and the TPU kernels they
run:
  - flash_attention_qkv (:1341), the fused-qkv self-attention of every
    Block: K1 (_qkv_fwd_impl / _mh_fwd_kernel) and K2 (_qkv_bwd_impl /
    _qkv_bwd_kernel, _qkv_bwd_kernel_houter), here csrc/qkv_flash_attention.cu.
    qkv is the fused (B, N, 3A) projection: [0, A) q, [A, 2A) k, [2A, 3A) v,
    A = H * D. The forward returns out (B, N, A)
    and a compact (B, H, N) f32 row log-sum-exp; the backward returns one
    (B, N, 3A) dqkv, in bf16 after a prep pass (qkv_attn_bwd_prep: delta =
    rowsum(dO * O) and q * q_scale, read once) that its two kernels share,
    in f32 after mh_delta's reduction.
  - flash_attention_mh (:901), separate q, k, v (B, N, A) with an optional
    (B, N) f32 kv bias row (0 / -1e30), the masked cross-attention of the
    BB-focused classifier's MCA block: K3 (_mh_fwd_impl / _mh_fwd_kernel
    with has_bias, _mh_bwd_impl / _mh_dqkv_kernel), here
    csrc/mh_flash_attention.cu; its bf16 backward runs a prep pass too
    (mh_attn_bwd_prep), its f32 backward after mh_delta's reduction.

Head dims. mofo_tpu's kernels take any head dim D, and so do these: every
kernel family is built for HEAD_DIMS = (16, 32, 64, 128, 192, 256) as
compile-time instances, and above 256 takes any multiple of SPLIT_BOX = 64
at run time (csrc/wgmma_attn_split.cuh's column-split kernels: the head dim
streamed through the score products, the output split in groups of 256
columns over the grid). On the card the autograd functions pad any other D
with zero columns to its width (head_dim_width: the next built head dim up
to 256, the next multiple of 64 above) and slice the results back, in one
place (fwd_at_width and bwd_at_width, on head_dim_width, pad_head_dim and
unpad_head_dim): zero columns of q and k add exact zeros to QK^T, zero
columns of v give zero output columns, and the scale stays the caller's.
A D that is its own width takes no copy. The plain versions on the CPU take
any D as it is.

Every bf16 kernel is a TMA + wgmma kernel (csrc/wgmma_tiles.cuh; the
backwards up to head dim 128 share csrc/wgmma_attn_bwd.cuh, the K3 forward
and every backward at 192 and 256 csrc/wgmma_attn_wide.cuh's strip
kernels, every kernel above 256 csrc/wgmma_attn_split.cuh's column-split
ones; K1/K2 reach both through K3's entry points). In f32, K1's, K3's
and K4's forward up to head dim 128, K2's and K3's dK/dV up to 128 and
K2's and K3's dQ are TMA + wgmma kernels too, their products in 3xTF32
(csrc/wgmma_tf32.cuh: each operand split into two TF32 parts, three TF32
products, as accurate as f32; the forward in wgmma_tf32_fwd.cuh, K3's with
its bias row, K4's in two passes; dK/dV in wgmma_tf32_dkv.cuh, K3's with
its bias; dQ in wgmma_tf32_dq.cuh, K2's through K3's entry point), as are
K3's forward and dK/dV at head dims 192 and 256 (wgmma_tf32_wide.cuh) and,
above 256 (and K4's forward at 192 and 256), the column-split kernels of
every family (wgmma_tf32_split.cuh; K4's forward in two passes). K4's f32
dK/dV and dQ are K3's at every head dim (its entry points call K3's
launchers with one head a plane and no bias). No kernel runs on FMAs.

fp16 callers (the fp16 finetune) run the bf16 kernels: each public entry
point casts f16 operands to bf16 and the output back to f16 inside autograd,
so the cotangents come back as f16, as mofo_tpu's _f16_boundary does
(:413-424, applied at :435-439, :920-925 and :1356); the kernels themselves
take f32 and bf16 only.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel (or
the wrapper raises), a CPU tensor to the plain PyTorch version below, which
repeats the kernel's numerics (module docstring of the .cu file):
  - the scale is folded into q in the input dtype;
  - scores and softmax statistics are f32;
  - P is rounded to the input dtype before P.V; 1/l divides the output;
  - bf16 works in base 2 (exp2/log2, LSE in log2 units, dK rescaled by
    1/log2 e), f32 in base e;
  - bf16 dS is the bf16 product of P with the rounded f32 (dP - delta);
  - (K3) the bias is added to the scores after the scale fold.

A third interface, flash_attention (:427), takes head-major (B, H, N, D)
q, k, v and runs K4 (_fwd_impl / _fwd_kernel, _bwd_impl / _dq_kernel and
_dkv_kernel), here csrc/hm_flash_attention.cu on the (B*H, N, D) view. Its
numerics differ from K1/K3's in two ways: it works in base e in
every dtype, and it rounds the normalized p / l (not the un-normalized P)
to the input dtype before P.V. Its bf16 backward runs a prep pass
(hm_attn_bwd_prep: delta and q * scale) before its two kernels, as K2's.

The three autograd functions are first-order only: their backwards run on
the forward's saved output and LSE, which carry no graph. Each backward is
marked once_differentiable and first_order_only: a create_graph=True
backward through it (AdaHessian's Hessian-vector product) raises instead of
returning a product without attention's second-order terms.
once_differentiable alone does not: the error node it puts on the backward's
outputs hangs off detached copies, so a torch.autograd.grad(..., inputs=
params) never reaches it and the product comes back short. A second-order
step takes the plain attention route (attn_impl="xla"), as mofo_tpu's does
(its Pallas backward kernels define a first-order VJP only).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

LOG2E = 1.4426950408889634
# the head dims every kernel family (K1/K2, K3, K4) is built for as
# compile-time instances: 64 is every registry preset's (256 the MCA's, 16
# and 32 the tiny presets'), and any other D up to 256 runs at the next of
# them, zero-padded
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
# above HEAD_DIMS the column-split kernels take the head dim at run time in
# boxes of SPLIT_BOX columns (one TMA box, one 128-byte swizzle atom), so
# any other D runs zero-padded to the next multiple of it
SPLIT_BOX = 64

# the bf16 backward runs qkv_attn_bwd_prep once before its two kernels; the
# f32 backward runs the two kernels alone (QKV_F32_KERNELS), after
# mh_delta's reduction
QKV_KERNELS = ("qkv_attn_fwd", "qkv_attn_bwd_prep", "qkv_attn_bwd_dkv",
               "qkv_attn_bwd_dq")
QKV_F32_KERNELS = ("qkv_attn_fwd", "qkv_attn_bwd_dkv", "qkv_attn_bwd_dq")
# as K2: mh_attn_bwd_prep and hm_attn_bwd_prep run in bf16 only (the
# *_F32_KERNELS are without them)
MH_KERNELS = ("mh_attn_fwd", "mh_attn_bwd_prep", "mh_attn_bwd_dkv",
              "mh_attn_bwd_dq")
MH_F32_KERNELS = ("mh_attn_fwd", "mh_attn_bwd_dkv", "mh_attn_bwd_dq")
HM_KERNELS = ("hm_attn_fwd", "hm_attn_bwd_prep", "hm_attn_bwd_dkv",
              "hm_attn_bwd_dq")
HM_F32_KERNELS = ("hm_attn_fwd", "hm_attn_bwd_dkv", "hm_attn_bwd_dq")
KERNELS = QKV_KERNELS + MH_KERNELS + HM_KERNELS
# launches of each CUDA kernel by its wrapper since the last reset
launch_counts = dict.fromkeys(KERNELS, 0)


def first_order_only(backward):
    """Raises when `backward` runs inside a create_graph=True backward (grad
    mode is on there), i.e. when a caller differentiates through it twice."""
    @functools.wraps(backward)
    def run(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the flash attention kernels are first-order only: a "
                "create_graph=True backward (a Hessian-vector product) needs "
                "the plain attention route, attn_impl='xla'")
        return backward(ctx, *grads)
    return run


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def split_heads(qkv: torch.Tensor, heads: int):
    B, N, A3 = qkv.shape
    A = A3 // 3
    hd = A // heads
    q, k, v = (
        qkv[..., i * A:(i + 1) * A].reshape(B, N, heads, hd).transpose(1, 2)
        for i in range(3)
    )
    return q, k, v  # (B, H, N, D) views


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def head_dim_width(D: int) -> int:
    """The head dim the kernels run a head dim D at: the smallest of
    HEAD_DIMS >= D up to 256, D rounded up to a multiple of SPLIT_BOX above
    (D itself when a kernel takes it as it is). Raises for D < 1 only."""
    if D < 1:
        raise ValueError(f"head dim {D} unsupported: a head has at least "
                         "one column")
    if D <= HEAD_DIMS[-1]:
        return next(w for w in HEAD_DIMS if w >= D)
    return -(-D // SPLIT_BOX) * SPLIT_BOX


def kernel_width(x: torch.Tensor, D: int) -> int:
    """The head dim at which x's heads of D columns are computed: D on the
    CPU (the plain versions take any D), head_dim_width(D) on the card."""
    return D if x.device.type == "cpu" else head_dim_width(D)


def pad_head_dim(x: torch.Tensor, heads: int, D: int,
                 width: int) -> torch.Tensor:
    """x (..., heads * D) with each head's D columns followed by width - D
    zeros: (..., heads * width); x itself when width == D. Plain torch ops,
    differentiable (the backward slices the gradient back)."""
    if width == D:
        return x
    lead = x.shape[:-1]
    return torch.nn.functional.pad(x.reshape(*lead, heads, D),
                                   (0, width - D)).reshape(*lead,
                                                           heads * width)


def unpad_head_dim(x: torch.Tensor, heads: int, width: int,
                   D: int) -> torch.Tensor:
    """pad_head_dim's inverse: each head's first D of its width columns,
    (..., heads * D); x itself when width == D. Differentiable (the backward
    pads the gradient with zeros)."""
    if width == D:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, heads, width)[..., :D].reshape(*lead, heads * D)


def fwd_at_width(fwd, xs, groups, heads: int, *args):
    """A kernel family's forward launcher run at the head dim its inputs'
    D runs at: the one place where the entry points, and the checks that
    hold the kernels against their plain versions, pad.

    xs: the forward's tensors, each row groups[i] * heads heads of D
    columns (groups[i] = 0: a tensor without a head dim, K3's kv bias). At
    a D no kernel is built for (kernel_width) each is zero-padded to the
    next built width W (pad_head_dim); a built D, and any D on the CPU,
    takes no copy. fwd(*xs, *args) -> (out, lse). Returns (xs at W, out at
    W, lse, out sliced back to D); bwd_at_width takes the first three."""
    D = xs[0].shape[-1] // (groups[0] * heads)
    W = kernel_width(xs[0], D)
    xs = tuple(pad_head_dim(x, g * heads, D, W) if g else x
               for x, g in zip(xs, groups))
    out, lse = fwd(*xs, *args)
    return xs, out, lse, unpad_head_dim(out, heads, W, D)


# fwd_at_width's groups: K1/K2's qkv holds 3 heads' columns a head, K3's q,
# k and v one each (its kv bias none), K4's (B*H, N, D) views one
QKV_GROUPS, MH_GROUPS, HM_GROUPS = (3,), (1, 1, 1, 0), (1, 1, 1)


def bwd_at_width(bwd, xs, out, lse, dout, groups, heads: int, *args):
    """The backward launcher on fwd_at_width's xs, out and lse at W: dout
    (head dim D) zero-padded as out was, bwd(*xs, out, lse, dout, *args)
    -> the gradients of xs's head tensors at W (one tensor or a tuple),
    each sliced back to D."""
    D, W = dout.shape[-1] // heads, out.shape[-1] // heads
    grads = bwd(*xs, out, lse, pad_head_dim(dout, heads, D, W), *args)
    one = isinstance(grads, torch.Tensor)
    sliced = tuple(unpad_head_dim(g, n * heads, W, D) for g, n in zip(
        (grads,) if one else grads, (n for n in groups if n)))
    return sliced[0] if one else sliced


def _built(D: int) -> int:
    """D, after the gate (head_dim_width) and a check that a kernel takes
    it as it is: the launchers take padded tensors only."""
    if head_dim_width(D) != D:
        raise ValueError(
            f"head dim {D} has no kernel of its own: the public entry points "
            f"pad it to {head_dim_width(D)} (pad_head_dim) first")
    return D


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a kernel receives a folded scale."""
    return torch.tensor(x, dtype=dtype).item()


def _scales(scale: float, dtype: torch.dtype):
    """(q_scale, k_scale, base2): the scale factors rounded to the input
    dtype, as the kernels fold them (q carries log2 e in bf16)."""
    base2 = dtype == torch.bfloat16
    q_scale = scale * LOG2E if base2 else scale
    return _rounded(q_scale, dtype), _rounded(scale, dtype), base2


def attention_qkv_fwd_plain(qkv: torch.Tensor, scale: float, heads: int):
    """Plain PyTorch version of the forward kernel: (out, lse)."""
    dt = qkv.dtype
    q_scale, _, base2 = _scales(scale, dt)
    q, k, v = split_heads(qkv, heads)
    qs = q * torch.tensor(q_scale, dtype=dt, device=qkv.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) if base2 else torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float()) / l
    lse = (m + (torch.log2(l) if base2 else torch.log(l)))[..., 0]
    return merge_heads(o.to(dt)), lse


def attention_qkv_bwd_plain(qkv, out, lse, dout, scale: float, heads: int):
    """Plain PyTorch version of the two backward kernels: dqkv."""
    dt = qkv.dtype
    q_scale, k_scale, base2 = _scales(scale, dt)
    q, k, v = split_heads(qkv, heads)
    B, N, A = out.shape
    hd = A // heads
    o = out.reshape(B, N, heads, hd).transpose(1, 2).float()
    do = dout.reshape(B, N, heads, hd).transpose(1, 2).float()
    qs = q * torch.tensor(q_scale, dtype=dt, device=qkv.device)
    ks = k * torch.tensor(k_scale, dtype=dt, device=qkv.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - lse[..., None]) if base2 else torch.exp(
        s - lse[..., None]
    )
    p16 = p.to(dt)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    ds = (p16 * (dp - delta).to(dt)).float()  # in f32 this is p*(dp-delta)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    if base2:
        dk = dk * torch.tensor(1.0 / LOG2E, dtype=torch.float32)
    dq = torch.matmul(ds, ks.float())
    return torch.cat(
        [merge_heads(g.to(dt)) for g in (dq, dk, dv)], dim=-1
    )


def _power_of_two(x: float) -> bool:
    return x > 0 and math.frexp(x)[0] == 0.5


def _scaled_k_copy(k_scale: float, D: int) -> bool:
    """Whether a prep pass writes k * k_scale for dQ: up to head dim 128 (the
    backwards of csrc/wgmma_attn_bwd.cuh) and above 256 (the column-split
    kernels, whose dQ streams K's group columns in boxes of their own) at a
    scale that is not a power of two. A power of two scales dQ's f32
    accumulator instead, and the strip kernels at 192 and 256 have no
    shared memory for a third strip and fold the scale into their K
    strip."""
    return (D <= 128 or D > HEAD_DIMS[-1]) and not _power_of_two(k_scale)


def _dq_plain(ds, k, ks, k_scale: float, dt):
    """dQ = dS (K * k_scale) as the dQ kernels form it, on (..., N, D) heads:
    from the prep pass's copy ks; else from k, with a power-of-two scale on
    the f32 sum, or with k * k_scale rounded to dt (the strip kernels' K
    strip)."""
    if ks is not None:
        return torch.matmul(ds, ks.float())
    if _power_of_two(k_scale):
        return torch.matmul(ds, k.float()) * k_scale
    return torch.matmul(ds, (k * torch.tensor(
        k_scale, dtype=dt, device=k.device)).float())


def attention_qkv_bwd_prep_plain(qkv, out, dout, scale: float, heads: int):
    """Plain PyTorch version of qkv_attn_bwd_prep: (delta (B, H, N) f32,
    q * q_scale (B, N, A) in the input dtype, and k * k_scale the same way
    or None, see _scaled_k_copy)."""
    dt = qkv.dtype
    q_scale, k_scale, _ = _scales(scale, dt)
    B, N, A = out.shape
    hd = A // heads
    o = out.reshape(B, N, heads, hd).transpose(1, 2).float()
    do = dout.reshape(B, N, heads, hd).transpose(1, 2).float()
    delta = (do * o).sum(dim=-1)
    qs = qkv[..., :A] * torch.tensor(q_scale, dtype=dt, device=qkv.device)
    ks = (qkv[..., A:2 * A] * torch.tensor(k_scale, dtype=dt,
                                           device=qkv.device)
          if _scaled_k_copy(k_scale, hd) else None)
    return delta, qs, ks


def attention_qkv_bwd_from_prep_plain(qkv, lse, dout, delta, qs, ks,
                                      scale: float, heads: int):
    """Plain PyTorch version of qkv_attn_bwd_dkv and qkv_attn_bwd_dq after
    the prep pass: dqkv from its delta, q * q_scale and k * k_scale (None:
    dQ's product takes k, see _dq_plain)."""
    dt = qkv.dtype
    _, k_scale, base2 = _scales(scale, dt)
    _, k, v = split_heads(qkv, heads)
    B, N, A = qs.shape
    hd = A // heads
    to_heads = lambda t: t.reshape(B, N, heads, hd).transpose(1, 2)  # noqa
    qh = to_heads(qs).float()
    do = to_heads(dout).float()
    s = torch.matmul(qh, k.float().transpose(-1, -2))
    p = torch.exp2(s - lse[..., None]) if base2 else torch.exp(
        s - lse[..., None]
    )
    p16 = p.to(dt)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    ds = (p16 * (dp - delta[..., None]).to(dt)).float()
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    if base2:
        dk = dk * torch.tensor(1.0 / LOG2E, dtype=torch.float32)
    dq = _dq_plain(ds, k, None if ks is None else to_heads(ks), k_scale, dt)
    return torch.cat(
        [merge_heads(g.to(dt)) for g in (dq, dk, dv)], dim=-1
    )


def qkv_head_dim(qkv: torch.Tensor, heads: int) -> int:
    """D of a fused (B, N, 3*H*D) qkv, after the gate (head_dim_width,
    which takes any D >= 1); nothing falls back to the plain version on the
    card."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, N, 3*H*D), got {tuple(qkv.shape)}")
    hd = qkv.shape[-1] // (3 * heads)
    head_dim_width(hd)
    return hd


def _check_cuda(qkv: torch.Tensor, heads: int, *others: torch.Tensor):
    _built(qkv_head_dim(qkv, heads))
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {qkv.dtype} (float32, bfloat16)")
    if qkv.shape[0] * heads > 65535:
        raise ValueError("B * H exceeds the kernels' grid limit of 65535")
    for t in (qkv, *others):
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors")
        if t.device != qkv.device:
            raise ValueError("all tensors must be on one device")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels need 16-byte aligned tensors")


def _launch(name: str, t: torch.Tensor, *args):
    """Calls entry point `name` with `args` and the current stream of t's
    device (every entry point's last argument), on that device; raises if
    the kernel does not launch. The raw stream handle and the guard only
    when t is not on the current device keep the host's cost per launch
    low, which is most of a launch's time at N = 160."""
    from mofo_tpu_torch.ops import _build

    fn = getattr(_build.load(), name)
    device = t.device.index
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: error {rc}")
    launch_counts[name] += 1


def qkv_attn_fwd(qkv: torch.Tensor, scale: float, heads: int):
    """Forward: (out (B, N, A), lse (B, H, N) f32). Kernel on CUDA, plain
    version on the CPU."""
    if qkv.device.type == "cpu":
        return attention_qkv_fwd_plain(qkv, scale, heads)
    _check_cuda(qkv, heads)
    B, N, A3 = qkv.shape
    q_scale, _, base2 = _scales(scale, qkv.dtype)
    out = torch.empty((B, N, A3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    _launch("qkv_attn_fwd", qkv, qkv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, N, heads, qkv_head_dim(qkv, heads), q_scale,
            int(base2))
    return out, lse


def _check_bwd(qkv, out, lse, dout, dqkv, heads: int):
    _check_cuda(qkv, heads, out, lse, dout, dqkv)
    B, N, A3 = qkv.shape
    if out.shape != (B, N, A3 // 3) or dout.shape != out.shape:
        raise ValueError("out and dout must be (B, N, A)")
    if dqkv.shape != qkv.shape:
        raise ValueError("dqkv must be shaped like qkv")
    if any(t.dtype != qkv.dtype for t in (out, dout, dqkv)):
        raise ValueError("qkv, out, dout and dqkv must share one dtype")
    if lse.shape != (B, heads, N) or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, H, N) float32")


def qkv_attn_bwd_prep(qkv, out, dout, scale: float, heads: int):
    """The bf16 backward's prep pass: (delta (B, H, N) f32, q * q_scale
    (B, N, A), k * k_scale or None), read from q, O and dO once. Kernel on
    CUDA (bf16 only), plain version on the CPU."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_prep_plain(qkv, out, dout, scale, heads)
    _check_cuda(qkv, heads, out, dout)
    B, N, A3 = qkv.shape
    if out.shape != (B, N, A3 // 3) or dout.shape != out.shape or \
            out.dtype != qkv.dtype or dout.dtype != qkv.dtype:
        raise ValueError("out and dout must be (B, N, A), qkv's dtype")
    if qkv.dtype != torch.bfloat16:
        raise ValueError("qkv_attn_bwd_prep is the bf16 backward's: the f32 "
                         "backward takes mh_delta")
    A = A3 // 3
    q_scale, k_scale, _ = _scales(scale, qkv.dtype)
    delta = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    qs = torch.empty((B, N, A), dtype=qkv.dtype, device=qkv.device)
    ks = (torch.empty_like(qs)
          if _scaled_k_copy(k_scale, qkv_head_dim(qkv, heads)) else None)
    _launch("qkv_attn_bwd_prep", qkv, qkv.data_ptr(), out.data_ptr(),
            dout.data_ptr(), delta.data_ptr(), qs.data_ptr(), _ptr(ks), B, N,
            heads, qkv_head_dim(qkv, heads), q_scale, k_scale)
    return delta, qs, ks


def _qkv_prep(qkv, out, dout, scale, heads):
    """(delta, qs, ks) of the backward kernels: the prep pass in bf16; in
    f32 (delta, None, None), delta from mh_delta's reduction, which the
    dK/dV and dQ kernels read (out is not read by either)."""
    if qkv.dtype == torch.bfloat16:
        return qkv_attn_bwd_prep(qkv, out, dout, scale, heads)
    return mh_delta(out, dout, heads), None, None


def _prep_ptrs(qkv, out, dout, scale, heads, prep):
    """(delta, qs, ks) pointers of the kernels (_qkv_prep run here unless
    `prep` holds its outputs)."""
    if prep is None:
        prep = _qkv_prep(qkv, out, dout, scale, heads)
    delta, qs, ks = prep
    B, N, A3 = qkv.shape
    if qkv.dtype == torch.bfloat16 and qs is None:
        raise ValueError("the bf16 kernels need the prep pass's q * q_scale")
    if delta is None:
        raise ValueError("delta comes from the prep pass (bf16) or "
                         "mh_delta (f32)")
    if delta.shape != (B, heads, N) or (
            qs is not None and qs.shape != (B, N, A3 // 3)) or (
            ks is not None and ks.shape != (B, N, A3 // 3)):
        raise ValueError("prep must be (delta (B, H, N), qs (B, N, A), ks)")
    _check_cuda(qkv, heads, *(t for t in prep if t is not None))
    return _ptr(delta), _ptr(qs), _ptr(ks)


def qkv_attn_bwd_dkv(qkv, out, lse, dout, dqkv, scale: float, heads: int,
                     prep=None):
    """Writes dK and dV, columns [A, 3A) of dqkv (CUDA only). `prep`:
    _qkv_prep's outputs (computed here when None)."""
    _check_bwd(qkv, out, lse, dout, dqkv, heads)
    B, N, _ = qkv.shape
    q_scale, _, base2 = _scales(scale, qkv.dtype)
    dk_fix = 1.0 / LOG2E if base2 else 1.0
    delta, qs, _ = _prep_ptrs(qkv, out, dout, scale, heads, prep)
    _launch("qkv_attn_bwd_dkv", qkv, qkv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta, qs, dqkv.data_ptr(), B, N,
            heads, qkv_head_dim(qkv, heads), q_scale, dk_fix, int(base2))


def qkv_attn_bwd_dq(qkv, out, lse, dout, dqkv, scale: float, heads: int,
                    prep=None):
    """Writes dQ, columns [0, A) of dqkv (CUDA only). `prep` as for
    qkv_attn_bwd_dkv."""
    _check_bwd(qkv, out, lse, dout, dqkv, heads)
    B, N, _ = qkv.shape
    q_scale, k_scale, base2 = _scales(scale, qkv.dtype)
    delta, qs, ks = _prep_ptrs(qkv, out, dout, scale, heads, prep)
    _launch("qkv_attn_bwd_dq", qkv, qkv.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta, qs, ks, dqkv.data_ptr(),
            B, N, heads, qkv_head_dim(qkv, heads), q_scale, k_scale,
            int(base2))


def qkv_attn_bwd(qkv, out, lse, dout, scale: float, heads: int):
    """Backward: dqkv (B, N, 3A). On CUDA two kernels fill it, dK/dV
    (qkv_attn_bwd_dkv) and dQ (qkv_attn_bwd_dq), in bf16 after one prep pass
    (qkv_attn_bwd_prep), in f32 after mh_delta; plain version on the
    CPU."""
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, out, lse, dout, scale, heads)
    dqkv = torch.empty_like(qkv)
    prep = _qkv_prep(qkv, out, dout, scale, heads)
    qkv_attn_bwd_dkv(qkv, out, lse, dout, dqkv, scale, heads, prep)
    qkv_attn_bwd_dq(qkv, out, lse, dout, dqkv, scale, heads, prep)
    return dqkv


class _QKVFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale, heads):
        xs, out, lse, sliced = fwd_at_width(
            qkv_attn_fwd, (qkv,), QKV_GROUPS, heads, scale, heads)
        ctx.save_for_backward(*xs, out, lse)
        ctx.scale, ctx.heads = scale, heads
        return sliced

    @staticmethod
    @first_order_only
    @once_differentiable
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = bwd_at_width(qkv_attn_bwd, (qkv,), out, lse, dout.contiguous(),
                            QKV_GROUPS, ctx.heads, ctx.scale, ctx.heads)
        return dqkv, None, None


def flash_attention_qkv(
    qkv: torch.Tensor, *, scale: float, num_heads: int
) -> torch.Tensor:
    """Fused multihead attention straight from the fused qkv projection.

    qkv: (B, N, 3*H*Dh). Returns (B, N, H*Dh), projection-ready. Runs the
    CUDA kernels on a CUDA tensor (at a head dim that is not built, on qkv
    zero-padded to head_dim_width(Dh), the output sliced back: fwd_at_width)
    and their plain versions on a CPU one; differentiable through both.
    """
    if qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv width {qkv.shape[-1]} vs {num_heads} heads")
    if qkv.dtype == torch.float16:  # see the module docstring
        return flash_attention_qkv(qkv.to(torch.bfloat16), scale=scale,
                                   num_heads=num_heads).to(torch.float16)
    return _QKVFlash.apply(qkv.contiguous(), float(scale), int(num_heads))


# ---------------------------------------------------------------------------
# K3: separate q, k, v with an optional kv bias row
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, N, A = x.shape
    return x.reshape(B, N, heads, A // heads).transpose(1, 2)


def _bias4(kv_bias):
    return 0.0 if kv_bias is None else kv_bias.float()[:, None, None, :]


def attention_mh_fwd_plain(q, k, v, kv_bias, scale: float, heads: int):
    """Plain PyTorch version of mh_attn_fwd: (out (B, N, A), lse (B, H, N)
    f32). The bias is added after the scale fold."""
    dt = q.dtype
    q_scale, _, base2 = _scales(scale, dt)
    qs = _heads(q, heads) * torch.tensor(q_scale, dtype=dt, device=q.device)
    s = torch.matmul(qs.float(), _heads(k, heads).float().transpose(-1, -2))
    s = s + _bias4(kv_bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) if base2 else torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), _heads(v, heads).float()) / l
    lse = (m + (torch.log2(l) if base2 else torch.log(l)))[..., 0]
    return merge_heads(o.to(dt)), lse


def attention_mh_bwd_plain(q, k, v, kv_bias, out, lse, dout, scale: float,
                           heads: int):
    """Plain PyTorch version of mh_attn_bwd_dkv and mh_attn_bwd_dq:
    (dq, dk, dv), each (B, N, A)."""
    dt = q.dtype
    q_scale, k_scale, base2 = _scales(scale, dt)
    kh, vh = _heads(k, heads), _heads(v, heads)
    qs = _heads(q, heads) * torch.tensor(q_scale, dtype=dt, device=q.device)
    ks = kh * torch.tensor(k_scale, dtype=dt, device=q.device)
    o, do = _heads(out, heads).float(), _heads(dout, heads).float()
    s = torch.matmul(qs.float(), kh.float().transpose(-1, -2))
    s = s + _bias4(kv_bias)
    p = torch.exp2(s - lse[..., None]) if base2 else torch.exp(
        s - lse[..., None]
    )
    p16 = p.to(dt)
    dp = torch.matmul(do, vh.float().transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    ds = (p16 * (dp - delta).to(dt)).float()  # in f32 this is p*(dp-delta)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    if base2:
        dk = dk * torch.tensor(1.0 / LOG2E, dtype=torch.float32)
    dq = torch.matmul(ds, ks.float())
    return tuple(merge_heads(g.to(dt)) for g in (dq, dk, dv))


def _check_mh(q, k, v, kv_bias, heads: int):
    """Raises on inputs the K3 kernels do not take. Returns D."""
    if q.ndim != 3 or q.shape[-1] % heads:
        raise ValueError(f"q must be (B, N, H*D), got {tuple(q.shape)}")
    B, N, A = q.shape
    D = _built(A // heads)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    if B * heads > 65535:
        raise ValueError("B * H exceeds the kernels' grid limit of 65535")
    align = 16 // q.element_size()  # 16-byte rows: TMA reads them
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, like q")
        if t.stride(2) != 1 or t.stride(0) != N * t.stride(1):
            raise ValueError(f"{name} needs unit column stride and rows "
                             "packed by batch")
        if t.stride(1) % align or t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernels need 16-byte "
                             "aligned rows")
    if kv_bias is not None and (
        kv_bias.shape != (B, N) or kv_bias.dtype != torch.float32
        or not kv_bias.is_contiguous() or kv_bias.device != q.device
    ):
        raise ValueError("kv_bias must be a contiguous (B, N) float32 "
                         "tensor on q's device")
    return D


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def mh_attn_fwd(q, k, v, kv_bias, scale: float, heads: int):
    """Forward: (out (B, N, A), lse (B, H, N) f32). Kernel on CUDA, plain
    version on the CPU."""
    if q.device.type == "cpu":
        return attention_mh_fwd_plain(q, k, v, kv_bias, scale, heads)
    D = _check_mh(q, k, v, kv_bias, heads)
    B, N, A = q.shape
    q_scale, _, base2 = _scales(scale, q.dtype)
    out = torch.empty((B, N, A), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=q.device)
    _launch("mh_attn_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_bias), out.data_ptr(), lse.data_ptr(), B, N, heads, D,
            q.stride(1), k.stride(1), v.stride(1), q_scale, int(base2))
    return out, lse


def mh_delta(out, dout, heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, (B, H, N) f32, as the TPU computes
    it in XLA (mofo_tpu/ops/flash_attention.py:751-758): the plain version
    of the prep pass's delta, and the f32 backward's one reduction."""
    return (_heads(dout, heads).float() * _heads(out, heads).float()).sum(
        dim=-1).contiguous()


def attention_mh_bwd_prep_plain(q, k, out, dout, scale: float, heads: int):
    """Plain PyTorch version of mh_attn_bwd_prep: (delta (B, H, N) f32,
    q * q_scale (B, N, A) in the input dtype, and k * k_scale the same way
    or None, see _scaled_k_copy)."""
    dt = q.dtype
    q_scale, k_scale, _ = _scales(scale, dt)
    qs = q * torch.tensor(q_scale, dtype=dt, device=q.device)
    ks = None
    if _scaled_k_copy(k_scale, q.shape[-1] // heads):
        ks = k * torch.tensor(k_scale, dtype=dt, device=q.device)
    return mh_delta(out, dout, heads), qs, ks


def attention_mh_bwd_from_prep_plain(k, v, kv_bias, lse, dout, delta, qs, ks,
                                     scale: float, heads: int):
    """Plain PyTorch version of mh_attn_bwd_dkv and mh_attn_bwd_dq after the
    prep pass: (dq, dk, dv) from its delta, q * q_scale and k * k_scale
    (None: dQ's product takes k, see _dq_plain)."""
    dt = k.dtype
    _, k_scale, base2 = _scales(scale, dt)
    kh, vh = _heads(k, heads), _heads(v, heads)
    qh, do = _heads(qs, heads).float(), _heads(dout, heads).float()
    s = torch.matmul(qh, kh.float().transpose(-1, -2)) + _bias4(kv_bias)
    p = torch.exp2(s - lse[..., None]) if base2 else torch.exp(
        s - lse[..., None]
    )
    p16 = p.to(dt)
    dp = torch.matmul(do, vh.float().transpose(-1, -2))
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    ds = (p16 * (dp - delta[..., None]).to(dt)).float()
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    if base2:
        dk = dk * torch.tensor(1.0 / LOG2E, dtype=torch.float32)
    dq = _dq_plain(ds, kh, None if ks is None else _heads(ks, heads),
                   k_scale, dt)
    return tuple(merge_heads(g.to(dt)) for g in (dq, dk, dv))


def _check_like_q(q, **tensors):
    """Raises unless each tensor is contiguous, 16-byte aligned and like q."""
    for name, t in tensors.items():
        if t.shape != q.shape or t.dtype != q.dtype or \
                not t.is_contiguous() or t.device != q.device or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             "and like q")


def _check_mh_stat(q, heads: int, **stats):
    B, N, _ = q.shape
    for name, t in stats.items():
        if t.shape != (B, heads, N) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous (B, H, N) "
                             "float32 on q's device")


def _check_mh_bwd(q, out, lse, dout, heads: int):
    _check_like_q(q, out=out, dout=dout)
    _check_mh_stat(q, heads, lse=lse)


def mh_attn_bwd_prep(q, k, out, dout, scale: float, heads: int):
    """The bf16 backward's prep pass: (delta (B, H, N) f32, q * q_scale
    (B, N, A), k * k_scale or None), read from q, O and dO once. q and k
    keep their row strides. Kernel on CUDA (bf16 only), plain version on
    the CPU."""
    if q.device.type == "cpu":
        return attention_mh_bwd_prep_plain(q, k, out, dout, scale, heads)
    D = _check_mh(q, k, k, None, heads)
    if q.dtype != torch.bfloat16:
        raise ValueError("mh_attn_bwd_prep is the bf16 backward's: the f32 "
                         "kernels scale q themselves and take mh_delta")
    _check_like_q(q, out=out, dout=dout)
    B, N, A = q.shape
    q_scale, k_scale, _ = _scales(scale, q.dtype)
    delta = torch.empty((B, heads, N), dtype=torch.float32, device=q.device)
    qs = torch.empty((B, N, A), dtype=q.dtype, device=q.device)
    ks = torch.empty_like(qs) if _scaled_k_copy(k_scale, D) else None
    _launch("mh_attn_bwd_prep", q, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), qs.data_ptr(),
            _ptr(ks), B, N, heads, D, q.stride(1), k.stride(1), q_scale,
            k_scale)
    return delta, qs, ks


def _mh_prep(q, k, out, dout, scale, heads, prep):
    """(delta, qs, ks) of the backward kernels: `prep` if given, else the
    prep pass in bf16 and (mh_delta, None, None) in f32, whose kernels
    scale q and k themselves."""
    if prep is None:
        prep = (mh_attn_bwd_prep(q, k, out, dout, scale, heads)
                if q.dtype == torch.bfloat16
                else (mh_delta(out, dout, heads), None, None))
    delta, qs, ks = prep
    _check_mh_stat(q, heads, delta=delta)
    if q.dtype == torch.bfloat16:
        if qs is None:
            raise ValueError("the bf16 kernels need the prep pass's "
                             "q * q_scale")
        _check_like_q(q, qs=qs, **({} if ks is None else {"ks": ks}))
    return delta, qs, ks


def mh_attn_bwd_dkv(q, k, v, kv_bias, out, lse, dout, dk, dv, scale: float,
                    heads: int, prep=None):
    """Writes dK and dV (CUDA only): dk and dv share one row stride, as the
    two halves of a (B, N, 2A) dkv do. `prep`: mh_attn_bwd_prep's outputs in
    bf16, (delta, None, None) in f32; computed here when None."""
    D = _check_mh(q, k, v, kv_bias, heads)
    _check_mh_bwd(q, out, lse, dout, heads)
    B, N, _ = q.shape
    if dk.stride() != dv.stride() or dk.stride(2) != 1 or \
            dk.shape != q.shape or dk.dtype != q.dtype:
        raise ValueError("dk and dv must be shaped like q, with one stride")
    delta, qs, _ = _mh_prep(q, k, out, dout, scale, heads, prep)
    q_scale, _, base2 = _scales(scale, q.dtype)
    dk_fix = 1.0 / LOG2E if base2 else 1.0
    _launch("mh_attn_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_bias), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(qs), dk.data_ptr(), dv.data_ptr(), B, N, heads, D,
            q.stride(1), k.stride(1), v.stride(1), dk.stride(1), q_scale,
            dk_fix, int(base2))


def mh_attn_bwd_dq(q, k, v, kv_bias, out, lse, dout, dq, scale: float,
                   heads: int, prep=None):
    """Writes dQ (B, N, A) contiguous (CUDA only; the C entry point takes
    dq's row stride, which K2 sets above head dim 128). `prep` as for
    mh_attn_bwd_dkv."""
    D = _check_mh(q, k, v, kv_bias, heads)
    _check_mh_bwd(q, out, lse, dout, heads)
    B, N, _ = q.shape
    if dq.shape != q.shape or dq.dtype != q.dtype or not dq.is_contiguous():
        raise ValueError("dq must be contiguous and shaped like q")
    delta, qs, ks = _mh_prep(q, k, out, dout, scale, heads, prep)
    q_scale, k_scale, base2 = _scales(scale, q.dtype)
    _launch("mh_attn_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_bias), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(qs), _ptr(ks), dq.data_ptr(), B, N, heads, D, q.stride(1),
            k.stride(1), v.stride(1), dq.stride(1), q_scale, k_scale,
            int(base2))


def mh_attn_bwd(q, k, v, kv_bias, out, lse, dout, scale: float, heads: int):
    """Backward: (dq, dk, dv). On CUDA, two kernels: dK/dV into one
    (B, N, 2A) buffer (mh_attn_bwd_dkv; dk and dv are its halves) and dQ
    (mh_attn_bwd_dq), in bf16 after one prep pass (mh_attn_bwd_prep), in f32
    after mh_delta's reduction; plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_mh_bwd_plain(q, k, v, kv_bias, out, lse, dout,
                                      scale, heads)
    prep = _mh_prep(q, k, out, dout, scale, heads, None)
    A = q.shape[-1]
    dkv = torch.empty(q.shape[:2] + (2 * A,), dtype=q.dtype, device=q.device)
    dk, dv = dkv[..., :A], dkv[..., A:]
    dq = torch.empty_like(q)
    mh_attn_bwd_dkv(q, k, v, kv_bias, out, lse, dout, dk, dv, scale, heads,
                    prep)
    mh_attn_bwd_dq(q, k, v, kv_bias, out, lse, dout, dq, scale, heads, prep)
    return dq, dk, dv


class _MHFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, scale, heads):
        xs, out, lse, sliced = fwd_at_width(
            mh_attn_fwd, (q, k, v, kv_bias), MH_GROUPS, heads, scale, heads)
        ctx.save_for_backward(*xs, out, lse)
        ctx.scale, ctx.heads = scale, heads
        return sliced

    @staticmethod
    @first_order_only
    @once_differentiable
    def backward(ctx, dout):
        *xs, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd_at_width(mh_attn_bwd, xs, out, lse,
                                  dout.contiguous(), MH_GROUPS, ctx.heads,
                                  ctx.scale, ctx.heads)
        # the bias is a 0 / -1e30 mask encoding: no gradient
        return dq, dk, dv, None, None, None


def flash_attention_mh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, scale: float, num_heads: int,
                       kv_bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Multihead attention in token-major flat layout.

    q, k, v: (B, N, H*Dh); k and v may be column views of one (B, N, 2A)
    kv projection. kv_bias: optional (B, N) additive bias per kv position,
    shared across heads and queries (0 / -1e30 masks kv columns exactly:
    their weight underflows to 0 in forward and backward); every row must
    keep one unmasked column. Returns (B, N, H*Dh). Runs the CUDA kernels on
    CUDA tensors (at a head dim that is not built, on q, k and v
    zero-padded to head_dim_width(Dh), the output sliced back: fwd_at_width)
    and their plain versions on CPU ones; differentiable in q, k and v
    through both.
    """
    if q.shape[-1] % num_heads:
        raise ValueError(f"width {q.shape[-1]} vs {num_heads} heads")
    if q.dtype == torch.float16:  # see the module docstring
        return flash_attention_mh(
            *(t.to(torch.bfloat16) for t in (q, k, v)), scale=scale,
            num_heads=num_heads, kv_bias=kv_bias).to(torch.float16)
    if kv_bias is not None:
        if kv_bias.shape != (q.shape[0], k.shape[1]):
            raise ValueError(f"kv_bias {tuple(kv_bias.shape)} must be (B, N)")
        kv_bias = kv_bias.detach().float().contiguous()
    return _MHFlash.apply(q, k, v, kv_bias, float(scale), int(num_heads))


# ---------------------------------------------------------------------------
# K4: head-major single-head attention on (B*H, N, D)
# ---------------------------------------------------------------------------


def attention_hm_fwd_plain(q, k, v, scale: float):
    """Plain PyTorch version of hm_attn_fwd on (..., N, D): (out, lse f32).
    Base e in every dtype; the normalized p / l is rounded to the input
    dtype before P.V (mofo_tpu/ops/flash_attention.py:138-157)."""
    dt = q.dtype
    qs = q * torch.tensor(_rounded(scale, dt), dtype=dt, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul((p / l).to(dt).float(), v.float())
    return o.to(dt), (m + torch.log(l))[..., 0]


def hm_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dO * O), (..., N) f32, as the TPU computes it in XLA
    (mofo_tpu/ops/flash_attention.py:313-315): the plain version of the
    prep pass's delta, and the f32 backward's one reduction."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def attention_hm_bwd_plain(q, k, v, out, lse, dout, scale: float):
    """Plain PyTorch version of hm_attn_bwd_dkv and hm_attn_bwd_dq:
    (dq, dk, dv) (mofo_tpu/ops/flash_attention.py:160-250)."""
    dt = q.dtype
    sc = torch.tensor(_rounded(scale, dt), dtype=dt, device=q.device)
    qs, ks = q * sc, k * sc
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p16 = torch.exp(s - lse[..., None]).to(dt)
    do = dout.float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    delta = hm_delta(out, dout)[..., None]
    ds = (p16 * (dp - delta).to(dt)).float()  # in f32 this is p*(dp-delta)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    dq = torch.matmul(ds, ks.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_hm_bwd_prep_plain(q, k, out, dout, scale: float):
    """Plain PyTorch version of hm_attn_bwd_prep on (..., N, D): (delta
    (..., N) f32, q * scale in the input dtype, and k * scale the same way
    or None, see _scaled_k_copy)."""
    dt = q.dtype
    sc = _rounded(scale, dt)
    mul = torch.tensor(sc, dtype=dt, device=q.device)
    return (hm_delta(out, dout), q * mul,
            k * mul if _scaled_k_copy(sc, q.shape[-1]) else None)


def attention_hm_bwd_from_prep_plain(k, v, lse, dout, delta, qs, ks,
                                     scale: float):
    """Plain PyTorch version of hm_attn_bwd_dkv and hm_attn_bwd_dq after
    the prep pass: (dq, dk, dv) from its delta, q * scale and k * scale
    (None: dQ's product takes k, see _dq_plain)."""
    dt = k.dtype
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p16 = torch.exp(s - lse[..., None]).to(dt)
    do = dout.float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    dv = torch.matmul(p16.float().transpose(-1, -2), do)
    ds = (p16 * (dp - delta[..., None]).to(dt)).float()
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    dq = _dq_plain(ds, k, ks, _rounded(scale, dt), dt)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_hm(q, *others):
    """Raises on (B*H, N, D) tensors the K4 kernels do not take."""
    if q.ndim != 3:
        raise ValueError(f"q must be (B*H, N, D), got {tuple(q.shape)}")
    _built(q.shape[-1])
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    if q.shape[0] > 65535:
        raise ValueError("B * H exceeds the kernels' grid limit of 65535")
    for t in (q, *others):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"every tensor must be {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, like q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernels need contiguous, 16-byte "
                             "aligned tensors")


def _check_hm_stats(q, *stats):
    for t in stats:
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError("lse and delta must be contiguous (B*H, N) "
                             "float32 on q's device")


def hm_attn_fwd(q, k, v, scale: float):
    """Forward on (B*H, N, D): (out, lse (B*H, N) f32, natural log).
    Kernel on CUDA, plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_hm_fwd_plain(q, k, v, scale)
    _check_hm(q, k, v)
    BH, N, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    _launch("hm_attn_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), BH, N, D,
            _rounded(scale, q.dtype), int(q.dtype == torch.bfloat16))
    return out, lse


def hm_attn_bwd_prep(q, k, out, dout, scale: float):
    """The bf16 backward's prep pass on (B*H, N, D): (delta (B*H, N) f32,
    q * scale, k * scale or None), read from q, O and dO once. Kernel on
    CUDA (bf16 only), plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_hm_bwd_prep_plain(q, k, out, dout, scale)
    _check_hm(q, k, out, dout)
    if q.dtype != torch.bfloat16:
        raise ValueError("hm_attn_bwd_prep is the bf16 backward's: the f32 "
                         "kernels scale q and k themselves")
    BH, N, D = q.shape
    sc = _rounded(scale, q.dtype)
    delta = torch.empty((BH, N), dtype=torch.float32, device=q.device)
    qs = torch.empty_like(q)
    ks = torch.empty_like(q) if _scaled_k_copy(sc, D) else None
    _launch("hm_attn_bwd_prep", q, q.data_ptr(), k.data_ptr(),
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), qs.data_ptr(),
            _ptr(ks), BH, N, D, sc, sc)
    return delta, qs, ks


def _hm_prep(q, k, out, dout, scale, prep):
    """(delta, qs, ks) of the backward kernels: `prep` if given, else the
    prep pass in bf16 and (hm_delta, None, None) in f32, whose kernels
    scale q and k themselves."""
    if prep is None:
        prep = (hm_attn_bwd_prep(q, k, out, dout, scale)
                if q.dtype == torch.bfloat16
                else (hm_delta(out, dout), None, None))
    delta, qs, ks = prep
    _check_hm_stats(q, delta)
    if q.dtype == torch.bfloat16:
        if qs is None:
            raise ValueError("the bf16 kernels need the prep pass's q * scale")
        _check_hm(q, qs, *([] if ks is None else [ks]))
    return delta, qs, ks


def hm_attn_bwd_dkv(q, k, v, out, lse, dout, dk, dv, scale: float,
                    prep=None):
    """Writes dK and dV (CUDA only). `prep`: hm_attn_bwd_prep's outputs in
    bf16, (delta, None, None) in f32; computed here when None."""
    _check_hm(q, k, v, out, dout, dk, dv)
    _check_hm_stats(q, lse)
    delta, qs, _ = _hm_prep(q, k, out, dout, scale, prep)
    BH, N, D = q.shape
    _launch("hm_attn_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(qs),
            dk.data_ptr(), dv.data_ptr(), BH, N, D, _rounded(scale, q.dtype),
            int(q.dtype == torch.bfloat16))


def hm_attn_bwd_dq(q, k, v, out, lse, dout, dq, scale: float, prep=None):
    """Writes dQ (CUDA only). `prep` as for hm_attn_bwd_dkv."""
    _check_hm(q, k, v, out, dout, dq)
    _check_hm_stats(q, lse)
    delta, qs, ks = _hm_prep(q, k, out, dout, scale, prep)
    BH, N, D = q.shape
    sc = _rounded(scale, q.dtype)
    _launch("hm_attn_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(qs),
            _ptr(ks), dq.data_ptr(), BH, N, D, sc, sc,
            int(q.dtype == torch.bfloat16))


def hm_attn_bwd(q, k, v, out, lse, dout, scale: float):
    """Backward on (B*H, N, D): (dq, dk, dv). On CUDA the dK/dV and dQ
    kernels, in bf16 after one prep pass (hm_attn_bwd_prep), in f32 after
    hm_delta's reduction; plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_hm_bwd_plain(q, k, v, out, lse, dout, scale)
    prep = _hm_prep(q, k, out, dout, scale, None)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    hm_attn_bwd_dkv(q, k, v, out, lse, dout, dk, dv, scale, prep)
    hm_attn_bwd_dq(q, k, v, out, lse, dout, dq, scale, prep)
    return dq, dk, dv


class _HMFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        xs, out, lse, sliced = fwd_at_width(
            hm_attn_fwd, (q, k, v), HM_GROUPS, 1, scale)
        ctx.save_for_backward(*xs, out, lse)
        ctx.scale = scale
        return sliced

    @staticmethod
    @first_order_only
    @once_differentiable
    def backward(ctx, dout):
        *xs, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd_at_width(hm_attn_bwd, xs, out, lse,
                                  dout.contiguous(), HM_GROUPS, 1, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Fused self-attention, head-major: q, k, v (B, H, N, Dh) -> the same
    layout. The kernels see the (B*H, N, Dh) view of contiguous copies
    (zero-padded to head_dim_width(Dh) at a head dim that is not built, the
    output sliced back: fwd_at_width). Runs the CUDA kernels on CUDA
    tensors and their plain versions on CPU ones; differentiable in q, k
    and v through both."""
    if k.shape != q.shape or v.shape != q.shape or q.ndim != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype == torch.float16:  # see the module docstring
        return flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)),
                               scale=scale).to(torch.float16)
    B, H, N, D = q.shape
    q, k, v = (t.reshape(B * H, N, D).contiguous() for t in (q, k, v))
    return _HMFlash.apply(q, k, v, float(scale)).reshape(B, H, N, D)
