"""Transformer primitives for the MOFO / VideoMAE model family.

Counterpart of mofo_tpu/models/layers.py (reference modeling_finetune.py):
Mlp, Attention, Block, PatchEmbed and the BB-focused classifier's
CrossAttention, MCABlock and SoftAttention. Dropout and drop path are
active in train mode only (nn.Module.training, the JAX modules'
deterministic=False) and draw their masks from an explicit generator
(ops.attention.keep_mask).
Parameters are float32 and carry the reference's state_dict names; each
matmul casts its operands to the module's compute dtype, as the JAX
modules do (this is not torch.autocast). LayerNorm runs in f32.

Layout: activations are token-major (B, N, D); clips are channel-last
(B, T, H, W, C) and enter as flat patch rows (ops.patchify.patchify_flat).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mofo_tpu_torch.ops import attention
from mofo_tpu_torch.ops.attention import (
    _PALLAS_MIN_SEQ,
    dot_product_attention,
)
from mofo_tpu_torch.ops.flash_attention import (
    flash_attention_mh,
    flash_attention_qkv,
)
from mofo_tpu_torch.ops.patchify import patchify_flat


@functools.lru_cache(maxsize=16)
def _sinusoid_table_np(n_position: int, d_hid: int) -> np.ndarray:
    """Sin/cos positional table built in float64, numerically identical to
    the reference get_sinusoid_encoding_table (modeling_finetune.py:252-262)."""
    position = np.arange(n_position, dtype=np.float64)[:, None]
    hid_j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = position / np.power(10000.0, 2.0 * (np.floor(hid_j / 2.0)) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> torch.Tensor:
    """Frozen (1, n_position, d_hid) f32 sin-cos positional table."""
    return torch.from_numpy(_sinusoid_table_np(n_position, d_hid).copy())[None]


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """x @ W^T + b with both operands cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]):
    """xavier-uniform weight, zero bias (the JAX modules' initializers)."""
    xavier_uniform_(layer.weight, layer.in_features, layer.out_features,
                    generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def trunc_normal_(w: torch.Tensor, generator: Optional[torch.Generator],
                  std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (the JAX package's
    trunc_normal_init, mofo_tpu/models/layers.py:38-44)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def init_trunc_normal(module: nn.Module,
                      generator: Optional[torch.Generator]) -> None:
    """Trunc-normal(.02) weights and zero biases for every nn.Linear (and
    the patch embedding's Conv3d) under `module`: the finetune models'
    init (reference modeling_finetune.py:366-373)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            trunc_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth per sample (reference modeling_finetune.py:20-31).
    The keep mask is drawn from `generator` (on x's device), which the step
    passes down; drawing at rate > 0 without one raises."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"drop path at rate {rate} needs an explicit "
                         "torch.Generator")
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = attention.keep_mask(shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's nn.Dropout: where(keep, x / (1 - rate), 0) with keep ~
    Bernoulli(1 - rate) of x's shape, drawn from `generator` by
    ops.attention.keep_mask. Outside training or at rate 0 it returns x
    and draws nothing."""
    if not training or rate == 0.0:
        return x
    keep = attention.keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, generator)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 -> dropout (reference modeling_finetune.py:34-51;
    one dropout, after fc2, as mofo_tpu/models/layers.py:125-132). In bf16
    the GELU is the tanh form computed in f32; otherwise exact erf, as in
    mofo_tpu/models/layers.py:119-124."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32, generator=None,
                 drop: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop = drop
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = linear(x, self.fc1, self.dtype)
        if self.dtype == torch.bfloat16:
            x = F.gelu(x.float(), approximate="tanh").to(self.dtype)
        else:
            x = F.gelu(x)
        x = linear(x, self.fc2, self.dtype)
        return dropout(x, self.drop, self.training, generator)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection, learned q/v
    biases and the k bias pinned to zero (reference modeling_finetune.py:
    54-98). Attention takes one of two routes, chosen from the shapes and
    the switches alone as mofo_tpu/models/layers.py:186-219 chooses on a
    TPU: the flat route, flash_attention_qkv (K1/K2) on the fused
    (B, N, 3A) projection, when N >= 128, A = H * Dh is a multiple of 128
    and there is no attention bias, no active attention dropout and no
    sowing; otherwise the head-major route, a (3, B, H, N, Dh) copy of the
    projection and dot_product_attention (K4 for N >= 128 without a bias or
    active dropout, the plain math otherwise). attn_impl "pallas" takes the
    kernels at every N (flat where A is aligned; it raises on a bias or
    active dropout), "xla" the plain head-major math.

    attn_head_dim overrides dim // num_heads (A = attn_head_dim * H).
    attn_drop drops attention probabilities and proj_drop the projected
    output, in train mode. With sow_attn every forward keeps the f32
    softmax of (q * scale) k^T as attn_probs, (B, H, N, N): the
    counterpart of sow("intermediates", "attn_probs", ...)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, generator=None,
                 attn_impl: str = "auto", attn_drop: float = 0.0,
                 proj_drop: float = 0.0,
                 attn_head_dim: Optional[int] = None,
                 sow_attn: bool = False):
        super().__init__()
        if attn_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown attn_impl {attn_impl!r} (auto, xla, "
                             "pallas)")
        self.num_heads = num_heads
        head_dim = attn_head_dim or dim // num_heads
        self.all_head_dim = all_head_dim = head_dim * num_heads
        self.scale = qk_scale or head_dim ** -0.5
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.sow_attn = sow_attn
        self.attn_probs = None
        self.qkv = nn.Linear(dim, 3 * all_head_dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(all_head_dim))
            self.v_bias = nn.Parameter(torch.zeros(all_head_dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(all_head_dim, dim)
        init_linear(self.qkv, generator)
        init_linear(self.proj, generator)

    def _drop_active(self) -> bool:
        return self.training and self.attn_drop > 0.0

    def uses_flat(self, n_tokens: int,
                  attn_bias: Optional[torch.Tensor] = None) -> bool:
        """Whether a sequence of n_tokens takes the flat K1/K2 route. The
        "pallas" impl raises on a bias or active attention dropout."""
        aligned = self.all_head_dim % 128 == 0
        if self.attn_impl == "pallas":
            if attn_bias is not None:
                raise ValueError(
                    "attn_impl='pallas' does not support an attention bias")
            if self._drop_active():
                raise ValueError(
                    "attn_impl='pallas' does not support attention dropout")
            return not self.sow_attn and aligned
        fusable = (attn_bias is None and not self._drop_active()
                   and not self.sow_attn)
        return (fusable and self.attn_impl == "auto"
                and n_tokens >= _PALLAS_MIN_SEQ and aligned)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, dim); attn_bias broadcasts to (B, H, N, N) (f32,
        additive); `generator` draws the dropout masks in train mode."""
        B, N, _ = x.shape
        qkv = F.linear(x.to(self.dtype), self.qkv.weight.to(self.dtype))
        if self.q_bias is not None:
            qkv = qkv + torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]
            ).to(self.dtype)
        if self.uses_flat(N, attn_bias):
            out = flash_attention_qkv(
                qkv, scale=self.scale, num_heads=self.num_heads
            )
        else:
            qkv = qkv.reshape(B, N, 3, self.num_heads, -1).permute(
                2, 0, 3, 1, 4).contiguous()  # (3, B, H, N, Dh)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if self.sow_attn:
                logits = torch.matmul((q * self.scale).float(),
                                      k.float().transpose(-1, -2))
                self.attn_probs = torch.softmax(logits, dim=-1)
            # explicit pallas lands here for sowing (the probabilities are
            # materialized: the plain math) or an unaligned flat layout
            # (the head-major kernel)
            impl = self.attn_impl
            if impl == "pallas":
                impl = "xla" if self.sow_attn else "pallas"
            out = dot_product_attention(
                q, k, v, scale=self.scale, bias=attn_bias,
                dropout_rate=self.attn_drop, deterministic=not self.training,
                generator=generator, impl=impl)
            out = out.transpose(1, 2).reshape(B, N, self.all_head_dim)
        out = linear(out, self.proj, self.dtype)
        return dropout(out, self.proj_drop, self.training, generator)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype):
    """LayerNorm computed in f32, output cast to the compute dtype."""
    return norm(x.float()).to(dtype)


class Block(nn.Module):
    """Pre-LN transformer block with optional layerscale (reference
    modeling_finetune.py:194-223)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 attn_impl: str = "auto", drop: float = 0.0,
                 attn_drop: float = 0.0,
                 attn_head_dim: Optional[int] = None,
                 sow_attn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype,
                              generator, attn_impl, attn_drop=attn_drop,
                              proj_drop=drop, attn_head_dim=attn_head_dim,
                              sow_attn=sow_attn)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator, drop)
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the dropout and drop-path masks (needed at a
        rate > 0 in train mode)."""
        in_dtype = x.dtype
        a = self.attn(layer_norm(x, self.norm1, self.dtype),
                      generator=generator)
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(a.dtype)
        x = x + self.drop_path(a, generator)
        m = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(m.dtype)
        x = x + self.drop_path(m, generator)
        return x.to(in_dtype)


class PatchEmbed(nn.Module):
    """Cube (tubelet) embedding as one matmul on flat patch rows.

    Holds the reference Conv3d(in_chans -> D, kernel = stride = (tubelet,
    p, p)) weight, (D, C, p0, p, p), so checkpoints map 1:1; the forward
    reorders it to the rows' (p0, p1, p2, c) channel-fastest order. Input
    is pre-patchified (B, N, p0*p*p*C) rows or a (B, T, H, W, C) clip.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 768,
                 num_frames: int = 16, tubelet_size: int = 2,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.tubelet_size, self.dtype = tubelet_size, dtype
        self.num_patches = (
            (img_size // patch_size) ** 2 * (num_frames // tubelet_size)
        )
        self.proj = nn.Conv3d(
            in_chans, embed_dim, kernel_size=(tubelet_size, patch_size,
                                              patch_size),
            stride=(tubelet_size, patch_size, patch_size),
        )
        patch_dim = tubelet_size * patch_size * patch_size * in_chans
        xavier_uniform_(self.proj.weight, patch_dim, embed_dim, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:
            if x.shape[2] != self.img_size:
                raise ValueError(
                    f"input size {x.shape[2]} != model {self.img_size}"
                )
            x = patchify_flat(x, self.patch_size, self.tubelet_size)
        w = self.proj.weight  # (D, C, p0, p1, p2) -> (D, p0*p1*p2*C)
        w = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)
        if x.shape[-1] != w.shape[1]:
            raise ValueError(f"patch rows {x.shape[-1]} != {w.shape[1]}")
        return F.linear(x.to(self.dtype), w.to(self.dtype),
                        self.proj.bias.to(self.dtype))


class CrossAttention(nn.Module):
    """Cross-attention, queries from x and keys/values from y (reference
    modeling_finetune.py:100-160): a q projection with a learned q bias, a
    fused kv projection whose bias is cat(0, v_bias), then attention routed
    as mofo_tpu/models/layers.py:365-434 routes it: without active
    attention dropout and with as many queries as keys, the masked
    attention of flash_attention_mh (K3) on the flat (B, N, A) layout with
    kv_bias = 0 / -1e30 from kv_mask; otherwise the head-major plain math
    with an additive -inf bias from kv_mask and attention dropout.
    proj_drop drops the projected output in train mode."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 attn_head_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, generator=None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.num_heads = num_heads
        head_dim = attn_head_dim or dim // num_heads
        self.all_head_dim = all_head_dim = head_dim * num_heads
        self.scale = qk_scale or head_dim ** -0.5
        self.dtype = dtype
        self.q = nn.Linear(dim, all_head_dim, bias=False)
        self.kv = nn.Linear(dim, 2 * all_head_dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(all_head_dim))
            self.v_bias = nn.Parameter(torch.zeros(all_head_dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(all_head_dim, dim)
        init_trunc_normal(self, generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the dropout masks in train mode."""
        dt, A, H = self.dtype, self.all_head_dim, self.num_heads
        (B, Nx, _), Ny = x.shape, y.shape[1]
        q = F.linear(x.to(dt), self.q.weight.to(dt))
        kv = F.linear(y.to(dt), self.kv.weight.to(dt))
        if self.q_bias is not None:
            q = q + self.q_bias.to(dt)
            kv = kv + torch.cat(
                [torch.zeros_like(self.v_bias), self.v_bias]).to(dt)
        if not (self.training and self.attn_drop > 0.0) and Nx == Ny:
            kv_bias = None
            if kv_mask is not None:
                # every sample keeps a valid column (the BB fusing falls
                # back to the in-box set when the out-box set is empty)
                kv_bias = torch.where(kv_mask, 0.0, -1e30).to(torch.float32)
            out = flash_attention_mh(q, kv[..., :A], kv[..., A:],
                                     scale=self.scale, num_heads=H,
                                     kv_bias=kv_bias)
        else:
            qh = q.reshape(B, Nx, H, -1).transpose(1, 2)
            kvh = kv.reshape(B, Ny, 2, H, -1)
            k, v = kvh[:, :, 0].transpose(1, 2), kvh[:, :, 1].transpose(1, 2)
            bias = None
            if kv_mask is not None:  # (B, Ny) -> additive (B, 1, 1, Ny)
                bias = torch.where(kv_mask[:, None, None, :], 0.0,
                                   -torch.inf).to(torch.float32)
            out = dot_product_attention(
                qh, k, v, scale=self.scale, bias=bias,
                dropout_rate=self.attn_drop, deterministic=not self.training,
                generator=generator, impl="xla")
            out = out.transpose(1, 2).reshape(B, Nx, A)
        out = linear(out, self.proj, dt)
        return dropout(out, self.proj_drop, self.training, generator)


class MCABlock(nn.Module):
    """The BB-focused classifier's cross-attention block, "MCA" (reference
    modeling_finetune.py:162-191): norm1 on both x and y, cross-attention,
    then an MLP, both residual (no drop path, as in the JAX model). drop is
    the projection's and the MLP's dropout, attn_drop the attention's."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 init_values: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None,
                 drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CrossAttention(dim, num_heads, qkv_bias, qk_scale,
                                   dtype=dtype, generator=generator,
                                   attn_drop=attn_drop, proj_drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator, drop)
        init_trunc_normal(self.mlp, generator)
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.attn(layer_norm(x, self.norm1, self.dtype),
                      layer_norm(y, self.norm1, self.dtype), kv_mask,
                      generator)
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(a.dtype)
        x = x + a
        m = self.mlp(layer_norm(x, self.norm2, self.dtype), generator)
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(m.dtype)
        return x + m


class SoftAttention(nn.Module):
    """Soft attention pooling of the 'soft_attn' fusing mode (reference
    modeling_finetune.py:264-303), in its literal masked form: with
    step_dim = 1 it reduces to mean(a) * sum(x) over the selected tokens
    (mofo_tpu/models/layers.py:687-730)."""

    def __init__(self, feature_dim: int, bias: bool = True,
                 generator=None):
        super().__init__()
        bound = math.sqrt(6.0)  # kaiming_uniform_ with fan_in = 1
        self.weight = nn.Parameter(torch.empty(feature_dim, 1))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
        self.b = nn.Parameter(torch.zeros(1)) if bias else None

    def forward(self, x: torch.Tensor,
                token_mask: torch.Tensor) -> torch.Tensor:
        eij = torch.matmul(x.float(), self.weight)[..., 0]
        if self.b is not None:
            eij = eij + self.b
        a = torch.exp(torch.tanh(eij)) * token_mask.float()
        a = a / (a.sum(dim=1, keepdim=True) + 1e-10)
        count = token_mask.sum(dim=1).clamp(min=1).float()
        mean_a = a.sum(dim=1) / count
        sum_x = (x * token_mask[..., None].to(x.dtype)).sum(dim=1)
        return (mean_a[:, None] * sum_x.float()).to(x.dtype)
