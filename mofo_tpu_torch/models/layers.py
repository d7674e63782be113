"""Transformer primitives for the MOFO / VideoMAE model family.

Counterpart of mofo_tpu/models/layers.py (reference modeling_finetune.py).
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

from mofo_tpu_torch.ops.flash_attention import flash_attention_qkv
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


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Stochastic depth per sample (reference modeling_finetune.py:20-31)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.training)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (reference modeling_finetune.py:34-51). In bf16
    the GELU is the tanh form computed in f32; otherwise exact erf, as in
    mofo_tpu/models/layers.py:119-124."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        init_linear(self.fc1, generator)
        init_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.fc1, self.dtype)
        if self.dtype == torch.bfloat16:
            x = F.gelu(x.float(), approximate="tanh").to(self.dtype)
        else:
            x = F.gelu(x)
        return linear(x, self.fc2, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection, learned q/v
    biases and the k bias pinned to zero (reference modeling_finetune.py:
    54-98); attention itself is flash_attention_qkv on the fused (B, N, 3A)
    projection."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        all_head_dim = head_dim * num_heads
        self.scale = qk_scale or head_dim ** -0.5
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * all_head_dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(all_head_dim))
            self.v_bias = nn.Parameter(torch.zeros(all_head_dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(all_head_dim, dim)
        init_linear(self.qkv, generator)
        init_linear(self.proj, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = F.linear(x.to(self.dtype), self.qkv.weight.to(self.dtype))
        if self.q_bias is not None:
            qkv = qkv + torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]
            ).to(self.dtype)
        out = flash_attention_qkv(
            qkv, scale=self.scale, num_heads=self.num_heads
        )
        return linear(out, self.proj, self.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype):
    """LayerNorm computed in f32, output cast to the compute dtype."""
    return norm(x.float()).to(dtype)


class Block(nn.Module):
    """Pre-LN transformer block with optional layerscale (reference
    modeling_finetune.py:194-223)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, dtype,
                              generator)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator)
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        a = self.attn(layer_norm(x, self.norm1, self.dtype))
        if self.gamma_1 is not None:
            a = a * self.gamma_1.to(a.dtype)
        x = x + self.drop_path(a)
        m = self.mlp(layer_norm(x, self.norm2, self.dtype))
        if self.gamma_2 is not None:
            m = m * self.gamma_2.to(m.dtype)
        x = x + self.drop_path(m)
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
