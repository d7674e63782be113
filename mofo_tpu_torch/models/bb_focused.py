"""MOFO BB-focused classifier: fuses pooled in-box and out-of-box token
features before the classification head.

Counterpart of mofo_tpu/models/bb_focused.py (reference
modeling_finetune.py:422-635). A token (t, j, k) is in-box iff the box of
one of its tubelet frames overlaps patch (j, k). Fusing modes over the
in-box (local) and out-box (global) token sets:
  'org'           plain mean over all tokens
  'weighted_mean' (mean_in * 1 + mean_out * 0.5) / 2
  'soft_attn'     SoftAttention(local) + SoftAttention(global)
  'MCA'           cross-attention blocks (queries: all tokens, kv: the
                  out-box tokens through a kv bias row), then the mean over
                  the in-box tokens; its attention is flash_attention_mh (K3)
                  unless attention dropout is active
Per sample, no in-box token falls back to the plain token mean, and an
empty out-box set makes the kv the in-box set. Every mode is a masked,
batched computation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mofo_tpu_torch.models.classifier import VisionTransformer
from mofo_tpu_torch.models.layers import (
    MCABlock,
    SoftAttention,
    init_trunc_normal,
    layer_norm,
    linear,
)
from mofo_tpu_torch.ops.masking import box_to_patch_map

FUSING_MODES = ("org", "weighted_mean", "soft_attn", "MCA")


def token_in_box_map(boxes: torch.Tensor, *, tubelet_size: int = 2,
                     patches_per_side: int = 14,
                     patch_size: int = 16) -> torch.Tensor:
    """boxes (B, T, 4) per-frame pixel boxes -> bool (B, N) token map: token
    (t, j, k) is in-box iff one of its tubelet frames' boxes overlaps patch
    (j, k) (the reference's painted-volume conv, modeling_finetune.py:
    591-630)."""
    per_frame = box_to_patch_map(boxes, patches_per_side=patches_per_side,
                                 patch_size=patch_size, bug_compat=False,
                                 edge="paint")  # (B, T, ppf)
    B, T, ppf = per_frame.shape
    t = T // tubelet_size
    per_token = per_frame[:, :t * tubelet_size].reshape(B, t, tubelet_size,
                                                        ppf)
    return per_token.any(dim=2).reshape(B, t * ppf)


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Mean of x (B, N, D) over the tokens where m (B, N) is True, in f32;
    a row without any returns 0 (the callers fall back)."""
    mf = m.float()[..., None]
    s = (x.float() * mf).sum(dim=1)
    c = mf.sum(dim=1).clamp(min=1.0)
    return (s / c).to(x.dtype)


class VisionTransformerBBFocused(nn.Module):
    """BB-focused classifier (modeling_finetune.py:422-635), batched."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.0, init_values=0.0,
                 init_scale=0.0, all_frames=16, tubelet_size=2,
                 use_mean_pooling=True, fusing_method="weighted_mean",
                 mca_depth=1, mca_num_heads=3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if fusing_method not in FUSING_MODES:
            raise ValueError(f"unknown fusing_method {fusing_method!r}")
        self.fusing_method = fusing_method
        self.dtype = dtype
        self.tubelet_size, self.patch_size = tubelet_size, patch_size
        self.patches_per_side = img_size // patch_size
        self.backbone = VisionTransformer(
            img_size, patch_size, in_chans, 0, embed_dim, depth, num_heads,
            mlp_ratio, qkv_bias, qk_scale, drop_rate, attn_drop_rate,
            drop_path_rate, init_values, 0.0, all_frames, tubelet_size,
            use_mean_pooling, tokens_only=True, dtype=dtype,
            generator=generator,
        )
        if fusing_method == "soft_attn":
            self.soft_att_local = SoftAttention(embed_dim,
                                                generator=generator)
            self.soft_att_global = SoftAttention(embed_dim,
                                                 generator=generator)
        if fusing_method == "MCA":
            self.local_MCA = nn.ModuleList(
                MCABlock(embed_dim, mca_num_heads, mlp_ratio, qkv_bias,
                         qk_scale, init_values, dtype, generator,
                         drop=drop_rate, attn_drop=attn_drop_rate)
                for _ in range(mca_depth)
            )
        self.fc_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = (nn.Linear(embed_dim, num_classes) if num_classes > 0
                     else None)
        if self.head is not None:
            init_trunc_normal(self.head, generator)
            with torch.no_grad():
                self.head.weight.mul_(init_scale)

    def forward(self, x: torch.Tensor, boxes: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, H, W, C); boxes: (B, T, 4) per-frame pixel boxes.
        Returns (B, num_classes) logits (the pooled features without a
        head). `generator` draws the dropout and drop-path masks (in train
        mode)."""
        tokens = self.backbone(x, generator, return_tokens=True)
        in_map = token_in_box_map(boxes, tubelet_size=self.tubelet_size,
                                  patches_per_side=self.patches_per_side,
                                  patch_size=self.patch_size)
        has_in = in_map.any(dim=1)
        out_map = ~in_map
        has_out = out_map.any(dim=1)
        plain_mean = tokens.mean(dim=1)

        mode = self.fusing_method
        if mode == "org":
            fused = plain_mean
        elif mode == "weighted_mean":
            fused = (_masked_mean(tokens, in_map) * 1.0
                     + _masked_mean(tokens, out_map) * 0.5) / 2.0
        elif mode == "soft_attn":
            fused = (self.soft_att_local(tokens, in_map)
                     + self.soft_att_global(tokens, out_map))
        else:  # MCA; an empty out-box set attends to the in-box tokens
            kv_mask = torch.where(has_out[:, None], out_map, in_map)
            mca = tokens
            for blk in self.local_MCA:
                mca = blk(mca, tokens, kv_mask, generator)
            fused = _masked_mean(mca, in_map)
        if mode != "org":
            fused = torch.where(has_in[:, None], fused, plain_mean)

        pooled = layer_norm(fused, self.fc_norm, self.dtype)
        if self.head is None:
            return pooled
        return linear(pooled, self.head, self.dtype)
