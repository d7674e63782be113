"""Video classification ViT (finetuning backbone + head).

Counterpart of mofo_tpu/models/classifier.py (reference
modeling_finetune.py:305-420): patch embedding, the frozen sin-cos table
and its dropout (pos_drop), Blocks over all tokens (K1/K2 at the published
widths; layers.Attention has the routes, and drop_rate / attn_drop_rate
are every Block's dropouts), then fc_norm of the token mean
(use_mean_pooling) or the final norm, and the head. Every linear is
trunc-normal(.02) with a zero bias, the head's weight scaled by init_scale.
attn_impl and sow_attn go to every Block's Attention.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mofo_tpu_torch.models.layers import (
    Block,
    PatchEmbed,
    dropout,
    get_sinusoid_encoding_table,
    init_trunc_normal,
    layer_norm,
    linear,
)


class VisionTransformer(nn.Module):
    """Classification backbone (modeling_finetune.py:305-409). With
    tokens_only (the BB-focused model's backbone) it has no fc_norm and no
    head, as the JAX backbone called with return_tokens creates none."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.0, init_values=0.0,
                 init_scale=0.0, all_frames=16, tubelet_size=2,
                 use_mean_pooling=True, tokens_only=False,
                 dtype=torch.float32, generator=None, attn_impl="auto",
                 sow_attn=False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.use_mean_pooling = use_mean_pooling
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, all_frames, tubelet_size,
                                      dtype, generator)
        self.register_buffer(
            "pos_embed",
            get_sinusoid_encoding_table(self.patch_embed.num_patches,
                                        embed_dim),
            persistent=False,
        )
        dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_scale,
                  dpr[i], init_values, dtype, generator, attn_impl,
                  drop=drop_rate, attn_drop=attn_drop_rate,
                  sow_attn=sow_attn)
            for i in range(depth)
        )
        self.norm = (None if use_mean_pooling
                     else nn.LayerNorm(embed_dim, eps=1e-6))
        pooled = use_mean_pooling and not tokens_only
        self.fc_norm = nn.LayerNorm(embed_dim, eps=1e-6) if pooled else None
        self.head = (nn.Linear(embed_dim, num_classes)
                     if num_classes > 0 and not tokens_only else None)
        init_trunc_normal(self, generator)
        if self.head is not None:
            with torch.no_grad():
                self.head.weight.mul_(init_scale)

    def backbone_tokens(self, x: torch.Tensor,
                        generator: Optional[torch.Generator] = None):
        """Patch-embed + pos (+ its dropout) + blocks -> (B, N, D) token
        features."""
        tokens = self.patch_embed(x.to(self.dtype))
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        tokens = dropout(tokens, self.drop_rate, self.training, generator)
        for blk in self.blocks:
            tokens = blk(tokens, generator)
        if self.norm is not None:
            tokens = layer_norm(tokens, self.norm, self.dtype)
        return tokens

    def pool(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.use_mean_pooling:
            return layer_norm(tokens.mean(dim=1), self.fc_norm, self.dtype)
        return tokens[:, 0]

    def head_out(self, pooled: torch.Tensor) -> torch.Tensor:
        if self.head is None:
            return pooled
        return linear(pooled, self.head, self.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False,
                return_tokens: bool = False) -> torch.Tensor:
        """x: (B, T, H, W, C). Returns (B, num_classes) logits; the pooled
        (B, D) features with return_features (the reference's
        VisionTransformer_feat_ext); the (B, N, D) tokens with
        return_tokens. `generator` draws the dropout and drop-path masks
        (in train mode)."""
        tokens = self.backbone_tokens(x, generator)
        if return_tokens:
            return tokens
        pooled = self.pool(tokens)
        if return_features:
            return pooled
        return self.head_out(pooled)
