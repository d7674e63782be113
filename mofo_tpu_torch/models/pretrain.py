"""Masked video autoencoder (VideoMAE / MOFO pretraining model).

Counterpart of mofo_tpu/models/pretrain.py (reference modeling_pretrain.py).
The encoder keeps only the visible tokens, gathered at sorted indices
(ops.masking.mask_to_indices) before the blocks; the decoder runs on all
tokens and predicts decoder_num_classes pixels per masked token.
State-dict names are the reference's, so weights move both ways through
mofo_tpu.train.checkpoint.import_torch_pretrain and train.checkpoint here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mofo_tpu_torch.models.layers import (
    Block,
    PatchEmbed,
    get_sinusoid_encoding_table,
    init_linear,
    layer_norm,
    linear,
)
from mofo_tpu_torch.ops.masking import gather_tokens


def _blocks(depth, drop_path_rate, generator, **kw) -> nn.ModuleList:
    dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, depth)]
    return nn.ModuleList(
        Block(drop_path_rate=dpr[i], generator=generator, **kw)
        for i in range(depth)
    )


class PretrainEncoder(nn.Module):
    """ViT encoder over visible tokens only (modeling_pretrain.py:23-101)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, drop_path_rate=0.0,
                 init_values=0.0, tubelet_size=2, num_frames=16,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, num_frames, tubelet_size,
                                      dtype, generator)
        self.register_buffer(
            "pos_embed",
            get_sinusoid_encoding_table(self.patch_embed.num_patches,
                                        embed_dim),
            persistent=False,
        )
        self.blocks = _blocks(
            depth, drop_path_rate, generator, dim=embed_dim,
            num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
            qk_scale=qk_scale, init_values=init_values, dtype=dtype,
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, vis_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x: flat patch rows (B, N, P) or a clip (B, T, H, W, C); vis_idx
        (B, N_vis); `generator` draws the drop-path masks. Returns
        (B, N_vis, D)."""
        tokens = self.patch_embed(x)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        x_vis = gather_tokens(tokens, vis_idx)
        for blk in self.blocks:
            x_vis = blk(x_vis, generator)
        return layer_norm(x_vis, self.norm, self.dtype)


class PretrainDecoder(nn.Module):
    """Shallow decoder predicting pixels for masked tokens
    (modeling_pretrain.py:103-161)."""

    def __init__(self, num_classes=1536, embed_dim=384, depth=4,
                 num_heads=6, mlp_ratio=4.0, qkv_bias=True, qk_scale=None,
                 drop_path_rate=0.0, init_values=0.0, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = _blocks(
            depth, drop_path_rate, generator, dim=embed_dim,
            num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
            qk_scale=qk_scale, init_values=init_values, dtype=dtype,
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes)
        init_linear(self.head, generator)

    def forward(self, x: torch.Tensor, return_token_num: int,
                generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, generator)
        if return_token_num > 0:
            x = x[:, -return_token_num:]
        return linear(layer_norm(x, self.norm, self.dtype), self.head,
                      self.dtype)


class PretrainVisionTransformer(nn.Module):
    """Full MAE: encoder -> encoder_to_decoder -> decoder
    (modeling_pretrain.py:163-266)."""

    def __init__(self, img_size=224, patch_size=16, encoder_in_chans=3,
                 encoder_embed_dim=768, encoder_depth=12,
                 encoder_num_heads=12, decoder_num_classes=1536,
                 decoder_embed_dim=384, decoder_depth=4,
                 decoder_num_heads=6, mlp_ratio=4.0, qkv_bias=True,
                 qk_scale: Optional[float] = None, drop_path_rate=0.0,
                 init_values=0.0, tubelet_size=2, num_frames=16,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.encoder = PretrainEncoder(
            img_size, patch_size, encoder_in_chans, encoder_embed_dim,
            encoder_depth, encoder_num_heads, mlp_ratio, qkv_bias, qk_scale,
            drop_path_rate, init_values, tubelet_size, num_frames, dtype,
            generator,
        )
        self.decoder = PretrainDecoder(
            decoder_num_classes, decoder_embed_dim, decoder_depth,
            decoder_num_heads, mlp_ratio, qkv_bias, qk_scale,
            drop_path_rate, init_values, dtype, generator,
        )
        self.encoder_to_decoder = nn.Linear(
            encoder_embed_dim, decoder_embed_dim, bias=False
        )
        init_linear(self.encoder_to_decoder, generator)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        with torch.no_grad():
            nn.init.trunc_normal_(self.mask_token, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        self.register_buffer(
            "pos_embed",
            get_sinusoid_encoding_table(
                self.encoder.patch_embed.num_patches, decoder_embed_dim
            ),
            persistent=False,
        )

    def forward(self, x: torch.Tensor, vis_idx: torch.Tensor,
                masked_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: flat patch rows (B, N, P) or a clip (B, T, H, W, C);
        vis_idx (B, N_vis), masked_idx (B, N_mask) from mask_to_indices;
        `generator` draws the drop-path masks (needed at a rate > 0).
        Returns (B, N_mask, decoder_num_classes) pixel predictions."""
        x_vis = self.encoder(x.to(self.dtype), vis_idx, generator)
        x_vis = linear(x_vis, self.encoder_to_decoder, self.dtype)
        B = x_vis.shape[0]
        # decoder table gathered to follow the (visible ++ masked) order,
        # reference modeling_pretrain.py:258-263
        pos = self.pos_embed.to(self.dtype).expand(B, -1, -1)
        pos_vis = gather_tokens(pos, vis_idx)
        pos_mask = gather_tokens(pos, masked_idx)
        mask_token = self.mask_token.to(self.dtype)
        x_full = torch.cat([x_vis + pos_vis, mask_token + pos_mask], dim=1)
        return self.decoder(x_full, masked_idx.shape[1], generator)
