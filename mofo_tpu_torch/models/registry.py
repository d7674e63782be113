"""Model registry with the reference's names.

Counterpart of mofo_tpu/models/registry.py: the pretraining models
(:39-80) and the finetuning ones (:85-155).
create_model(name, device=..., dtype=..., seed=..., **overrides) returns
the nn.Module on its device, initialised from `seed` on the CPU (so a seed
gives the same weights on every device) and then moved. The overrides
reach the model's constructor: drop_rate and attn_drop_rate on every
model, attn_impl on the pretraining models and the classifiers (the
BB-focused one too), sow_attn on the classifiers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from mofo_tpu_torch.core.device import DeviceLike, resolve_device
from mofo_tpu_torch.models.bb_focused import VisionTransformerBBFocused
from mofo_tpu_torch.models.classifier import VisionTransformer
from mofo_tpu_torch.models.pretrain import PretrainVisionTransformer

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(fn: Callable[..., Any]) -> Callable[..., Any]:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 **kwargs: Any) -> torch.nn.Module:
    """Builds a registered model. `device` defaults to CUDA and raises when
    no GPU is present; `dtype` is the compute dtype (parameters stay f32)."""
    dev = resolve_device(device)
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {', '.join(list_models())}"
        )
    generator = torch.Generator().manual_seed(seed)
    model = _REGISTRY[name](dtype=dtype, generator=generator, **kwargs)
    return model.to(dev)


def _pretrain(enc_dim, enc_depth, enc_heads, dec_dim, dec_heads, **kwargs):
    cfg = dict(
        img_size=224,
        patch_size=16,
        encoder_embed_dim=enc_dim,
        encoder_depth=enc_depth,
        encoder_num_heads=enc_heads,
        decoder_num_classes=1536,
        decoder_embed_dim=dec_dim,
        decoder_num_heads=dec_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
    )
    cfg.update(kwargs)  # explicit overrides win
    return PretrainVisionTransformer(**cfg)


# --- pretraining models (modeling_pretrain.py:268-338) ---------------------


@register_model
def pretrain_videomae_small_patch16_224(**kwargs):
    return _pretrain(384, 12, 6, 192, 3, **kwargs)


@register_model
def pretrain_videomae_base_patch16_224(**kwargs):
    return _pretrain(768, 12, 12, 384, 6, **kwargs)


@register_model
def pretrain_videomae_large_patch16_224(**kwargs):
    return _pretrain(1024, 24, 16, 512, 8, **kwargs)


@register_model
def pretrain_videomae_tiny_debug(**kwargs):
    """Rebuild-only CI preset (no reference counterpart): 2-block dim-64
    encoder (2 x 32 heads) + dim-32 decoder (2 x 16 heads). Neither width
    is a multiple of 128, so every Block takes the head-major route: plain
    attention math below 128 tokens (on the card too), K4 from 128 on,
    whose CUDA kernels are built for head dims 16, 32 and 64 (the CPU runs
    their plain versions)."""
    return _pretrain(64, 2, 2, 32, 2, **kwargs)


# --- finetuning models (modeling_finetune.py:637-705) ----------------------


def _vit(_embed_dim, _depth, _num_heads, _img_size=224, **kwargs):
    cfg = dict(
        img_size=_img_size,
        patch_size=16,
        embed_dim=_embed_dim,
        depth=_depth,
        num_heads=_num_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
    )
    cfg.update(kwargs)  # explicit overrides win
    return VisionTransformer(**cfg)


@register_model
def vit_small_patch16_224(**kwargs):
    return _vit(384, 12, 6, **kwargs)


@register_model
def vit_base_patch16_224(**kwargs):
    return _vit(768, 12, 12, **kwargs)


@register_model
def vit_base_patch16_384(**kwargs):
    return _vit(768, 12, 12, _img_size=384, **kwargs)


@register_model
def vit_large_patch16_224(**kwargs):
    return _vit(1024, 24, 16, **kwargs)


@register_model
def vit_large_patch16_384(**kwargs):
    return _vit(1024, 24, 16, _img_size=384, **kwargs)


@register_model
def vit_large_patch16_512(**kwargs):
    return _vit(1024, 24, 16, _img_size=512, **kwargs)


@register_model
def vit_tiny_debug(**kwargs):
    """Rebuild-only CI preset (no reference counterpart): 2-block dim-64
    classifier (2 x 32 heads). Its Blocks take the head-major route, as
    pretrain_videomae_tiny_debug's do: plain math below 128 tokens on
    every device; from 128 tokens, K4 (head dims 16, 32 and 64 on the
    card)."""
    return _vit(64, 2, 2, **kwargs)


@register_model
def vit_base_patch16_224_feature_ext(**kwargs):
    # the same module; call it with return_features=True
    kwargs.setdefault("num_classes", 0)
    return _vit(768, 12, 12, **kwargs)


def _bb(_embed_dim, _depth, _num_heads, **kwargs):
    cfg = dict(
        img_size=224,
        patch_size=16,
        embed_dim=_embed_dim,
        depth=_depth,
        num_heads=_num_heads,
        mlp_ratio=4.0,
        qkv_bias=True,
    )
    cfg.update(kwargs)
    return VisionTransformerBBFocused(**cfg)


@register_model
def vit_base_patch16_224_BB_focused(**kwargs):
    return _bb(768, 12, 12, **kwargs)


@register_model
def vit_tiny_debug_BB_focused(**kwargs):
    """Rebuild-only CI preset of the port (no reference counterpart): the
    BB-focused model on vit_tiny_debug's 2-block dim-64 backbone with a
    2-head MCA, for the finetune CLI's CPU tests. Its 32-dim heads take the
    plain versions on the CPU; on the card the backbone's take K4 from 128
    tokens and the MCA's take K3, both built for head dim 32."""
    kwargs.setdefault("mca_num_heads", 2)
    return _bb(64, 2, 2, **kwargs)
