"""Flat patch rows and normalized-pixel reconstruction targets.

Counterpart of mofo_tpu/ops/patchify.py (patchify_flat :113-137, the
masked targets :140-255, the loss :272-288), after the reference target
construction in engine_for_pretraining.py:43-63: un-normalize the clip,
per-patch per-channel (x - mean) / (sqrt(unbiased var) + 1e-6) with f32
statistics, channel fastest, masked positions only. Clips are
channel-last (B, T, H, W, C).
"""

from __future__ import annotations

from typing import Optional

import torch

from mofo_tpu_torch.core import constants


def _wide(dtype: torch.dtype) -> torch.dtype:
    """f32 accumulation, except f64 inputs stay f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def patchify_flat(
    clip: torch.Tensor, patch_size: int = 16, tubelet_size: int = 2
) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, N, p0*p*p*C) token-major flat patch rows,
    channel fastest: the '(p c)' layout of the targets and the input of
    the patch-embedding matmul."""
    B, T, H, W, C = clip.shape
    p0, p = tubelet_size, patch_size
    t, h, w = T // p0, H // p, W // p
    x = clip.reshape(B, t, p0, h, p, w, p * C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)  # (B, t, h, w, p0, p1, p2*C)
    return x.reshape(B, t * h * w, p0 * p * p * C)


def masked_normalized_targets(
    tokens_pix: torch.Tensor,
    mask_indices: torch.Tensor,
    *,
    normalize_target: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Targets (B, M, D) at the masked rows of tokens_pix (B, N, D), the
    ImageNet-normalized rows of patchify_flat. The gather stays in bf16 for
    bf16 rows."""
    bf16 = tokens_pix.dtype == torch.bfloat16
    wdt = tokens_pix.dtype if bf16 else _wide(tokens_pix.dtype)
    idx = mask_indices[..., None].expand(*mask_indices.shape,
                                         tokens_pix.shape[-1])
    g = torch.gather(tokens_pix, 1, idx).to(wdt)
    return normalize_patch_rows(
        g, normalize_target=normalize_target, compute_dtype=compute_dtype,
    )


def normalize_patch_rows(
    g: torch.Tensor,
    *,
    normalize_target: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Un-normalizes gathered RGB rows g (B, M, D), channel fastest, from
    ImageNet normalization, then normalizes each patch per channel.
    Statistics accumulate in f32 (f64 for f64 rows): mean, unbiased
    variance, denominator sqrt(var) + 1e-6. For bf16 targets the
    normalization is the one fma out = g * (1/denom) + (-mu/denom), as the
    JAX version does; otherwise (g - mu) / denom."""
    B, M, D = g.shape
    channels = len(constants.IMAGENET_DEFAULT_STD)
    npos = D // channels
    acc = _wide(g.dtype)
    wdt = g.dtype if g.dtype == torch.bfloat16 else acc
    g = g.to(wdt)
    std = torch.tensor(constants.IMAGENET_DEFAULT_STD, dtype=wdt,
                       device=g.device)
    mean = torch.tensor(constants.IMAGENET_DEFAULT_MEAN, dtype=wdt,
                        device=g.device)
    g = g * std.repeat(npos) + mean.repeat(npos)
    if not normalize_target:
        return g.to(compute_dtype)
    g4 = g.reshape(B, M, npos, channels)
    sums = g4.to(acc).sum(dim=2)
    # squares are rounded to the row dtype before they are summed
    sqs = (g4.to(acc) * g4).to(wdt).to(acc).sum(dim=2)
    mu = sums / npos
    var = (sqs - npos * mu * mu) / (npos - 1)  # unbiased
    denom = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6

    def spread(stat):  # (B, M, C) -> (B, M, D) in compute_dtype
        return stat[:, :, None, :].expand(B, M, npos, channels).reshape(
            B, M, D
        ).to(compute_dtype).to(acc)

    if compute_dtype == torch.bfloat16:
        a = 1.0 / denom
        out = g.to(acc) * spread(a) + spread(-mu * a)
    else:
        out = (g.to(acc) - spread(mu)) / spread(denom)
    return out.to(compute_dtype)


def masked_mse_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    weight_sum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean squared error over the predicted masked tokens; with weights
    (B, M), sum(err * w) / (sum(w) * D + 1e-12). `weight_sum` replaces
    sum(w) in the denominator (a data-parallel step passes the global
    batch's)."""
    acc = _wide(torch.promote_types(pred.dtype, target.dtype))
    err = torch.square(pred.to(acc) - target.to(acc))
    if weights is None:
        return err.mean()
    w = weights.to(acc)[..., None]
    total = w.sum() if weight_sum is None else weight_sum.to(acc)
    return (err * w).sum() / (total * err.shape[-1] + 1e-12)
