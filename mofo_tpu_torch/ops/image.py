"""Batched image ops on the device, for the pretrain augmentation.

Counterpart of the parts of mofo_tpu/ops/image.py that pretrain_augment
runs: the bilinear crop-and-resize (:44-107), GroupMultiScaleCrop's crop
boxes (:168-231; reference transforms.py:137-389) and normalize (:282-289).
Clips are (B, T, H, W, C); boxes (B, 4) = (y1, x1, y2, x2) floats in source
pixels; sampling uses half-pixel centres and clamps to the edge. The crop
draws come from a torch.Generator; multi_scale_crop_boxes also takes the
pair and offset indices, so that tests can hand both packages the same
draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core import constants


def _bilinear_gather(imgs: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """imgs: (B, T, H, W, C); ys / xs: (B, out_h) / (B, out_w) source
    coordinates. Returns (B, T, out_h, out_w, C). Coordinates outside the
    image clamp to its edge."""
    B, T, H, W, C = imgs.shape
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys, 0, H - 1) - y0
    wx = torch.clamp(xs, 0, W - 1) - x0

    def rows(x, idx):  # (B, T, H, W, C), (B, oh) -> (B, T, oh, W, C)
        idx = idx.long()[:, None, :, None, None]
        return torch.gather(x, 2, idx.expand(B, T, -1, W, C))

    def cols(x, idx):  # (B, T, oh, W, C), (B, ow) -> (B, T, oh, ow, C)
        idx = idx.long()[:, None, None, :, None]
        return torch.gather(x, 3, idx.expand(B, T, x.shape[2], -1, C))

    top, bot = rows(imgs, y0), rows(imgs, y1)
    wy_b = wy[:, None, :, None, None]
    wx_b = wx[:, None, None, :, None]
    topmix = cols(top, x0) * (1 - wx_b) + cols(top, x1) * wx_b
    botmix = cols(bot, x0) * (1 - wx_b) + cols(bot, x1) * wx_b
    return topmix * (1 - wy_b) + botmix * wy_b


def crop_and_resize(imgs: torch.Tensor, boxes: torch.Tensor,
                    out_size: Tuple[int, int]) -> torch.Tensor:
    """Crops per-sample boxes (B, 4) = (y1, x1, y2, x2) and resizes them to
    out_size (h, w), bilinear, half-pixel centres."""
    out_h, out_w = out_size
    y1, x1, y2, x2 = boxes.unbind(dim=1)
    oy = torch.arange(out_h, dtype=torch.float32, device=imgs.device)[None]
    ox = torch.arange(out_w, dtype=torch.float32, device=imgs.device)[None]
    ys = y1[:, None] + (oy + 0.5) * ((y2 - y1) / out_h)[:, None] - 0.5
    xs = x1[:, None] + (ox + 0.5) * ((x2 - x1) / out_w)[:, None] - 0.5
    return _bilinear_gather(imgs, ys, xs)


def resize(imgs: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Plain bilinear resize of (B, T, H, W, C)."""
    B, _, H, W, _ = imgs.shape
    boxes = torch.tensor([0.0, 0.0, float(H), float(W)],
                         device=imgs.device).repeat(B, 1)
    return crop_and_resize(imgs, boxes, out_size)


# GroupMultiScaleCrop constants (transforms.py:137-175)
_MSC_SCALES = (1.0, 0.875, 0.75, 0.66)
_MSC_MAX_DISTORT = 1
MSC_OFFSETS = 13


def _msc_size_pairs(base: int, out_size: int) -> np.ndarray:
    """Crop size pairs drawn from scales of min(H, W) of the decoded frame
    (transforms.py:143-152): sizes = int(min(H, W) * scale), then any size
    within 3 px of the network input size snaps to it exactly."""
    sizes = [int(base * s) for s in _MSC_SCALES]
    sizes = [out_size if abs(s - out_size) < 3 else s for s in sizes]
    pairs = [(h, w) for i, h in enumerate(sizes) for j, w in enumerate(sizes)
             if abs(i - j) <= _MSC_MAX_DISTORT]
    return np.asarray(pairs, dtype=np.float32)


def _msc_offsets(H: int, W: int, ch: torch.Tensor,
                 cw: torch.Tensor) -> torch.Tensor:
    """The 13 fixed crop offsets (transforms.py:345-368). ch / cw: (B,).
    Returns (B, 13, 2) = (y, x)."""
    w_step = (W - cw) / 4.0
    h_step = (H - ch) / 4.0
    grid = ((0, 0), (0, 4), (4, 0), (4, 4), (2, 2), (0, 2), (4, 2), (2, 0),
            (2, 4), (1, 1), (1, 3), (3, 1), (3, 3))  # (y, x) in steps
    return torch.stack([torch.stack([y * h_step, x * w_step], dim=-1)
                        for y, x in grid], dim=1)


def multi_scale_crop_boxes(generator: Optional[torch.Generator], batch: int,
                           img_hw: Tuple[int, int], base_size: int,
                           device=None,
                           pair_idx: Optional[torch.Tensor] = None,
                           off_idx: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """GroupMultiScaleCrop crop boxes: a random size pair of the
    max-distort-1 scale grid over min(H, W) (sizes near base_size snap to
    it) at a random one of the 13 fixed offsets. (B, 4) (y1, x1, y2, x2) on
    `device`. pair_idx / off_idx (B,) replace the draws from `generator`
    (which must lie on `device`)."""
    H, W = img_hw
    pairs = torch.from_numpy(_msc_size_pairs(min(H, W), base_size)).to(device)
    if pair_idx is None:
        pair_idx = torch.randint(0, pairs.shape[0], (batch,),
                                 generator=generator, device=device)
    if off_idx is None:
        off_idx = torch.randint(0, MSC_OFFSETS, (batch,),
                                generator=generator, device=device)
    pair_idx, off_idx = pair_idx.to(device).long(), off_idx.to(device).long()
    ch, cw = pairs[pair_idx, 0], pairs[pair_idx, 1]
    sel = _msc_offsets(H, W, ch, cw)[torch.arange(batch, device=device),
                                     off_idx]
    y1, x1 = sel[:, 0], sel[:, 1]
    return torch.stack([y1, x1, y1 + ch, x1 + cw], dim=1)


def normalize(imgs: torch.Tensor,
              mean: Sequence[float] = constants.IMAGENET_DEFAULT_MEAN,
              std: Sequence[float] = constants.IMAGENET_DEFAULT_STD
              ) -> torch.Tensor:
    m = torch.tensor(mean, dtype=imgs.dtype, device=imgs.device)
    s = torch.tensor(std, dtype=imgs.dtype, device=imgs.device)
    return (imgs - m) / s
