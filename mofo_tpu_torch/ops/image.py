"""Batched image ops on the device, for the pretrain and finetune
augmentations.

Counterpart of mofo_tpu/ops/image.py: the bilinear crop-and-resize
(:44-107), the Inception-style random-resized-crop boxes (:115-165;
reference video_transforms.py:499-538, ten tries, first fit, torchvision's
central fallback), GroupMultiScaleCrop's crop boxes (:168-231; reference
transforms.py:137-389), the centre and three-crop windows and the short-side
scale (:234-266), the horizontal flip, normalize and RandomErasing in cube
mode with per-pixel normal fill, one box per clip (:274-345; reference
random_erasing.py:27-173). Clips are (B, T, H, W, C); boxes (B, 4) = (y1,
x1, y2, x2) floats in source pixels; sampling uses half-pixel centres and
clamps to the edge. Every random op draws from a torch.Generator on the
clips' device, or takes its draws (a NamedTuple below, or index tensors), so
that tests can hand both packages the same draws. Every draw is per sample
(leading dimension the batch) through parallel.ddp.per_sample, so that a
data-parallel step's ranks draw the global batch's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core import constants
from mofo_tpu_torch.parallel import ddp


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


def rand(generator, shape, device) -> torch.Tensor:
    """Per-sample U[0, 1) of `shape` (batch, ...)."""
    return ddp.per_sample(
        lambda s: torch.rand(s, generator=generator, device=device), shape)


def randn(generator, shape, device) -> torch.Tensor:
    """Per-sample standard normals of `shape` (batch, ...)."""
    return ddp.per_sample(
        lambda s: torch.randn(s, generator=generator, device=device), shape)


def randint(generator, low: int, high: int, shape, device) -> torch.Tensor:
    """Per-sample integers in [low, high) of `shape` (batch, ...)."""
    return ddp.per_sample(
        lambda s: torch.randint(low, high, s, generator=generator,
                                device=device), shape)


def _uniform(generator, shape, lo: float, hi: float, device):
    """lo + (hi - lo) * U[0, 1), f32."""
    return rand(generator, shape, device) * (hi - lo) + lo


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
        pair_idx = randint(generator, 0, pairs.shape[0], (batch,), device)
    if off_idx is None:
        off_idx = randint(generator, 0, MSC_OFFSETS, (batch,), device)
    pair_idx, off_idx = pair_idx.to(device).long(), off_idx.to(device).long()
    ch, cw = pairs[pair_idx, 0], pairs[pair_idx, 1]
    sel = _msc_offsets(H, W, ch, cw)[torch.arange(batch, device=device),
                                     off_idx]
    y1, x1 = sel[:, 0], sel[:, 1]
    return torch.stack([y1, x1, y1 + ch, x1 + cw], dim=1)


class CropDraws(NamedTuple):
    """random_resized_crop_boxes' draws: per clip and try (B, 10) the area
    share in `scale` and the log aspect ratio in log(`ratio`); per clip (B,)
    the placement fractions in [0, 1)."""
    area: torch.Tensor
    log_ratio: torch.Tensor
    u_i: torch.Tensor
    u_j: torch.Tensor


CROP_TRIES = 10


def sample_crop_draws(generator: Optional[torch.Generator], batch: int,
                      scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                      device=None) -> CropDraws:
    shape = (batch, CROP_TRIES)
    return CropDraws(
        _uniform(generator, shape, scale[0], scale[1], device),
        _uniform(generator, shape, float(np.log(ratio[0])),
                 float(np.log(ratio[1])), device),
        rand(generator, (batch,), device),
        rand(generator, (batch,), device))


def random_resized_crop_boxes(generator: Optional[torch.Generator],
                              batch: int, img_hw: Tuple[int, int],
                              scale: Tuple[float, float] = (0.08, 1.0),
                              ratio: Tuple[float, float] = (3.0 / 4.0,
                                                            4.0 / 3.0),
                              device=None,
                              draws: Optional[CropDraws] = None
                              ) -> torch.Tensor:
    """Inception-style crop boxes: ten tries of (area, log-uniform aspect
    ratio), the first that fits wins, else torchvision's central fallback.
    Returns (B, 4) = (y1, x1, y2, x2) on `device`; `draws` replaces the
    draws from `generator`."""
    H, W = img_hw
    if draws is None:
        draws = sample_crop_draws(generator, batch, scale, ratio, device)
    area = H * W * draws.area.to(device)
    aspect = torch.exp(draws.log_ratio.to(device))
    w = torch.sqrt(area * aspect)
    h = torch.sqrt(area / aspect)
    ok = (w <= W) & (h <= H)
    first = ok.to(torch.uint8).argmax(dim=1, keepdim=True)  # first fit
    any_ok = ok.any(dim=1)
    w = torch.gather(w, 1, first)[:, 0]
    h = torch.gather(h, 1, first)[:, 0]
    i = draws.u_i.to(device) * (H - h)
    j = draws.u_j.to(device) * (W - w)
    # central fallback (torchvision: clamp the ratio, centre the crop)
    in_ratio = W / H
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(W), W / ratio[0]
    elif in_ratio > ratio[1]:
        fb_w, fb_h = H * ratio[1], float(H)
    else:
        fb_w, fb_h = float(W), float(H)
    fb = torch.tensor([(H - fb_h) / 2.0, (W - fb_w) / 2.0, fb_h, fb_w],
                      dtype=torch.float32, device=device)
    h = torch.where(any_ok, h, fb[2])
    w = torch.where(any_ok, w, fb[3])
    i = torch.where(any_ok, i, fb[0])
    j = torch.where(any_ok, j, fb[1])
    return torch.stack([i, j, i + h, j + w], dim=1)


def center_crop_boxes(batch: int, img_hw: Tuple[int, int],
                      crop: Tuple[int, int], device=None) -> torch.Tensor:
    H, W = img_hw
    ch, cw = crop
    y1, x1 = (H - ch) / 2.0, (W - cw) / 2.0
    return torch.tensor([y1, x1, y1 + ch, x1 + cw], dtype=torch.float32,
                        device=device).repeat(batch, 1)


def three_crop_boxes(img_hw: Tuple[int, int], size: int, split_nb: int,
                     num_crops: int = 3
                     ) -> Tuple[float, float, float, float]:
    """Spatial window of test view split_nb along the long side
    (ssv2.py:138-147): start = split_nb * (long - size) / (crops - 1)."""
    H, W = img_hw
    if H >= W:
        y1 = split_nb * (H - size) / max(num_crops - 1, 1)
        return (y1, 0.0, y1 + size, float(W))
    x1 = split_nb * (W - size) / max(num_crops - 1, 1)
    return (0.0, x1, float(H), x1 + size)


def short_side_scale_size(h: int, w: int, short_side: int) -> Tuple[int, int]:
    if h <= w:
        return short_side, int(round(w * short_side / h))
    return int(round(h * short_side / w)), short_side


def horizontal_flip(generator: Optional[torch.Generator],
                    imgs: torch.Tensor, prob: float = 0.5,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-clip random horizontal flip; `flip` (B,) bool replaces the
    draw."""
    if flip is None:
        flip = rand(generator, (imgs.shape[0],), imgs.device) < prob
    flip = flip.to(imgs.device)[:, None, None, None, None]
    return torch.where(flip, torch.flip(imgs, dims=(3,)), imgs)


def normalize(imgs: torch.Tensor,
              mean: Sequence[float] = constants.IMAGENET_DEFAULT_MEAN,
              std: Sequence[float] = constants.IMAGENET_DEFAULT_STD
              ) -> torch.Tensor:
    m = torch.tensor(mean, dtype=imgs.dtype, device=imgs.device)
    s = torch.tensor(std, dtype=imgs.dtype, device=imgs.device)
    return (imgs - m) / s


class ErasingDraws(NamedTuple):
    """random_erasing's draws, per clip (B,): whether to erase, the area
    share in `area_range`, the log aspect ratio in log(`aspect_range`), the
    placement fractions in [0, 1); and the standard-normal fill, (B, 1, H,
    W, C) in cube mode."""
    apply: torch.Tensor
    area: torch.Tensor
    log_ratio: torch.Tensor
    u_y: torch.Tensor
    u_x: torch.Tensor
    fill: torch.Tensor


def sample_erasing_draws(generator: Optional[torch.Generator],
                         shape: Tuple[int, ...], prob: float = 0.25,
                         area_range=(0.02, 1.0 / 3.0),
                         aspect_range=(0.3, 10.0 / 3.0),
                         device=None) -> ErasingDraws:
    B, _, H, W, C = shape
    return ErasingDraws(
        rand(generator, (B,), device) < prob,
        _uniform(generator, (B,), area_range[0], area_range[1], device),
        _uniform(generator, (B,), float(np.log(aspect_range[0])),
                 float(np.log(aspect_range[1])), device),
        rand(generator, (B,), device),
        rand(generator, (B,), device),
        randn(generator, (B, 1, H, W, C), device))


def random_erasing(generator: Optional[torch.Generator], imgs: torch.Tensor,
                   prob: float = 0.25,
                   area_range: Tuple[float, float] = (0.02, 1.0 / 3.0),
                   aspect_range: Tuple[float, float] = (0.3, 10.0 / 3.0),
                   draws: Optional[ErasingDraws] = None) -> torch.Tensor:
    """RandomErasing in the reference recipe's mode: the same box in every
    frame of a clip (cube), filled with per-pixel standard-normal noise, one
    box per clip. Runs on normalized clips (the reference erases after
    normalizing, kinetics.py:216-222). `draws` replaces the draws from
    `generator`."""
    B, _, H, W, _ = imgs.shape
    dev = imgs.device
    if draws is None:
        draws = sample_erasing_draws(generator, imgs.shape, prob, area_range,
                                     aspect_range, dev)
    area = H * W * draws.area.to(dev)
    aspect = torch.exp(draws.log_ratio.to(dev))
    eh = torch.clamp(torch.sqrt(area * aspect), 1, H - 1).to(torch.int32)
    ew = torch.clamp(torch.sqrt(area / aspect), 1, W - 1).to(torch.int32)
    y1 = (draws.u_y.to(dev) * (H - eh)).to(torch.int32)
    x1 = (draws.u_x.to(dev) * (W - ew)).to(torch.int32)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    box = ((rows >= y1[:, None, None]) & (rows < (y1 + eh)[:, None, None])
           & (cols >= x1[:, None, None]) & (cols < (x1 + ew)[:, None, None]))
    box = box & draws.apply.to(dev)[:, None, None]  # (B, H, W)
    return torch.where(box[:, None, :, :, None],
                       draws.fill.to(dev, imgs.dtype), imgs)
