"""The augmentation pipelines on the step's device.

Counterpart of mofo_tpu/ops/augment.py: the host ships fixed-size decoded
uint8 frames and the whole batch is augmented on the device; per-frame
motion boxes are mapped through the crop (transforms.py:92-135: clamped to
the crop, scaled to the output, an emptied box becomes [0, 0, 1, 1]).
  - pretrain_augment (:65-83; reference DataAugmentationForVideoMAE,
    datasets.py:10-36): GroupMultiScaleCrop -> resize -> normalize;
  - finetune_augment (:86-122; kinetics.py:163-222 order): RandAugment on
    [0, 255] (boxes rotated with their clip) -> normalize -> random resized
    crop (0.08-1 of the area, ratio 3:4-4:3; boxes mapped through it) ->
    optional flip (boxes not remapped, as in the reference, which turns the
    flip off for its BB datasets) -> RandomErasing;
  - eval_augment (:125-147): short-side resize -> centre crop ->
    normalize;
  - test_view_augment (:150-180): short-side resize -> the split_nb-th
    window along the long side -> normalize.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mofo_tpu_torch.ops import image as I
from mofo_tpu_torch.ops.rand_augment import (
    RandAugmentDraws,
    rand_augment_batch,
    sample_rand_augment_draws,
)


def _to_float01(clips_u8: torch.Tensor) -> torch.Tensor:
    return clips_u8.to(torch.float32) / 255.0


def _map_boxes_through_crop(boxes: torch.Tensor, crop: torch.Tensor,
                            out_size) -> torch.Tensor:
    """boxes: (B, T, 4) (x1, y1, x2, y2) source pixels; crop: (B, 4)
    (y1, x1, y2, x2). Clamps to the crop, then scales to the output, like
    the albumentations Crop+Resize pascal_voc tracking
    (transforms.py:102-135). Boxes that vanish become [0, 0, 1, 1].
    out_size: int or (h, w)."""
    out_h, out_w = ((out_size, out_size) if isinstance(out_size, int)
                    else out_size)
    cy1, cx1, cy2, cx2 = (crop[:, i:i + 1] for i in range(4))
    sx = out_w / (cx2 - cx1)
    sy = out_h / (cy2 - cy1)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    x1 = (clip(boxes[..., 0], cx1, cx2) - cx1) * sx
    y1 = (clip(boxes[..., 1], cy1, cy2) - cy1) * sy
    x2 = (clip(boxes[..., 2], cx1, cx2) - cx1) * sx
    y2 = (clip(boxes[..., 3], cy1, cy2) - cy1) * sy
    out = torch.stack([x1, y1, x2, y2], dim=-1)
    empty = (out[..., 2] - out[..., 0] < 1.0) | (out[..., 3] - out[..., 1]
                                                 < 1.0)
    fallback = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=out.dtype,
                            device=out.device)
    return torch.where(empty[..., None], fallback, out)


def pretrain_augment(generator: Optional[torch.Generator],
                     clips_u8: torch.Tensor, out_size: int = 224,
                     boxes: Optional[torch.Tensor] = None,
                     pair_idx: Optional[torch.Tensor] = None,
                     off_idx: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """uint8 (B, T, H0, W0, 3) -> normalized float32 (B, T, S, S, 3) on the
    clips' device. Returns (clips, boxes'), boxes' the crop-space pixel
    boxes when boxes are given. The crop is drawn from `generator` (on the
    clips' device) unless pair_idx / off_idx give it
    (image.multi_scale_crop_boxes)."""
    B, _, H0, W0 = clips_u8.shape[:4]
    crop = I.multi_scale_crop_boxes(generator, B, (H0, W0), out_size,
                                    device=clips_u8.device,
                                    pair_idx=pair_idx, off_idx=off_idx)
    x = I.crop_and_resize(_to_float01(clips_u8), crop, (out_size, out_size))
    x = I.normalize(x)
    out_boxes = None
    if boxes is not None:
        out_boxes = _map_boxes_through_crop(boxes.float(), crop, out_size)
    return x, out_boxes


class FinetuneDraws(NamedTuple):
    """finetune_augment's draws, one part per random op (None where the op
    is off)."""
    rand_augment: Optional[RandAugmentDraws]
    crop: I.CropDraws
    flip: Optional[torch.Tensor]
    erasing: Optional[I.ErasingDraws]


def sample_finetune_draws(generator: Optional[torch.Generator],
                          shape: Tuple[int, ...], out_size: int = 224,
                          aa: Optional[str] = "rand-m7-n4-mstd0.5-inc1",
                          flip: bool = True, reprob: float = 0.25,
                          device=None) -> FinetuneDraws:
    """The draws of finetune_augment on uint8 clips of `shape` (B, T, H0,
    W0, C), from `generator` on `device`, in the pipeline's order."""
    B, T, _, _, C = shape
    return FinetuneDraws(
        sample_rand_augment_draws(generator, B, aa, device) if aa else None,
        I.sample_crop_draws(generator, B, device=device),
        (I.rand(generator, (B,), device) < 0.5
         if flip else None),
        (I.sample_erasing_draws(generator, (B, T, out_size, out_size, C),
                                reprob, device=device)
         if reprob > 0 else None))


def finetune_augment(generator: Optional[torch.Generator],
                     clips_u8: torch.Tensor, out_size: int = 224,
                     aa: Optional[str] = "rand-m7-n4-mstd0.5-inc1",
                     flip: bool = True, reprob: float = 0.25,
                     boxes: Optional[torch.Tensor] = None,
                     draws: Optional[FinetuneDraws] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """uint8 (B, T, H0, W0, 3) -> normalized float32 (B, T, S, S, 3) on the
    clips' device, with the training augmentation. Returns (clips, boxes'),
    boxes' the crop-space pixel boxes when boxes (B, T, 4) are given. The
    draws come from `generator` (on the clips' device) unless `draws` gives
    them."""
    B, _, H0, W0 = clips_u8.shape[:4]
    dev = clips_u8.device
    if draws is None:
        draws = sample_finetune_draws(generator, clips_u8.shape, out_size,
                                      aa, flip, reprob, dev)
    x = clips_u8.to(torch.float32)
    if boxes is not None:
        boxes = boxes.float()
    if aa:
        if boxes is not None:
            # the BB fork: boxes go through RandAugment (rotated with the
            # clip) before the crop mapping
            x, boxes = rand_augment_batch(None, x, aa, boxes=boxes,
                                          draws=draws.rand_augment)
        else:
            x = rand_augment_batch(None, x, aa, draws=draws.rand_augment)
    x = I.normalize(x / 255.0)
    crop = I.random_resized_crop_boxes(None, B, (H0, W0), device=dev,
                                       draws=draws.crop)
    x = I.crop_and_resize(x, crop, (out_size, out_size))
    out_boxes = None
    if boxes is not None:
        out_boxes = _map_boxes_through_crop(boxes, crop, out_size)
    if flip:
        x = I.horizontal_flip(None, x, flip=draws.flip)
    if reprob > 0:
        x = I.random_erasing(None, x, prob=reprob, draws=draws.erasing)
    return x, out_boxes


def _resized(clips_u8: torch.Tensor, short_side: int):
    """The clips on [0, 1], their short side resized to short_side, and
    the (x, y, x, y) scale that maps source boxes onto them."""
    H0, W0 = clips_u8.shape[2:4]
    rh, rw = I.short_side_scale_size(H0, W0, short_side)
    x = I.resize(_to_float01(clips_u8), (rh, rw))
    scale = torch.tensor([rw / W0, rh / H0, rw / W0, rh / H0],
                         dtype=torch.float32, device=clips_u8.device)
    return x, (rh, rw), scale


def eval_augment(clips_u8: torch.Tensor, out_size: int = 224,
                 short_side: int = 224,
                 boxes: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Validation: short-side resize -> centre crop -> normalize (the
    reference's kinetics.py val path)."""
    B = clips_u8.shape[0]
    x, (rh, rw), scale = _resized(clips_u8, short_side)
    crop = I.center_crop_boxes(B, (rh, rw), (out_size, out_size),
                               device=clips_u8.device)
    x = I.normalize(I.crop_and_resize(x, crop, (out_size, out_size)))
    out_boxes = None
    if boxes is not None:
        out_boxes = _map_boxes_through_crop(boxes.float() * scale, crop,
                                            out_size)
    return x, out_boxes


def test_view_augment(clips_u8: torch.Tensor, split_nb: int,
                      out_size: int = 224, short_side: int = 224,
                      num_crops: int = 3,
                      boxes: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Test view: short-side resize, then the split_nb-th spatial window
    along the long side (ssv2.py:138-147), sampled at its own size."""
    B = clips_u8.shape[0]
    x, (rh, rw), scale = _resized(clips_u8, short_side)
    y1, x1, y2, x2 = I.three_crop_boxes((rh, rw), out_size, split_nb,
                                        num_crops)
    crop = torch.tensor([y1, x1, y2, x2], dtype=torch.float32,
                        device=clips_u8.device).repeat(B, 1)
    out_hw = (int(round(y2 - y1)), int(round(x2 - x1)))
    x = I.normalize(I.crop_and_resize(x, crop, out_hw))
    out_boxes = None
    if boxes is not None:
        out_boxes = _map_boxes_through_crop(boxes.float() * scale, crop,
                                            out_hw)
    return x, out_boxes
