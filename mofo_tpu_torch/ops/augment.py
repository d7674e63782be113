"""The pretrain augmentation on the step's device.

Counterpart of mofo_tpu/ops/augment.py's pretrain_augment (:34-83;
reference DataAugmentationForVideoMAE, datasets.py:10-36): the host ships
fixed-size decoded uint8 frames and the whole batch is cropped
(GroupMultiScaleCrop), resized to the input size and normalized on the
device; per-frame motion boxes are mapped through the crop
(transforms.py:92-135: clamped to the crop, scaled to the output, an
emptied box becomes [0, 0, 1, 1]). The finetune, eval and test-view
pipelines are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mofo_tpu_torch.ops import image as I


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
