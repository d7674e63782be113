"""Motion bounding-box extraction from motion-magnitude maps.

A copy of mofo_tpu/factory/bbox.py: scipy and cv2 on the host, by nature.

Behavioral parity with scripts/data/SSV2/bounding_box_creator_SSV.py:57-434
(the EK variant differs only in paths/IO):

  Per frame:
    1. gaussian(sigma=1) on the motion map
    2. zero pixels < 0.4 * max (after blur)
    3. zero pixels < 1.5 * std
    4. gaussian(sigma=30)
    5. find contours; keep the 2 largest, or only the largest if the two
       centers are farther apart than 0.4 * image diagonal
    6. box = min/max of the nonzero contour-filled mask; frame 0 with no
       signal falls back to the central half box
  Temporal cleanup:
    7. replace boxes wider/taller than 0.7*w/h or smaller than 0.01*area
       with the next frame's box (borrow forward)
    8. variance-vs-mean smoothing: boxes whose coordinate variance exceeds
       0.1 * box area borrow the previous frame's box
    9. 5% padding on boxes smaller than 0.4 of the frame side; clamp
   10. final clip-union: every frame is overwritten with the min/max union
       box across the clip (bounding_box_creator_SSV.py:413-434); tiny
       unions fall back to the central half box
  Output JSON: {video: [{labels: [{box2d: {x1,y1,x2,y2},
                gt_annotation: 'union'}]}]}
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _frame_box(
    mm: np.ndarray, h: int, w: int, prev_box: Optional[Tuple]
) -> Tuple[int, int, int, int]:
    """Steps 1-6 for one motion-map frame (grayscale or RGB uint8)."""
    import cv2
    from scipy.ndimage import gaussian_filter

    m = mm.astype(np.float64)
    m = gaussian_filter(m, sigma=1)
    peak = m.max()
    m[m < 0.4 * peak] = 0
    sigma = m.std() + 1e-5
    m[m < 1.5 * sigma] = 0
    m = gaussian_filter(m, sigma=30)

    gray = m if m.ndim == 2 else m.mean(-1)
    gray = np.clip(gray, 0, 255).astype(np.uint8)
    contours, _ = cv2.findContours(
        gray, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
    )
    contours = sorted(contours, key=cv2.contourArea, reverse=True)
    if len(contours) >= 2:
        con_len = 2
        centers = [np.mean(c, axis=0) for c in contours[:2]]
        if np.linalg.norm(centers[0] - centers[1]) > 0.4 * np.hypot(h, w):
            con_len = 1
    else:
        con_len = len(contours)

    mask = np.zeros((h, w), np.uint8)
    for j in range(con_len):
        cv2.drawContours(mask, contours, j, 255, -1)
    nz = np.nonzero(mask)
    if len(nz[0]) == 0:
        if prev_box is not None:
            return prev_box
        return (w // 4, h // 4, 3 * w // 4, 3 * h // 4)
    return (
        int(nz[1].min()), int(nz[0].min()),
        int(nz[1].max()), int(nz[0].max()),
    )


def extract_boxes(
    motion_maps: Sequence[np.ndarray],
    *,
    clip_union: bool = True,
) -> List[Tuple[int, int, int, int]]:
    """Motion maps (T frames, HxW[x3] uint8) -> per-frame (x1,y1,x2,y2).
    clip_union=True applies the reference's final union overwrite."""
    h, w = motion_maps[0].shape[:2]
    boxes: List[Tuple[int, int, int, int]] = []
    for i, mm in enumerate(motion_maps):
        prev = boxes[-1] if boxes else None
        boxes.append(_frame_box(mm, h, w, prev))

    # step 7: borrow forward for degenerate boxes
    n = len(boxes)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i]
        j = i
        while (
            (x2 - x1) > 0.7 * w
            or (y2 - y1) > 0.7 * h
            or (x2 - x1) * (y2 - y1) < 0.01 * w * h
        ) and j < n - 1:
            boxes[i] = boxes[j + 1]
            x1, y1, x2, y2 = boxes[i]
            j += 1

    # step 8: variance-based smoothing vs the clip mean
    arr = np.asarray(boxes, np.float64)
    mean = arr.mean(axis=0)
    for i in range(n):
        var = float(np.mean((arr[i] - mean) ** 2))
        x1, y1, x2, y2 = boxes[i]
        if var > (x2 - x1) * (y2 - y1) * 0.1 and i > 0:
            boxes[i] = boxes[i - 1]

    # step 9: padding + clamp
    padded = []
    for x1, y1, x2, y2 in boxes:
        if (x2 - x1) <= 0.4 * w:
            x1 = x1 - 0.05 * (x2 - x1)
            x2 = x2 + 0.05 * (x2 - x1)
        if (y2 - y1) <= 0.4 * h:
            y1 = y1 - 0.05 * (y2 - y1)
            y2 = y2 + 0.05 * (y2 - y1)
        padded.append(
            (int(max(0, x1)), int(max(0, y1)),
             int(min(w, x2)), int(min(h, y2)))
        )
    boxes = padded

    # step 10: clip-union overwrite
    if clip_union:
        arr = np.asarray(boxes)
        x1, y1 = arr[:, 0].min(), arr[:, 1].min()
        x2, y2 = arr[:, 2].max(), arr[:, 3].max()
        if (x2 - x1) * (y2 - y1) < 0.01 * w * h:
            x1, y1 = int(0.25 * w), int(0.25 * h)
            x2, y2 = int(0.75 * w), int(0.75 * h)
        boxes = [(int(x1), int(y1), int(x2), int(y2))] * n
    return boxes


def boxes_to_labels(boxes: Sequence[Tuple[int, int, int, int]]) -> List:
    """Per-frame label records in the reference JSON schema."""
    return [
        {
            "labels": [
                {
                    "box2d": {"x1": x1, "y1": y1, "x2": x2, "y2": y2},
                    "gt_annotation": "union",
                }
            ]
        }
        for (x1, y1, x2, y2) in boxes
    ]


def write_bbox_json(
    path: str, per_video: Dict[str, Sequence[Tuple[int, int, int, int]]]
) -> None:
    """Merged Unsupervised_BB_<ds>_<split>.json."""
    payload = {
        vid: boxes_to_labels(boxes) for vid, boxes in per_video.items()
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


def bbox_area_ratio(
    boxes: Sequence[Tuple[int, int, int, int]], h: int, w: int
) -> float:
    """Mean fraction of frame area covered (video_BB_ratio.py:152-157)."""
    areas = [
        (x2 - x1) * (y2 - y1) / float(h * w) for x1, y1, x2, y2 in boxes
    ]
    return float(np.mean(areas)) if areas else 0.0
