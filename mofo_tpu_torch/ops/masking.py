"""Tube masking and motion-aware (bounding-box-biased) tube masking.

Counterpart of mofo_tpu/ops/masking.py (its docstring records the reference
behaviour and the bug_compat quirks). Every mask has exactly
int(mask_ratio * patches_per_frame) masked patches per temporal row, which
is what lets the encoder drop masked tokens with a fixed-size gather.

Random functions take a torch.Generator, and optionally the uniforms
themselves (`scores`, `r1`/`r2`): torch and JAX draw different numbers
from one seed, so the tests hand both packages the same draws.

TubeMaskingGeneratorNumpy and MotionTubeMaskingGeneratorNumpy are host
twins of the reference generators (masking_generator.py:3-24, :46-77):
they draw from the global np.random in the reference's call order, so a
np.random.seed gives the reference's masks bit for bit (the parity curve
of tools/parity_artifact.py).

Box convention: (x1, y1, x2, y2) in pixels, x = column, y = row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mofo_tpu_torch.parallel import ddp


def num_masked_per_frame(patches_per_frame: int, mask_ratio: float) -> int:
    """int(mask_ratio * patches_per_frame), reference masking_generator.py:8."""
    return int(mask_ratio * patches_per_frame)


def _uniform(shape, generator, device) -> torch.Tensor:
    """Per-sample uniforms (batch, ...); in a data-parallel step the global
    batch's, this rank's rows (parallel.ddp.per_sample)."""
    return ddp.per_sample(
        lambda s: torch.rand(s, generator=generator, device=device), shape)


def _rank_small(keys: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of keys[i] in the ascending stable sort of the
    last axis (argsort of a stable argsort)."""
    order = torch.argsort(keys, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _tile_frames(frame_mask: torch.Tensor, temporal_positions: int):
    B, ppf = frame_mask.shape
    return frame_mask[:, None, :].expand(B, temporal_positions, ppf).reshape(
        B, temporal_positions * ppf
    )


def tube_mask(
    batch: int,
    *,
    temporal_positions: int = 8,
    patches_per_frame: int = 196,
    mask_ratio: float = 0.9,
    generator: Optional[torch.Generator] = None,
    scores: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Random tube mask, bool (batch, temporal_positions * ppf), True =
    masked: the n_mask patches with the smallest scores, the same spatial
    pattern at every timestep. `scores` (batch, ppf) replaces the draw."""
    n_mask = num_masked_per_frame(patches_per_frame, mask_ratio)
    if scores is None:
        scores = _uniform((batch, patches_per_frame), generator, device)
    frame_mask = _rank_small(scores) < n_mask
    return _tile_frames(frame_mask, temporal_positions)


def box_to_patch_map(
    boxes: torch.Tensor,
    *,
    patches_per_side: int = 14,
    patch_size: int = 16,
    bug_compat: bool = False,
    edge: str = "inclusive",
) -> torch.Tensor:
    """Rasterize pixel boxes (..., 4) onto the patch grid: bool
    (..., patches_per_side**2), True where the patch touches the box, in
    row-major patch order. bug_compat reproduces the reference's
    axis-swapped cross test; edge is 'inclusive' (the mask generator's
    comparisons) or 'paint' (half-open pixel ranges)."""
    P, s = patches_per_side, patch_size
    j = torch.arange(P, device=boxes.device)
    row_lo = (j * s)[:, None]
    row_hi = (j * s + s)[:, None]
    col_lo = (j * s)[None, :]
    col_hi = (j * s + s)[None, :]
    x1, y1, x2, y2 = (boxes[..., c:c + 1, None] for c in range(4))

    if bug_compat:
        row_disjoint = (x1 > row_hi) | (x2 < row_lo)
        col_disjoint = (y1 > col_hi) | (y2 < col_lo)
        inside = ~(row_disjoint & col_disjoint)
    elif edge == "inclusive":
        x_overlap = (x1 <= col_hi) & (x2 >= col_lo)
        y_overlap = (y1 <= row_hi) & (y2 >= row_lo)
        inside = x_overlap & y_overlap & (x2 > x1) & (y2 > y1)
    elif edge == "paint":
        inside = (x1 < col_hi) & (x2 > col_lo) & (y1 < row_hi) & (y2 > row_lo)
    else:
        raise ValueError(f"unknown edge mode: {edge}")
    return inside.reshape(boxes.shape[:-1] + (P * P,))


def _rank_by_score(scores: torch.Tensor, candidates: torch.Tensor):
    """Rank of each position among `candidates` ordered by `scores`
    (non-candidates rank last)."""
    return _rank_small(torch.where(candidates, scores, torch.inf))


def motion_tube_mask(
    boxes: torch.Tensor,
    *,
    temporal_positions: int = 8,
    patches_per_side: int = 14,
    patch_size: int = 16,
    mask_ratio: float = 0.9,
    mask_ratio_bb: float = 0.75,
    bug_compat: bool = False,
    box_reduce: str = "first",
    generator: Optional[torch.Generator] = None,
    r1: Optional[torch.Tensor] = None,
    r2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Motion-aware tube mask biased into the bounding box.

    boxes: (B, T, 4) per-frame pixel boxes. Returns bool (B,
    temporal_positions * ppf) with exactly int(mask_ratio * ppf) masked per
    row: min(n_mask, int(n_inside * mask_ratio_bb)) in-box patches chosen
    by r1, the rest of the budget filled from the remaining pool by r2.
    box_reduce: 'first' frame's box or the 'union' over frames.
    """
    B = boxes.shape[0]
    ppf = patches_per_side * patches_per_side
    n_mask = num_masked_per_frame(ppf, mask_ratio)

    if box_reduce == "first":
        box = boxes[:, 0, :]
    elif box_reduce == "union":
        box = torch.cat(
            [boxes[..., 0:2].amin(dim=1), boxes[..., 2:4].amax(dim=1)], dim=-1
        )
    else:
        raise ValueError(f"unknown box_reduce: {box_reduce}")

    inside = box_to_patch_map(
        box, patches_per_side=patches_per_side, patch_size=patch_size,
        bug_compat=bug_compat,
    )
    n_inside = inside.sum(dim=-1)
    cap = torch.clamp(
        (n_inside.to(torch.float32) * mask_ratio_bb).to(torch.int32),
        max=n_mask,
    )
    if r1 is None:
        r1 = _uniform((B, ppf), generator, boxes.device)
    if r2 is None:
        r2 = _uniform((B, ppf), generator, boxes.device)

    selected_bb = inside & (_rank_by_score(r1, inside) < cap[:, None])
    if bug_compat:
        # the reference fills only from patch indices 0..n_mask-1
        low_idx = torch.arange(ppf, device=boxes.device) < n_mask
        pool = low_idx[None, :] & ~selected_bb
    else:
        pool = ~selected_bb
    n_fill = n_mask - cap
    selected_fill = pool & (_rank_by_score(r2, pool) < n_fill[:, None])
    return _tile_frames(selected_bb | selected_fill, temporal_positions)


def tokens_in_box(
    boxes: torch.Tensor,
    token_idx: torch.Tensor,
    *,
    tubelet_size: int = 2,
    patches_per_side: int = 14,
    patch_size: int = 16,
) -> torch.Tensor:
    """In-box test evaluated at token indices. boxes (B, T, 4), token_idx
    (B, M). Returns bool (B, M): token (t, j, k) is in-box iff any of its
    tubelet frames' boxes paint-overlaps patch (j, k). Each token's box is
    picked with an exact gather (the JAX version uses a one-hot matmul
    with the same result)."""
    P, s = patches_per_side, patch_size
    T = boxes.shape[1]
    t = T // tubelet_size
    t_idx = token_idx // (P * P)
    rem = token_idx % (P * P)
    row_lo = ((rem // P) * s).to(torch.float32)
    col_lo = ((rem % P) * s).to(torch.float32)
    row_hi, col_hi = row_lo + s, col_lo + s
    gather_idx = t_idx[..., None].expand(*t_idx.shape, 4)
    in_any = torch.zeros(token_idx.shape, dtype=torch.bool,
                         device=token_idx.device)
    for r in range(tubelet_size):
        frame_boxes = boxes[:, r::tubelet_size][:, :t].to(torch.float32)
        sel = torch.gather(frame_boxes, 1, gather_idx)  # (B, M, 4)
        x1, y1, x2, y2 = sel.unbind(-1)
        in_any |= (x1 < col_hi) & (x2 > col_lo) & (y1 < row_hi) & (y2 > row_lo)
    return in_any


def gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tokens (B, N, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(
        tokens, 1, idx[..., None].expand(*idx.shape, tokens.shape[-1])
    )


def mask_to_indices(
    mask: torch.Tensor, num_masked: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a boolean mask (B, N) into (visible_idx, masked_idx) of shapes
    (B, N - num_masked) and (B, num_masked), each in ascending position
    order (the reference's x[~mask] / x[mask]). Every row must hold exactly
    num_masked True entries."""
    n = mask.shape[-1]
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    return order[:, : n - num_masked], order[:, n - num_masked:]


class TubeMaskingGeneratorNumpy:
    """One np.random.shuffle of a 0/1 row of patches_per_frame entries per
    call, tiled over the frames (reference TubeMaskingGenerator)."""

    def __init__(self, input_size, mask_ratio):
        self.frames, self.height, self.width = input_size
        self.patches_per_frame = self.height * self.width
        self.num_masks_per_frame = int(mask_ratio * self.patches_per_frame)
        self.total_patches = self.frames * self.patches_per_frame
        self.total_masks = self.frames * self.num_masks_per_frame

    def __call__(self) -> np.ndarray:
        row = np.hstack([
            np.zeros(self.patches_per_frame - self.num_masks_per_frame),
            np.ones(self.num_masks_per_frame),
        ])
        np.random.shuffle(row)
        return np.tile(row, (self.frames, 1)).flatten()


class MotionTubeMaskingGeneratorNumpy:
    """The box-biased generator (reference TubeMaskingGenerator_BB): a
    shuffle of the in-box patch list, then a shuffle of the fill pool.
    bug_compat=True keeps the reference's first-frame box, crossed axes
    and fill pool of indices below num_masks_per_frame; False tests the
    box itself and fills from every other patch."""

    def __init__(self, input_size, mask_ratio, mask_ratio_bb,
                 patch_size: int = 16, bug_compat: bool = True):
        self.frames, self.height, self.width = input_size
        self.patches_per_frame = self.height * self.width
        self.num_masks_per_frame = int(mask_ratio * self.patches_per_frame)
        self.mask_ratio_bb = mask_ratio_bb
        self.patch_size = patch_size
        self.bug_compat = bug_compat

    def _inside_indices(self, box) -> list:
        s = self.patch_size
        x1, y1, x2, y2 = (float(v) for v in box)
        idx = []
        for j in range(self.height):
            for k in range(self.width):
                row_lo, row_hi = j * s, j * s + s
                col_lo, col_hi = k * s, k * s + s
                if self.bug_compat:
                    row_dis = x1 > row_hi or x2 < row_lo
                    col_dis = y1 > col_hi or y2 < col_lo
                    hit = not (row_dis and col_dis)
                else:
                    hit = (x2 > x1 and y2 > y1 and x1 <= col_hi
                           and x2 >= col_lo and y1 <= row_hi
                           and y2 >= row_lo)
                if hit:
                    idx.append(j * self.width + k)
        return idx

    def __call__(self, boxes: np.ndarray) -> np.ndarray:
        inside = self._inside_indices(boxes[0])
        frame = np.zeros(self.patches_per_frame)
        np.random.shuffle(inside)
        cap = min(self.num_masks_per_frame,
                  int(len(inside) * self.mask_ratio_bb))
        selected = inside[:cap]
        frame[selected] = 1
        n_fill = self.num_masks_per_frame - len(selected)
        pool = np.setdiff1d(np.arange(
            self.num_masks_per_frame if self.bug_compat
            else self.patches_per_frame), selected)
        np.random.shuffle(pool)
        frame[pool[:n_fill]] = 1
        return np.tile(frame, (self.frames, 1)).flatten()
