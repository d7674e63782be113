"""Mixup / CutMix.

Counterpart of mofo_tpu/ops/mixup.py (reference mixup.py, timm-derived):
  - the partner of sample i is the batch flipped along dim 0;
  - lam ~ Beta(alpha, alpha); with mixup and cutmix both active a
    switch_prob coin picks cutmix; a mix_prob miss sets lam = 1;
  - the cutmix box is a square of side ratio sqrt(1 - lam) around a uniform
    centre, clipped to the image, and lam is corrected to 1 - box area /
    image area (correct_lam), or a cutmix_minmax box;
  - modes 'batch' (one draw), 'elem' (one per sample), 'pair' (sample i and
    its partner share one);
  - targets: smoothed one-hot, y1 * lam + y2 * (1 - lam).

lam, the switch coin and the box are scalar or per-sample draws: they come
from an explicit np.random.Generator on the host, as timm's Mixup draws
them with np.random (torch.distributions.Beta takes no generator). The
blend runs on the clips' device, the cutmix box as a coordinate mask.
Clips are (B, T, H, W, C) channel-last. `params` injects the raw draws, so
tests can hand both packages the same ones.

Inside a data-parallel step (parallel.ddp.global_draws) each rank's B rows
are rows r * B .. r * B + B - 1 of a global batch of W * B: the draws are
made (or injected) at the global count and the rank keeps its rows, and
the partner of global row g, W * B - 1 - g, is rank W-1-r's rows flipped
(parallel.ddp.exchange_flipped), for the clips and the one-hot targets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mofo_tpu_torch.parallel import ddp


def one_hot_smooth(targets: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    """One-hot with label smoothing (mixup.py:17-25), f32."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(targets.long(), num_classes).float() * (on - off) + off


@dataclasses.dataclass
class MixupParams:
    """The raw draws of one call, `count` of each (1 in 'batch' mode, B // 2
    in 'pair', B in 'elem'): lam after the mix_prob coin, the cutmix coin,
    and the box rows [yl, yh) and columns [xl, xh)."""

    lam: np.ndarray
    use_cutmix: np.ndarray
    box: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass(frozen=True)
class Mixup:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    prob: float = 1.0
    switch_prob: float = 0.5
    mode: str = "batch"  # batch | pair | elem
    correct_lam: bool = True
    label_smoothing: float = 0.1
    num_classes: int = 1000

    @property
    def enabled(self) -> bool:
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0
                or self.cutmix_minmax is not None)

    def count(self, batch: int) -> int:
        return {"batch": 1, "pair": batch // 2}.get(self.mode, batch)

    def sample(self, rng: np.random.Generator, count: int, h: int,
               w: int) -> MixupParams:
        """lam, the cutmix coin (mixup.py:120-156) and the box
        (mixup.py:30-76), drawn on the host."""
        cutmix_alpha = (1.0 if self.cutmix_minmax is not None
                        else self.cutmix_alpha)
        if self.mixup_alpha > 0 and cutmix_alpha > 0:
            use_cutmix = rng.random(count) < self.switch_prob
            lam_mix = np.where(
                use_cutmix, rng.beta(cutmix_alpha, cutmix_alpha, count),
                rng.beta(self.mixup_alpha, self.mixup_alpha, count))
        elif self.mixup_alpha > 0:
            use_cutmix = np.zeros(count, bool)
            lam_mix = rng.beta(self.mixup_alpha, self.mixup_alpha, count)
        elif cutmix_alpha > 0:
            use_cutmix = np.ones(count, bool)
            lam_mix = rng.beta(cutmix_alpha, cutmix_alpha, count)
        else:
            raise ValueError("mixup or cutmix must be active")
        apply = rng.random(count) < self.prob
        lam = np.where(apply, lam_mix, 1.0).astype(np.float32)
        if self.cutmix_minmax is not None:
            lo, hi = self.cutmix_minmax
            cut_h = rng.integers(int(h * lo), int(h * hi), count)
            cut_w = rng.integers(int(w * lo), int(w * hi), count)
            yl = rng.integers(0, h - cut_h, count)
            xl = rng.integers(0, w - cut_w, count)
            box = (yl, yl + cut_h, xl, xl + cut_w)
        else:
            ratio = np.sqrt(np.float32(1.0) - lam)
            cut_h = (h * ratio).astype(np.int32)
            cut_w = (w * ratio).astype(np.int32)
            cy = rng.integers(0, h, count)
            cx = rng.integers(0, w, count)
            box = (np.clip(cy - cut_h // 2, 0, h),
                   np.clip(cy + cut_h // 2, 0, h),
                   np.clip(cx - cut_w // 2, 0, w),
                   np.clip(cx + cut_w // 2, 0, w))
        return MixupParams(lam, use_cutmix, box)

    def _per_sample(self, p: MixupParams, B: int, H: int, W: int):
        """(lam (B,) f32, cutmix (B,) bool, box (4, B) int) after the lam
        correction and the mode's expansion (mofo_tpu/ops/mixup.py:170-199).
        """
        lam = np.asarray(p.lam, np.float32)
        use_cutmix = np.asarray(p.use_cutmix, bool)
        box = np.stack([np.asarray(c, np.int64) for c in p.box])
        # a mix_prob miss forces lam = 1 before any cutmix correction
        no_mix = lam == 1.0
        if self.correct_lam or self.cutmix_minmax is not None:
            area = ((box[1] - box[0]) * (box[3] - box[2])).astype(np.float32)
            lam_cut = np.float32(1.0) - area / np.float32(H * W)
        else:
            lam_cut = lam
        lam = np.where(use_cutmix & ~no_mix, lam_cut, lam).astype(np.float32)
        cut = use_cutmix & ~no_mix
        if self.mode == "pair":
            lam = np.concatenate([lam, lam[::-1]])
            cut = np.concatenate([cut, cut[::-1]])
            use_cutmix = np.concatenate([use_cutmix, use_cutmix[::-1]])
            box = np.concatenate([box, box[:, ::-1]], axis=1)
        elif self.mode == "batch":
            lam, cut, use_cutmix = (np.broadcast_to(a, (B,))
                                    for a in (lam, cut, use_cutmix))
            box = np.broadcast_to(box, (4, B))
        return lam, use_cutmix, cut, box

    def __call__(self, clips: torch.Tensor, targets: torch.Tensor,
                 rng: Optional[np.random.Generator] = None,
                 params: Optional[MixupParams] = None):
        """clips (B, T, H, W, C), targets (B,) int labels. Returns (mixed
        clips, soft targets (B, num_classes) f32). The draws come from
        `rng` or, given, from `params` (at the global count in a
        data-parallel step)."""
        B, T, H, W, C = clips.shape
        if not self.enabled:
            return clips, one_hot_smooth(targets, self.num_classes,
                                         self.label_smoothing)
        layout = ddp.layout()
        if layout is not None and layout[2] != 1:
            raise ValueError("mixup acts on one microbatch: global_draws "
                             f"with k={layout[2]}")
        rank, world = (0, 1) if layout is None else layout[:2]
        if params is None:
            if rng is None:
                raise ValueError("Mixup draws from an explicit "
                                 "np.random.Generator; pass rng or params")
            params = self.sample(rng, self.count(world * B), H, W)
        lam, use_cutmix, cut, box = self._per_sample(params, world * B, H, W)
        if world > 1:
            rows = ddp.global_rows(rank, world, B)
            lam, use_cutmix, cut = lam[rows], use_cutmix[rows], cut[rows]
            box = box[:, rows]
        group = ddp.batch_group()
        flipped = (lambda t: ddp.exchange_flipped(t, group)) if world > 1 \
            else (lambda t: torch.flip(t, dims=[0]))
        dev = clips.device
        lam_t = torch.from_numpy(np.ascontiguousarray(lam)).to(dev)
        yl, yh, xl, xh = (torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                          [:, None, None] for c in box)
        rows = torch.arange(H, device=dev)[None, :, None]
        cols = torch.arange(W, device=dev)[None, None, :]
        inside = (rows >= yl) & (rows < yh) & (cols >= xl) & (cols < xh)
        inside = inside & torch.from_numpy(
            np.ascontiguousarray(cut)).to(dev)[:, None, None]

        partner = flipped(clips)
        lam_b = lam_t[:, None, None, None, None]
        blended = clips * lam_b + partner * (1.0 - lam_b)
        cutmixed = torch.where(inside[:, None, :, :, None], partner, clips)
        use_cut_b = torch.from_numpy(np.ascontiguousarray(use_cutmix)).to(
            dev)[:, None, None, None, None]
        mixed = torch.where(use_cut_b, cutmixed, blended)

        y1 = one_hot_smooth(targets, self.num_classes, self.label_smoothing)
        y2 = flipped(y1)
        soft = y1 * lam_t[:, None] + y2 * (1.0 - lam_t[:, None])
        return mixed.to(clips.dtype), soft
