"""Motion-boundary magnitude maps from optical flow.

Counterpart of mofo_tpu/factory/motion_maps.py. Behavioral parity with
scripts/motion_sts.py:5-60 and the sliding-window loop in
scripts/data/motion_map_creator.py:121-242:
  - convolve each flow image with the Sobel-like mx/my kernels
  - sum boundaries over a temporal window (ws=8; 4 for Kinetics)
  - magnitude via cartesian->polar
  - zero an 8-px border
  - block-mean downsample to a size x size grid

Two implementations: a numpy transcription (host, per window; copies of
the JAX package's :29-98, which the factory CLI runs) and tensor versions
(motion_boundary, motion_sts: the counterparts of motion_boundary_jax and
motion_sts_jax, :105-132) that run on the device of their input.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MX = np.array([[-1, 0, 1], [-1, 0, 1], [-1, 0, 1]], dtype=np.float64)
MY = np.array([[-1, -1, -1], [0, 0, 0], [1, 1, 1]], dtype=np.float64)


def compute_motion_boundary_np(flow_clip: Sequence[np.ndarray]):
    """scripts/motion_sts.py:5-27 transcription (scipy reflect-mode
    convolution, which flips the kernel)."""
    from scipy import ndimage

    mb_x = 0.0
    mb_y = 0.0
    for flow_img in flow_clip:
        mb_x = mb_x + ndimage.convolve(flow_img, MX)
        mb_y = mb_y + ndimage.convolve(flow_img, MY)
    return mb_x, mb_y


def zero_boundary_np(mag: np.ndarray, border: int = 8) -> np.ndarray:
    mag = mag.copy()
    mag[:border, :] = 0
    mag[:, :border] = 0
    mag[-border:, :] = 0
    mag[:, -border:] = 0
    return mag


def downsample_np(mag: np.ndarray, size: int, input_size: int) -> np.ndarray:
    block = input_size // size
    out = np.zeros((size, size))
    for i in range(size):
        for j in range(size):
            out[i, j] = mag[
                i * block:(i + 1) * block, j * block:(j + 1) * block
            ].mean()
    return out


def motion_sts_np(
    flow_clip: Sequence[np.ndarray], size: int, input_size: int
) -> np.ndarray:
    """Full motion_sts (scripts/motion_sts.py:54-60): per-window motion
    magnitude downsampled to (size, size)."""
    import cv2

    mb_x, mb_y = compute_motion_boundary_np(flow_clip)
    mag, _ = cv2.cartToPolar(
        mb_x.astype(np.float64), mb_y.astype(np.float64),
        angleInDegrees=True,
    )
    return downsample_np(mag, size, input_size)


def motion_magnitude_frames_np(
    flow_frames: Sequence[np.ndarray], window: int = 8
) -> List[np.ndarray]:
    """Sliding-window magnitude per frame (motion_map_creator.py:121-242):
    frame i's map is the boundary sum over flow[i - w//2 : i + w//2],
    border-zeroed, normalized to [0, 255]."""
    n = len(flow_frames)
    out = []
    half = window // 2
    for i in range(n):
        lo = max(0, i - half)
        hi = min(n, i + half)
        mb_x, mb_y = compute_motion_boundary_np(flow_frames[lo:hi])
        mag = np.sqrt(mb_x**2 + mb_y**2)
        mag = zero_boundary_np(mag)
        peak = mag.max()
        if peak > 0:
            mag = mag / peak * 255.0
        out.append(mag.astype(np.uint8))
    return out


# ---------------------------------------------------------------------------
# Tensor versions
# ---------------------------------------------------------------------------


def _conv3x3_edge(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """scipy.ndimage.convolve parity on (T, H, W): the kernel flipped, the
    border padded by repeating the edge (scipy's 'reflect', numpy's
    'symmetric' at width 1: torch's 'replicate', not its 'reflect'), and the
    nine taps as shifted multiply-adds, so that no TF32 setting of a
    convolution library changes the sum."""
    kf = np.flip(k)
    H, W = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    out = torch.zeros_like(x)
    for a in range(3):
        for b in range(3):
            out = out + float(kf[a, b]) * xp[:, a:a + H, b:b + W]
    return out


def motion_boundary(flow: torch.Tensor) -> torch.Tensor:
    """flow: (T, H, W) single-component flow images -> summed |boundary|
    components (2, H, W)."""
    dx = _conv3x3_edge(flow, MX).sum(0)
    dy = _conv3x3_edge(flow, MY).sum(0)
    return torch.stack([dx, dy])


def motion_sts(flow: torch.Tensor, size: int, input_size: int
               ) -> torch.Tensor:
    """flow (T, H, W) -> the (size, size) block-mean motion magnitude."""
    mb = motion_boundary(flow)
    mag = torch.sqrt(mb[0] ** 2 + mb[1] ** 2)
    block = input_size // size
    mag = mag[: size * block, : size * block]
    return mag.reshape(size, block, size, block).mean(dim=(1, 3))
