"""Optical flow for the offline motion-map factory.

Counterpart of mofo_tpu/factory/flow.py. The reference shells out to the
denseflow TV-L1 CUDA binary (scripts/data/motion_map_creator.py:75); here:

  - tvl1_flow / tvl1_flow_batch: TV-L1 (Zach et al. '07 / Sanchez '13) as
    tensor ops on an explicit device (CUDA unless the caller asks for the
    CPU): pyramidal warping and primal-dual iterations, every frame pair of
    a batch carried through every level together (the JAX version's vmap,
    :191-195). The JAX function is XLA, not a Pallas kernel, so this is
    plain PyTorch with JAX's operation order: an antialiased bilinear
    pyramid (jax.image.resize's weights, antialiased when it downsamples,
    applied tap by tap), the min-16 level clamp, a clamp-floor-gather warp,
    the thresholding as written. Every op rounds alike on the card and the
    CPU (the square root is taken in f64), so the two give the same flow.
  - dis_flow / farneback_flow: OpenCV on the host (cv2 has no contrib
    TV-L1 here).

Flow output convention matches denseflow: (H, W, 2) float32 (dx, dy), which
motion_maps.py then turns into motion-boundary magnitude maps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mofo_tpu_torch.core.device import DeviceLike, resolve_device


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """(P, H, W, 3) -> (P, H, W), the weights summed left to right."""
    if img.ndim == 4:
        return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return img


def _taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """jax.image.resize's "bilinear" weights from n_in to n_out samples
    (jax/_src/image/scale.py compute_weight_mat, in f32 as there): a
    triangle kernel at half-pixel centres, widened by the scale when it
    shrinks (antialiasing), normalized per output sample. Returned as taps:
    (K, n_out) input indices and weights, K the widest support."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    w[:, (sample < -0.5) | (sample > n_in - 0.5)] = 0
    k = int((w != 0).sum(axis=0).max())
    idx = np.zeros((k, n_out), np.int64)
    wt = np.zeros((k, n_out), np.float32)
    for i in range(n_out):
        js = np.flatnonzero(w[:, i])
        idx[:len(js), i] = js
        wt[:len(js), i] = w[js, i]
    return idx, wt


def _resize2d(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(P, H, W) resized as jax.image.resize(..., "bilinear") does (rows,
    then columns), each output a sum over its taps in a fixed order of
    elementwise products: the same roundings on every device, which
    F.interpolate's antialiased kernels do not give (the card and the CPU
    differ there, and TV-L1's thresholds carry the difference on)."""
    for dim, n_out in ((1, hw[0]), (2, hw[1])):
        n_in = x.shape[dim]
        if n_in == n_out:  # the weights are the identity
            continue
        idx, wt = _taps(n_in, n_out)
        idx = torch.from_numpy(idx).to(x.device)
        wt = torch.from_numpy(wt).to(x.device)
        view = (n_out, 1) if dim == 1 else (n_out,)
        out = x.index_select(dim, idx[0]) * wt[0].view(view)
        for j in range(1, len(idx)):
            out = out + x.index_select(dim, idx[j]) * wt[j].view(view)
        x = out
    return x


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device. The card's
    f32 sqrt rounds the last bit of some results otherwise than the CPU's
    (chip_smoke.op_roundings); an f64 root rounded to f32 is the correctly
    rounded f32 root on both."""
    return torch.sqrt(x.double()).float()


def _grad(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gx = F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))
    gy = F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    dx = px - F.pad(px[..., :, :-1], (1, 0))
    dy = py - F.pad(py[..., :-1, :], (0, 0, 1, 0))
    return dx + dy


def _warp(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """Bilinear samples of imgs (P, K, H, W) at (x + u, y + v), u and v
    (P, H, W): the coordinates clamped to the image, floored, and the four
    neighbours gathered (grid_sample would renormalize the coordinates and
    round differently)."""
    P, K, H, W = imgs.shape
    ys = torch.arange(H, dtype=torch.float32, device=u.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=u.device)
    sx = torch.clamp(xs + u, 0.0, W - 1.0)
    sy = torch.clamp(ys + v, 0.0, H - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    flat = imgs.reshape(P, K, H * W)

    def at(yy, xx):
        idx = (yy.long() * W + xx.long()).reshape(P, 1, H * W)
        return torch.gather(flat, 2, idx.expand(P, K, H * W)).reshape(
            P, K, H, W)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _tvl1_level(I0, I1, u, v, *, tau: float, lam: float, theta: float,
                n_warps: int, n_iters: int):
    """One pyramid level of (P, H, W) images from the flow (u, v)."""
    lt = lam * theta
    taut = tau / theta
    I1x, I1y = _grad(I1)
    stack = torch.stack([I1, I1x, I1y], dim=1)
    p11 = p12 = p21 = p22 = torch.zeros_like(u)
    for _ in range(n_warps):
        I1w, I1wx, I1wy = _warp(stack, u, v).unbind(1)
        grad_sq = I1wx ** 2 + I1wy ** 2 + 1e-9
        rho_c = I1w - I1wx * u - I1wy * v - I0
        # the thresholds and the clamped steps do not change within a warp
        lo = -lt * grad_sq
        hi = lt * grad_sq
        lx, ly = lt * I1wx, lt * I1wy
        nlx, nly = -lx, -ly
        for _ in range(n_iters):
            rho = rho_c + I1wx * u + I1wy * v
            # thresholding (pointwise TV-L1 data step)
            below, above = rho < lo, rho > hi
            nrho = -rho
            d1 = torch.where(below, lx, torch.where(
                above, nlx, nrho * I1wx / grad_sq))
            d2 = torch.where(below, ly, torch.where(
                above, nly, nrho * I1wy / grad_sq))
            v1 = u + d1
            v2 = v + d2
            # dual update + flow from divergence
            u = v1 + theta * _div(p11, p12)
            v = v2 + theta * _div(p21, p22)
            ux, uy = _grad(u)
            vx, vy = _grad(v)
            ng1 = 1.0 + taut * _sqrt(ux ** 2 + uy ** 2)
            ng2 = 1.0 + taut * _sqrt(vx ** 2 + vy ** 2)
            p11 = (p11 + taut * ux) / ng1
            p12 = (p12 + taut * uy) / ng1
            p21 = (p21 + taut * vx) / ng2
            p22 = (p22 + taut * vy) / ng2
    return u, v


def _as_float(frames, device: torch.device) -> torch.Tensor:
    x = frames if isinstance(frames, torch.Tensor) else torch.as_tensor(
        np.asarray(frames))
    return x.to(device=device, dtype=torch.float32)


def _pairs_flow(prev: torch.Tensor, nxt: torch.Tensor, *, tau: float,
                lam: float, theta: float, n_scales: int, n_warps: int,
                n_iters: int) -> torch.Tensor:
    """(P, H, W[, 3]) f32 pairs on one device -> (P, H, W, 2)."""
    # 255 as a tensor: CUDA divides by a host scalar through its reciprocal
    scale = prev.new_tensor(255.0)
    I0 = _grayscale(prev) / scale
    I1 = _grayscale(nxt) / scale
    P, H, W = I0.shape
    shapes = []
    for s in range(n_scales):
        f = 0.5 ** s
        shapes.append((max(int(round(H * f)), 16),
                       max(int(round(W * f)), 16)))
    u = I0.new_zeros((P, *shapes[-1]))
    v = I0.new_zeros((P, *shapes[-1]))
    for s in reversed(range(n_scales)):
        hw = shapes[s]
        if tuple(u.shape[1:]) != hw:
            scale_x = hw[1] / u.shape[2]
            scale_y = hw[0] / u.shape[1]
            u = _resize2d(u, hw) * scale_x
            v = _resize2d(v, hw) * scale_y
        u, v = _tvl1_level(_resize2d(I0, hw), _resize2d(I1, hw), u, v,
                           tau=tau, lam=lam, theta=theta, n_warps=n_warps,
                           n_iters=n_iters)
    return torch.stack([u, v], dim=-1)


@torch.no_grad()
def tvl1_flow(prev, nxt, *, tau: float = 0.25, lam: float = 0.15,
              theta: float = 0.3, n_scales: int = 4, n_warps: int = 8,
              n_iters: int = 100, device: DeviceLike = None) -> torch.Tensor:
    """TV-L1 optical flow. prev / nxt: (H, W[, 3]) uint8 or float frames
    (numpy or torch), or (P, H, W[, 3]) pairs (a 3-D input is one colour
    frame when its last axis is 3, else P grey pairs). Returns (H, W, 2) or
    (P, H, W, 2) float32 (dx, dy) on `device`, which defaults to CUDA and
    raises without a GPU."""
    dev = resolve_device(device)
    a, b = _as_float(prev, dev), _as_float(nxt, dev)
    single = a.ndim == 2 or (a.ndim == 3 and a.shape[-1] == 3)
    if single:
        a, b = a[None], b[None]
    out = _pairs_flow(a, b, tau=tau, lam=lam, theta=theta, n_scales=n_scales,
                      n_warps=n_warps, n_iters=n_iters)
    return out[0] if single else out


def tvl1_flow_batch(frames, *, device: DeviceLike = None, **kw
                    ) -> torch.Tensor:
    """Consecutive-pair flow for a clip (T, H, W[, 3]) -> (T-1, H, W, 2),
    all pairs in one batched call."""
    dev = resolve_device(device)
    x = _as_float(frames, dev)
    return tvl1_flow(x[:-1], x[1:], device=dev, **kw)


# ---------------------------------------------------------------------------
# OpenCV host fallbacks
# ---------------------------------------------------------------------------


def dis_flow(prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    import cv2

    g0 = cv2.cvtColor(prev, cv2.COLOR_RGB2GRAY) if prev.ndim == 3 else prev
    g1 = cv2.cvtColor(nxt, cv2.COLOR_RGB2GRAY) if nxt.ndim == 3 else nxt
    dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    return dis.calc(g0, g1, None)


def farneback_flow(prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    import cv2

    g0 = cv2.cvtColor(prev, cv2.COLOR_RGB2GRAY) if prev.ndim == 3 else prev
    g1 = cv2.cvtColor(nxt, cv2.COLOR_RGB2GRAY) if nxt.ndim == 3 else nxt
    return cv2.calcOpticalFlowFarneback(
        g0, g1, None, 0.5, 3, 15, 3, 5, 1.2, 0
    )


def compute_flow(prev: np.ndarray, nxt: np.ndarray, backend: str = "tvl1",
                 device: DeviceLike = None) -> np.ndarray:
    """One pair's (H, W, 2) flow as numpy: TV-L1 on `device` (CUDA unless
    the caller asks for the CPU), DIS or Farneback on the host."""
    if backend == "tvl1":
        return tvl1_flow(prev, nxt, device=device).cpu().numpy()
    if backend == "dis":
        return dis_flow(prev, nxt)
    if backend == "farneback":
        return farneback_flow(prev, nxt)
    raise ValueError(backend)
