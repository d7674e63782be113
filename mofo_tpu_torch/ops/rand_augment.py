"""RandAugment on batches of clips on the device.

Counterpart of mofo_tpu/ops/rand_augment.py (reference rand_augment.py,
timm-derived, driven by config strings such as 'rand-m7-n4-mstd0.5-inc1',
parsed as rand_augment.py:481-531 parses them):
  - each clip draws num_layers ops uniformly with replacement; each applies
    with probability 0.5;
  - magnitude ~ N(m, mstd) clipped to [0, 10] per op; signed arguments are
    negated at random; the geometric ops draw bilinear or bicubic;
  - one set of arguments applies to every frame of a clip;
  - the level maps, the fill colour 128 and PIL's inverse-affine convention
    of the reference; bicubic is PIL's a = -1 transform kernel with each tap
    clamped to the image (fill 128 outside).

The JAX package runs one clip per vmap lane, where lax.switch becomes a
select over all 15 ops. Here the clips of a layer are grouped by the op they
drew (and, for the geometric ops, by the interpolation): each group is
gathered with index_select, transformed once and written back with
index_copy_, so a clip pays only for its own op and the bicubic taps are
computed only for the clips that drew them. Equalize's histogram is a
bincount over (clip, frame, channel); the JAX package builds it from
equality reductions because a scatter hung the TPU compiler
(mofo_tpu/ops/rand_augment.py:95-133): the LUT is the same.

Clips are (B, T, H, W, C) float32 on [0, 255]. Every op here takes a group
(G, T, H, W, C), per-clip levels and signs (G,) and, for the geometric ops,
whether to sample bicubic.
"""

from __future__ import annotations

import math
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mofo_tpu_torch.ops import image as I

MAX_LEVEL = 10.0
FILL = 128.0

# the lax.switch index space of the JAX package: the
# _RAND_INCREASING_TRANSFORMS list (rand_augment.py:404-420)
TRANSFORMS = (
    "AutoContrast",
    "Equalize",
    "Invert",
    "Rotate",
    "PosterizeIncreasing",
    "SolarizeIncreasing",
    "SolarizeAdd",
    "ColorIncreasing",
    "ContrastIncreasing",
    "BrightnessIncreasing",
    "SharpnessIncreasing",
    "ShearX",
    "ShearY",
    "TranslateXRel",
    "TranslateYRel",
)
GEOMETRIC = frozenset(TRANSFORMS.index(n) for n in (
    "Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel"))
ROTATE = TRANSFORMS.index("Rotate")


def _per_clip(x: torch.Tensor) -> torch.Tensor:
    """(G,) -> (G, 1, 1, 1, 1), to broadcast over (G, T, H, W, C)."""
    return x.reshape(-1, 1, 1, 1, 1)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """PIL's L mode: R * 299/1000 + G * 587/1000 + B * 114/1000."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def _blend(img1, img2, factor):
    """PIL Image.blend (ImageEnhance): img1 + factor * (img2 - img1) on
    [0, 255]."""
    return torch.clamp(img1 + factor * (img2 - img1), 0.0, 255.0)


def _enhance_factor(level, neg):
    # 'increasing': 1 +/- 0.9 * m / 10 (rand_augment.py:212-217)
    return _per_clip(1.0 + neg * (level / MAX_LEVEL) * 0.9)


def _op_autocontrast(img, level, neg, bicubic=False):
    # per frame and channel min/max stretch (PIL cutoff=0)
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    out = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-6))
    return torch.where(hi > lo, torch.clamp(out, 0, 255), img)


def equalize_lut(hist: torch.Tensor, n: int):
    """PIL equalize's LUT per histogram row (..., 256) of n pixels: step =
    (n - hist[-1]) // 255, lut[i] = (cumsum_before(i) + step // 2) // step,
    as f32 operations. Returns (lut, step)."""
    step = torch.floor((n - hist[..., 255]) / 255.0)
    cum_before = torch.cumsum(hist, dim=-1) - hist  # exclusive
    lut = torch.floor((cum_before + torch.floor(step / 2.0)[..., None])
                      / torch.clamp(step, min=1.0)[..., None])
    return torch.clamp(lut, 0, 255), step


def _op_equalize(img, level, neg, bicubic=False):
    # per frame and channel: a (G*T*C, 256) histogram from one bincount
    G, T, H, W, C = img.shape
    q = torch.clamp(torch.round(img), 0, 255).to(torch.int64)
    rows = q.permute(0, 1, 4, 2, 3).reshape(G * T * C, H * W)
    offset = torch.arange(G * T * C, device=img.device)[:, None] * 256
    hist = torch.bincount((rows + offset).flatten(),
                          minlength=G * T * C * 256).reshape(-1, 256)
    lut, step = equalize_lut(hist.to(torch.float32), H * W)
    out = torch.gather(lut, 1, rows).reshape(G, T, C, H, W)
    out = out.permute(0, 1, 3, 4, 2)
    return torch.where(step.reshape(G, T, 1, 1, C) > 0, out, img)


def _op_invert(img, level, neg, bicubic=False):
    return 255.0 - img


def _cubic_weights(t: torch.Tensor):
    """PIL's transform bicubic weights of the four taps at floor-relative
    offsets (-1, 0, 1, 2), t the fractional coordinate: geometry.c's affine
    bicubic uses the a = -1 kernel (Resample.c's resize uses a = -0.5)."""
    a = -1.0

    def k01(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k12(x):  # 1 < |x| < 2
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a

    return k12(1.0 + t), k01(t), k01(1.0 - t), k12(2.0 - t)


def _affine_warp(img: torch.Tensor, matrix, bicubic: bool) -> torch.Tensor:
    """PIL inverse affine per clip: out(x, y) = src(a x + b y + c, d x + e y
    + f), fill 128 outside; matrix: six (G,) tensors. Bilinear, or PIL's
    bicubic (16 taps, clamped to [0, 255] as PIL's uint8 store)."""
    G, T, H, W, C = img.shape
    dev = img.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    a, b, c, d, e, f = (m.to(dev, torch.float32)[:, None, None]
                        for m in matrix)
    src_x = a * xs + b * ys + c  # (G, H, W)
    src_y = d * xs + e * ys + f
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = src_x - x0, src_y - y0
    flat = img.reshape(G, T, H * W, C)

    def sample(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (torch.clamp(yi, 0, H - 1).to(torch.int64) * W
               + torch.clamp(xi, 0, W - 1).to(torch.int64))
        vals = torch.gather(flat, 2, idx.reshape(G, 1, H * W, 1).expand(
            G, T, H * W, C)).reshape(G, T, H, W, C)
        return torch.where(inside[:, None, :, :, None], vals, FILL)

    if not bicubic:
        wxe, wye = wx[:, None, :, :, None], wy[:, None, :, :, None]
        top = sample(y0, x0) * (1 - wxe) + sample(y0, x0 + 1) * wxe
        bot = sample(y0 + 1, x0) * (1 - wxe) + sample(y0 + 1, x0 + 1) * wxe
        return top * (1 - wye) + bot * wye
    wxc = [w[:, None, :, :, None] for w in _cubic_weights(wx)]
    wyc = [w[:, None, :, :, None] for w in _cubic_weights(wy)]
    acc = torch.zeros_like(img)
    for dy, wyk in zip((-1.0, 0.0, 1.0, 2.0), wyc):
        row = torch.zeros_like(img)
        for dx, wxk in zip((-1.0, 0.0, 1.0, 2.0), wxc):
            row = row + sample(y0 + dy, x0 + dx) * wxk
        acc = acc + row * wyk
    return torch.clamp(acc, 0.0, 255.0)


def _op_rotate(img, level, neg, bicubic=False):
    # [-30, 30] degrees, PIL rotates counterclockwise about the centre; the
    # inverse map is src = R^-1 (dst - centre) + centre
    deg = (level / MAX_LEVEL) * 30.0 * neg
    rad = deg * math.pi / 180.0
    H, W = img.shape[2], img.shape[3]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    a, b, d, e = cos, -sin, sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return _affine_warp(img, (a, b, c, d, e, f), bicubic)


def _op_posterize(img, level, neg, bicubic=False):
    bits = 4 - torch.floor(level / MAX_LEVEL * 4.0)
    q = _per_clip(torch.exp2(torch.clamp(8.0 - bits, 0, 8)))
    return torch.floor(torch.clamp(torch.round(img), 0, 255) / q) * q


def _op_solarize(img, level, neg, bicubic=False):
    thresh = _per_clip(256.0 - torch.floor(level / MAX_LEVEL * 256.0))
    return torch.where(img < thresh, img, 255.0 - img)


def _op_solarize_add(img, level, neg, bicubic=False):
    add = _per_clip(torch.floor(level / MAX_LEVEL * 110.0))
    return torch.where(img < 128.0, torch.clamp(img + add, 0, 255), img)


def _op_color(img, level, neg, bicubic=False):
    return _blend(_grayscale(img).expand(img.shape), img,
                  _enhance_factor(level, neg))


def _op_contrast(img, level, neg, bicubic=False):
    # PIL: the rounded mean of the L image, per frame
    mean = torch.floor(torch.floor(_grayscale(img)).mean(
        dim=(2, 3, 4), keepdim=True) + 0.5)
    return _blend(mean.expand(img.shape), img, _enhance_factor(level, neg))


def _op_brightness(img, level, neg, bicubic=False):
    return _blend(torch.zeros_like(img), img, _enhance_factor(level, neg))


def _op_sharpness(img, level, neg, bicubic=False):
    # PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 on the
    # interior; the border keeps its pixels (PIL filter semantics)
    G, T, H, W, C = img.shape
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     device=img.device) / 13.0
    x = img.permute(0, 1, 4, 2, 3).reshape(G * T * C, 1, H, W)
    sm = F.conv2d(x, k[None, None], padding=1).reshape(G, T, C, H, W)
    sm = sm.permute(0, 1, 3, 4, 2)
    interior = torch.zeros(H, W, dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    sm = torch.where(interior[None, None, :, :, None], sm, img)
    return _blend(sm, img, _enhance_factor(level, neg))


def _constant(level, value: float):
    return torch.full_like(level, value)


def _op_shear_x(img, level, neg, bicubic=False):
    v = (level / MAX_LEVEL) * 0.3 * neg
    one, zero = _constant(v, 1.0), _constant(v, 0.0)
    return _affine_warp(img, (one, v, zero, zero, one, zero), bicubic)


def _op_shear_y(img, level, neg, bicubic=False):
    v = (level / MAX_LEVEL) * 0.3 * neg
    one, zero = _constant(v, 1.0), _constant(v, 0.0)
    return _affine_warp(img, (one, zero, zero, v, one, zero), bicubic)


def _op_translate_x(img, level, neg, bicubic=False):
    v = (level / MAX_LEVEL) * 0.45 * neg * img.shape[3]
    one, zero = _constant(v, 1.0), _constant(v, 0.0)
    return _affine_warp(img, (one, zero, v, zero, one, zero), bicubic)


def _op_translate_y(img, level, neg, bicubic=False):
    v = (level / MAX_LEVEL) * 0.45 * neg * img.shape[2]
    one, zero = _constant(v, 1.0), _constant(v, 0.0)
    return _affine_warp(img, (one, zero, zero, zero, one, v), bicubic)


# in TRANSFORMS order; rand_augment_batch reads this name at each call
OPS = (
    _op_autocontrast,
    _op_equalize,
    _op_invert,
    _op_rotate,
    _op_posterize,
    _op_solarize,
    _op_solarize_add,
    _op_color,
    _op_contrast,
    _op_brightness,
    _op_sharpness,
    _op_shear_x,
    _op_shear_y,
    _op_translate_x,
    _op_translate_y,
)


def parse_rand_augment_config(config_str: str) -> Dict:
    cfg = dict(magnitude=10.0, num_layers=2, magnitude_std=0.0,
               increasing=False, prob=0.5)
    parts = config_str.split("-")
    assert parts[0] == "rand", config_str
    for p in parts[1:]:
        m = re.match(r"([a-z]+)([\d.]+)", p)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "m":
            cfg["magnitude"] = float(val)
        elif key == "n":
            cfg["num_layers"] = int(val)
        elif key == "mstd":
            cfg["magnitude_std"] = float(val)
        elif key == "inc":
            cfg["increasing"] = bool(int(val))
        elif key == "p":
            cfg["prob"] = float(val)
    return cfg


def rotate_box(boxes: torch.Tensor, level: torch.Tensor, neg: torch.Tensor,
               size: Tuple[int, int]) -> torch.Tensor:
    """The BB fork's box transform under rotate: the image's output-to-input
    affine matrix applied verbatim to the two corners
    (rand_augment_BB_focused.py:108-171); shear and translate leave the box
    as it is (the reference's approximation). boxes: (B, T, 4) (x1, y1, x2,
    y2) pixels; level, neg: (B,); size: (H, W)."""
    H, W = size
    deg = ((level / MAX_LEVEL) * 30.0 * neg)[:, None]
    angle = -deg * math.pi / 180.0  # the reference's -radians(degrees)
    cx, cy = W / 2.0, H / 2.0  # the reference's rotn_center (w/2, h/2)
    a, b = torch.cos(angle), torch.sin(angle)
    d, e = -torch.sin(angle), torch.cos(angle)
    c = cx - (a * cx + b * cy)
    f = cy - (d * cx + e * cy)
    bx = boxes.unbind(-1)
    return torch.stack([a * bx[0] + b * bx[1] + c, d * bx[0] + e * bx[1] + f,
                        a * bx[2] + b * bx[3] + c, d * bx[2] + e * bx[3] + f],
                       dim=-1)


class RandAugmentDraws(NamedTuple):
    """rand_augment_batch's draws, each (B, num_layers): the op index
    (TRANSFORMS order), whether it applies, its magnitude (already clipped
    to [0, 10]), the sign of signed arguments (+1 / -1) and, for the
    geometric ops, the interpolation (0 bilinear, 1 bicubic)."""
    op: torch.Tensor
    apply: torch.Tensor
    magnitude: torch.Tensor
    neg: torch.Tensor
    interp: torch.Tensor


def sample_rand_augment_draws(generator: Optional[torch.Generator],
                              batch: int, config_str: str,
                              device=None) -> RandAugmentDraws:
    cfg = parse_rand_augment_config(config_str)
    shape = (batch, cfg["num_layers"])
    op = I.randint(generator, 0, len(TRANSFORMS), shape, device)
    apply = I.rand(generator, shape, device) < cfg["prob"]
    mag = torch.clamp(cfg["magnitude"] + cfg["magnitude_std"]
                      * I.randn(generator, shape, device), 0.0, MAX_LEVEL)
    neg = torch.where(I.rand(generator, shape, device) < 0.5, -1.0, 1.0)
    interp = I.randint(generator, 0, 2, shape, device)
    return RandAugmentDraws(op, apply, mag, neg, interp)


def rand_augment_batch(generator: Optional[torch.Generator],
                       clips: torch.Tensor,
                       config_str: str = "rand-m7-n4-mstd0.5-inc1",
                       boxes: Optional[torch.Tensor] = None,
                       draws: Optional[RandAugmentDraws] = None):
    """RandAugment of clips (B, T, H, W, C) float on [0, 255], each clip
    with its own draws (from `generator` on the clips' device, or `draws`);
    optional boxes (B, T, 4) are rotated with their clip, as in the BB fork.
    Returns the clips, or (clips, boxes) when boxes are given."""
    B, _, H, W, _ = clips.shape
    dev = clips.device
    if draws is None:
        draws = sample_rand_augment_draws(generator, B, config_str, dev)
    # the grouping is decided on the host: one copy of the small draws
    op, apply, interp = (t.cpu() for t in (draws.op, draws.apply,
                                           draws.interp))
    mag = draws.magnitude.to(dev, torch.float32)
    neg = draws.neg.to(dev, torch.float32)
    out = clips.clone()
    for layer in range(op.shape[1]):
        groups: Dict[Tuple[int, bool], list] = {}
        for i in torch.nonzero(apply[:, layer]).flatten().tolist():
            o = int(op[i, layer])
            bicubic = o in GEOMETRIC and bool(interp[i, layer] == 1)
            groups.setdefault((o, bicubic), []).append(i)
        for (o, bicubic), members in sorted(groups.items()):
            idx = torch.tensor(members, device=dev)
            got = OPS[o](out.index_select(0, idx), mag[idx, layer],
                         neg[idx, layer], bicubic)
            out.index_copy_(0, idx, got)
        if boxes is not None:
            rotated = rotate_box(boxes, mag[:, layer], neg[:, layer], (H, W))
            turn = (apply[:, layer] & (op[:, layer] == ROTATE)).to(dev)
            boxes = torch.where(turn[:, None, None], rotated, boxes)
    if boxes is not None:
        return out, boxes
    return out
