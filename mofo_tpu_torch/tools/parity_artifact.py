"""Parity records of the port against the reference at seed 0.

    python -m mofo_tpu_torch.tools.parity_artifact [--curve] [--init W.pth]
        [--device cpu] [--out P.json]

Counterpart of tools/parity_artifact.py. Four records:

  - `mask_records`: tube and motion-box mask indices from the numpy twins
    of the reference generators (ops/masking.py TubeMaskingGeneratorNumpy,
    MotionTubeMaskingGeneratorNumpy) after np.random.seed(0);
  - `frame_records`: the TSN frame ids of data/sampling.tsn_frame_ids with
    the reference's np.random.seed(10) pin, for durations around
    skip_length (31, 32, 33) and a long video (300);
  - `loss_record(params)`: the forward reconstruction loss at the reduced
    geometry (img 32, 4 frames, encoder 64 x 2 Blocks x 2 heads, decoder
    32 x 2 x 2) in f32 and in f64, a 0.9 tube mask from the twin;
  - `curve_record(params)`: 25 full training steps in float64 (forward,
    backward, AdamW with the reference's decay grouping: no decay for 1-D
    parameters, biases, pos_embed, cls_token and mask_token), lr from
    cosine_schedule(1.5e-3, 1e-5, 5, 5, 1), betas (0.9, 0.95), eps 1e-8,
    wd 0.05, a fresh 0.5 tube mask from the twin per step after
    np.random.seed(0) and clips RandomState(2000 + s).randn(...) * 0.5.

`params` is the reduced model's state dict: the reference's numbers
(tests/golden/parity_curve_reduced.json's torch_losses, the f64 torch
transcription of the reference engine) hold for mofo_tpu's PRNGKey(1)
init, which the port cannot draw; the tests carry it across with
train/checkpoint.params_from_jax. The CLI takes it from --init (a .pth of
the state dict) or draws one from seed 1. At 8 tokens every Block takes
the plain attention math (models/layers.Attention), which keeps f64 end
to end, as the layer norms and the targets do; the kernels are not on
this path. The records run on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data.sampling import tsn_frame_ids
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import masking, patchify
from mofo_tpu_torch.ops.masking import (
    MotionTubeMaskingGeneratorNumpy,
    TubeMaskingGeneratorNumpy,
)
from mofo_tpu_torch.train import optim, schedules

MODEL = "pretrain_videomae_base_patch16_224"
GEOMETRY = dict(img=32, frames=4, enc_dim=64, enc_depth=2, enc_heads=2,
                dec_dim=32, dec_depth=2, dec_heads=2)
PATCH, TUBELET = 16, 2
CURVE_STEPS = 25
CURVE_BATCH = 2
# the curve's recipe (tools/parity_artifact.py:189-190)
BASE_LR, MIN_LR, EPOCHS, STEPS_PER_EPOCH, WARMUP = 1.5e-3, 1e-5, 5, 5, 1
WD, BETAS, EPS = 0.05, (0.9, 0.95), 1e-8

Params = Dict[str, torch.Tensor]


def _build(dtype: torch.dtype, device, seed: int = 0):
    g = GEOMETRY
    return create_model(
        MODEL, device=device, dtype=dtype, seed=seed, img_size=g["img"],
        num_frames=g["frames"], encoder_embed_dim=g["enc_dim"],
        encoder_depth=g["enc_depth"], encoder_num_heads=g["enc_heads"],
        decoder_embed_dim=g["dec_dim"], decoder_depth=g["dec_depth"],
        decoder_num_heads=g["dec_heads"],
        decoder_num_classes=TUBELET * PATCH * PATCH * 3)


def reduced_model(params: Params, dtype: torch.dtype, device=None):
    """pretrain_videomae_base_patch16_224 at GEOMETRY, its parameters in
    `dtype` (the compute dtype too), loaded from `params`."""
    model = _build(dtype, device).to(dtype)
    model.load_state_dict(params)
    return model


def init_params(seed: int = 1) -> Params:
    """A state dict of the reduced model drawn by the port from `seed`."""
    return {n: t.detach().clone() for n, t in
            _build(torch.float32, "cpu", seed).state_dict().items()}


def mask_records(t: int, h: int, w: int, ratio: float = 0.9,
                 ratio_bb: float = 0.75, patch: int = PATCH) -> dict:
    """Masked indices of the two twins after np.random.seed(0); the motion
    one for a box (2, 1, 6, 5) patches, bug_compat."""
    np.random.seed(0)
    tube = TubeMaskingGeneratorNumpy((t, h, w), ratio)()
    np.random.seed(0)
    box = np.asarray([2.0 * patch, 1.0 * patch, 6.0 * patch, 5.0 * patch])
    motion = MotionTubeMaskingGeneratorNumpy(
        (t, h, w), ratio, ratio_bb, patch_size=patch, bug_compat=True
    )(np.tile(box, (t, 1)))
    return {"tube_masked_idx": np.flatnonzero(tube).tolist(),
            "motion_masked_idx": np.flatnonzero(motion).tolist()}


def frame_records() -> dict:
    return {str(dur): np.asarray(tsn_frame_ids(
        dur, num_segments=1, skip_length=32, pin_seed=True)).tolist()
        for dur in (31, 32, 33, 300)}


def _indices(masks: np.ndarray, device):
    mask = torch.from_numpy(masks.astype(bool)).to(device)
    return masking.mask_to_indices(mask, int(masks[0].sum()))


def _loss(model, clip: torch.Tensor, vis, msk) -> torch.Tensor:
    """The masked MSE on normalized-pixel targets in the clip's dtype
    (f32 or f64), as the curve's loss_fn (tools/parity_artifact.py)."""
    tokens = patchify.patchify_flat(clip, patch_size=PATCH,
                                    tubelet_size=TUBELET)
    pred = model(tokens, vis, msk)
    with torch.no_grad():
        targets = patchify.masked_normalized_targets(
            tokens, msk, normalize_target=True, compute_dtype=clip.dtype)
    return patchify.masked_mse_loss(pred, targets)


def loss_record(params: Params, device=None) -> dict:
    """The forward loss of the reduced model on RandomState(0)'s clip * 0.5
    under the twin's 0.9 tube mask (seed 0), in f32 and in f64."""
    dev = resolve_device(device)
    g = GEOMETRY
    np.random.seed(0)
    mask_np = TubeMaskingGeneratorNumpy(
        (g["frames"] // TUBELET, g["img"] // PATCH, g["img"] // PATCH),
        0.9)()
    clip_np = np.random.RandomState(0).randn(
        1, g["frames"], g["img"], g["img"], 3).astype(np.float32) * 0.5
    vis, msk = _indices(mask_np[None], dev)
    out = {"geometry": g, "n_masked": int(mask_np.sum())}
    for key, dtype in (("loss_f32", torch.float32),
                       ("loss_f64", torch.float64)):
        model = reduced_model(params, dtype, dev).eval()
        clip = torch.from_numpy(clip_np).to(dev, dtype)
        with torch.no_grad():
            out[key] = float(_loss(model, clip, vis, msk))
    return out


def curve_inputs(n_steps: int = CURVE_STEPS):
    """The curve's masks (after np.random.seed(0)) and f64 clips."""
    g = GEOMETRY
    np.random.seed(0)
    gen = TubeMaskingGeneratorNumpy(
        (g["frames"] // TUBELET, g["img"] // PATCH, g["img"] // PATCH), 0.5)
    masks = [gen() for _ in range(n_steps)]
    clips = [np.random.RandomState(2000 + s).randn(
        CURVE_BATCH, g["frames"], g["img"], g["img"], 3).astype(
        np.float64) * 0.5 for s in range(n_steps)]
    return masks, clips


def curve_record(params: Params, n_steps: int = CURVE_STEPS,
                 device=None) -> dict:
    """n_steps full training steps of the reduced model in float64 from
    `params` (see the module docstring); the loss before each update."""
    dev = resolve_device(device)
    lr = schedules.cosine_schedule(BASE_LR, MIN_LR, EPOCHS, STEPS_PER_EPOCH,
                                   WARMUP)
    model = reduced_model(params, torch.float64, dev).train()
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=lr, betas=BETAS,
                                eps=EPS, weight_decay=WD)
    opt_state = tx.init(named)
    masks, clips = curve_inputs(n_steps)
    losses = []
    for s in range(n_steps):
        vis, msk = _indices(np.stack([masks[s]] * CURVE_BATCH), dev)
        for p in named.values():
            p.grad = None
        loss = _loss(model, torch.from_numpy(clips[s]).to(dev), vis, msk)
        loss.backward()
        tx.update({n: p.grad for n, p in named.items()}, opt_state, named)
        losses.append(float(loss.detach()))
    return {"geometry": GEOMETRY, "n_steps": n_steps, "weight_decay": WD,
            "losses": losses}


def rel_diff(a, b) -> float:
    """max |a - b| / |b| over two curves."""
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--curve", action="store_true",
                    help="the 25-step float64 training curve")
    ap.add_argument("--init", default=None,
                    help="the reduced model's state dict (.pth); drawn "
                         "from seed 1 without it")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    params = (torch.load(args.init, map_location="cpu") if args.init
              else init_params())
    if args.curve:
        artifact = {"seed": 0, "loss_curve": curve_record(
            params, device=args.device)}
    else:
        g = GEOMETRY
        artifact = {
            "seed": 0,
            "masks": mask_records(g["frames"] // TUBELET, g["img"] // PATCH,
                                  g["img"] // PATCH),
            "tsn_frames_pin_seed": frame_records(),
            "forward_loss": loss_record(params, device=args.device),
        }
    text = json.dumps(artifact, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
