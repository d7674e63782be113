"""MAE reconstruction visualization (run_videomae_vis.py parity).

Counterpart of mofo_tpu/cli/vis.py, plus --device (default cuda). Loads
one video, samples a fixed 16-frame clip, runs the pretrain model (f32 by
default) with a tube mask drawn from a torch.Generator seeded by --seed,
and writes ori/mask/rec JPEG frames. The per-patch un-normalization uses
the ORIGINAL patch mean/std (run_videomae_vis.py /
engine_for_pretraining.py:74-79), so reconstructions are viewable even with
normalized-pixel targets. --model_path is a torch .pth (the port's pretrain
runner writes them); an orbax directory is the JAX package's format, which
the port does not read. Without it the weights come from seed 0.

Usage:
  python -m mofo_tpu_torch.cli.vis --img_path v.mp4 --save_path out/ \\
      --model_path checkpoint-99.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import image as I
from mofo_tpu_torch.ops import masking, patchify
from mofo_tpu_torch.train import checkpoint as ckpt


def get_args(argv=None):
    p = argparse.ArgumentParser("MAE visualization (PyTorch)")
    p.add_argument("--img_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--model_path", default=None,
                   help="pretrain checkpoint (torch .pth)")
    p.add_argument("--model",
                   default="pretrain_videomae_base_patch16_224")
    p.add_argument("--decoder_depth", default=4, type=int)
    p.add_argument("--mask_ratio", default=0.9, type=float)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--sampling_rate", default=4, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain PyTorch versions")
    return p.parse_args(argv)


def load_clip(path: str, num_frames: int, input_size: int,
              device: torch.device, reader=VideoReader):
    """(frame ids, the (1, T, S, S, 3) clip in [0, 1] pixels): uniform
    frame ids, short side scaled to S, centre crop."""
    with reader(path) as vr:
        duration = len(vr)
        # fixed frame grid like run_videomae_vis (uniform ids)
        tick = duration / float(num_frames)
        ids = np.clip([int(tick / 2.0 + tick * x) for x in range(num_frames)],
                      0, duration - 1)
        frames = vr.get_batch(ids)
    clips = torch.from_numpy(frames[None].astype(np.float32)).to(device)
    clips = clips / 255.0
    rh, rw = I.short_side_scale_size(frames.shape[1], frames.shape[2],
                                     input_size)
    clips = I.resize(clips, (rh, rw))
    crop = I.center_crop_boxes(1, (rh, rw), (input_size, input_size),
                               device=device)
    return ids, I.crop_and_resize(clips, crop, (input_size, input_size))


def load_weights(model: torch.nn.Module, path: str) -> None:
    """A pretrain .pth into the model. Every parameter must be in it; the
    sin-cos position tables stay the model's own (mofo_tpu recomputes them
    too); names the model lacks are printed, as mofo_tpu prints them. A
    path that is not a .pth raises (load_pretrain_encoder)."""
    sd = {k: v for k, v in ckpt.load_pretrain_encoder(path).items()
          if "pos_embed" not in k}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if "pos_embed" not in k]
    if missing:
        raise KeyError(f"{path} lacks {missing}")
    if unexpected:
        print(f"unmatched keys: {unexpected}")


@torch.no_grad()
def reconstruct(model: torch.nn.Module, normed: torch.Tensor,
                vis_idx: torch.Tensor, masked_idx: torch.Tensor) -> dict:
    """The original, reconstructed and masked patches (16 x 16 x 2), each
    (B, N, P, C) in [0, 1] pixels: visible patches from the input, masked
    ones from the prediction un-normalized with the input patch's own mean
    and unbiased std."""
    pred = model(normed, vis_idx, masked_idx).float()
    targets = patchify.patchify(patchify.unnormalize_clip(normed), 16, 2)
    n = targets.shape[-2]
    mean = targets.mean(dim=-2, keepdim=True)
    var = targets.var(dim=-2, correction=0, keepdim=True) * (n / (n - 1))
    std = torch.sqrt(var) + 1e-6
    P, C = targets.shape[-2], targets.shape[-1]
    pred_pix = pred.reshape(pred.shape[0], pred.shape[1], P, C)
    idx = masked_idx[..., None, None]
    mean_m = torch.take_along_dim(mean, idx, dim=1)
    std_m = torch.take_along_dim(std, idx, dim=1)
    pred_pix = pred_pix * std_m + mean_m
    spread = idx.expand(*masked_idx.shape, P, C)
    return {"ori": targets,
            "rec": targets.scatter(1, spread, pred_pix),
            "mask": targets.scatter(1, spread, torch.full_like(pred_pix,
                                                               0.5))}


def write_frames(recon: dict, save_path: str, t: int, s: int) -> int:
    """Each video of `recon` as {name}_img{i}.jpg (BGR). Returns the
    count."""
    import cv2

    written = 0
    for name in ("ori", "rec", "mask"):
        video = patchify.unpatchify(recon[name], t, s, s)[0].cpu().numpy()
        for i, frame in enumerate(video):
            out = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(save_path, f"{name}_img{i}.jpg"),
                        out[:, :, ::-1])
            written += 1
    return written


def main(args=None, reader=VideoReader) -> dict:
    """Writes the frames; returns reconstruct's patches (on the CPU).
    `reader` opens the video (no CLI flag reaches it)."""
    if args is None:
        args = get_args()
    device = resolve_device(args.device)
    os.makedirs(args.save_path, exist_ok=True)

    _, clips = load_clip(args.img_path, args.num_frames, args.input_size,
                         device, reader)
    normed = I.normalize(clips)
    model = create_model(args.model, device=device,
                         decoder_depth=args.decoder_depth,
                         num_frames=args.num_frames,
                         img_size=args.input_size)
    if args.model_path:
        load_weights(model, args.model_path)
    model.eval()
    t_pos = args.num_frames // 2
    ppf = (args.input_size // 16) ** 2
    # drawn on the CPU, so that a seed gives one mask on every device
    mask = masking.tube_mask(
        1, temporal_positions=t_pos, patches_per_frame=ppf,
        mask_ratio=args.mask_ratio,
        generator=torch.Generator().manual_seed(args.seed),
    )
    n_masked = t_pos * masking.num_masked_per_frame(ppf, args.mask_ratio)
    vis_idx, masked_idx = masking.mask_to_indices(mask, n_masked)
    recon = reconstruct(model, normed, vis_idx.to(device),
                        masked_idx.to(device))
    n = write_frames(recon, args.save_path, t_pos, args.input_size // 16)
    print(f"wrote {n} frames to {args.save_path}")
    return {k: v.cpu() for k, v in recon.items()}


if __name__ == "__main__":
    main()
