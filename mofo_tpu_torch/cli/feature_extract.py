"""Pooled feature extraction (MOFO_feature_extraction.py), on one device.

Counterpart of mofo_tpu/cli/feature_extract.py, plus --device (default
cuda): each listed video through the validation sampler (uniform, 16
frames decoded at 256x320) and eval_augment, then the classifier's pooled
(N, D) features (return_features=True) into a .npy file, one row per
video. --model_path is a torch .pth (a finetune checkpoint, the BB-focused
model's too, or a pretrain one): whatever of its backbone, norms and
fc_norm matches the model is loaded, the rest left as initialized (the
reference's lenient load, utils.py:299-344). An orbax directory is the JAX
package's format, which the port does not read.

Usage:
  python -m mofo_tpu_torch.cli.feature_extract --data_path list.csv \\
      --model_path ft/checkpoint-best.pth --output features.npy
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.data.filelist import ClipEntry, read_setting_file
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.train import checkpoint as ckpt

VIDEO_EXTENSIONS = (".mp4", ".webm", ".avi", ".mkv")


def get_args(argv=None):
    p = argparse.ArgumentParser("MOFO feature extraction (PyTorch)")
    p.add_argument("--data_path", required=True,
                   help="'path label' list or a single video file")
    p.add_argument("--output", default="features.npy")
    p.add_argument("--model_path", default=None)
    p.add_argument("--model", default="vit_base_patch16_224_feature_ext")
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain PyTorch versions")
    return p.parse_args(argv)


def as_encoder(state_dict) -> dict:
    """A classifier's (or pretrain model's) state_dict under the encoder.*
    names that finetune_init_from_pretrain copies from: the backbone. and
    encoder. prefixes stripped, as mofo_tpu's import_torch_finetune strips
    them."""
    out = {}
    for name, value in state_dict.items():
        for prefix in ("backbone.", "encoder."):
            if name.startswith(prefix):
                name = name[len(prefix):]
                break
        out["encoder." + name] = value
    return out


def main(args=None, reader=VideoReader) -> np.ndarray:
    """Writes and returns the (N, D) features. `reader` opens the videos
    (an in-memory reader in the checks; no CLI flag reaches it)."""
    if args is None:
        args = get_args()
    device = resolve_device(args.device)
    if args.data_path.endswith(VIDEO_EXTENSIONS):
        entries = [ClipEntry(args.data_path, 0)]
    else:
        entries = read_setting_file(args.data_path)
    ds = P.FinetuneClipDataset(entries=entries, mode="validation",
                               sampler="uniform", num_frames=args.num_frames,
                               decode_size=(256, 320), reader=reader)
    model = create_model(args.model, device=device, img_size=args.input_size,
                         all_frames=args.num_frames, num_classes=0)
    if args.model_path:
        copied = ckpt.finetune_init_from_pretrain(model, as_encoder(
            ckpt.load_pretrain_encoder(args.model_path)))
        print(f"loaded {len(copied)} tensors from {args.model_path}")
    model.eval()

    loader = P.PrefetchLoader(ds, args.batch_size, drop_last=False,
                              device=device)
    feats = []
    with torch.no_grad():
        for batch in loader:
            clips, _ = A.eval_augment(batch["clip"], out_size=args.input_size,
                                      short_side=args.input_size)
            out = model(clips, return_features=True)
            # the padded rows of the last batch are dropped: one row per
            # video (mofo_tpu keeps them, ROADMAP Queue 3)
            feats.append(out[batch["valid"]].float().cpu().numpy())
    feats = np.concatenate(feats, axis=0)
    np.save(args.output, feats)
    print(f"wrote features {feats.shape} to {args.output}")
    return feats


if __name__ == "__main__":
    main()
