"""End-to-end recipe: mp4 files -> pretrain CLI -> checkpoint -> finetune
CLI (from that checkpoint) -> validation and test, in one run.

    python -m mofo_tpu_torch.tools.e2e_recipe [--device cpu] [--out F]

Counterpart of tools/e2e_recipe.py. It writes 8 videos of 48 frames at
128 x 96 with cv2 (`make_videos`, a copy of tools/bench_input.py's) into a
temporary directory, a "path label" list over them (two classes), then
runs, in this process:

  - cli.pretrain: pretrain_videomae_tiny_debug, --decoder_depth 1, tube
    masks (a box JSON is not part of this recipe), 2 epochs at B=4 on 32 px
    clips of 4 frames decoded at 48 x 64, a checkpoint every epoch;
  - cli.finetune: vit_tiny_debug on 2 classes with --finetune from the last
    pretrain checkpoint, 2 epochs, RandAugment rand-m7-n1-mstd0.5-inc1,
    drop path 0, validation each epoch and the final test.

The videos go through the port's VideoReader (the native decoder where it
loads, cv2 otherwise) and PrefetchLoader. At 8 tokens every Block takes
the plain attention math, so no kernel runs: the point is that the layers
compose, on the card by default. Prints one JSON line: the pretrain steps
and last train loss, how many tensors the finetune CLI took from the
checkpoint, the finetune steps and last epoch's log line, the seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.tools.convergence_ab import device_record

INIT_LINE = re.compile(r"initialized the backbone from \S+ \((\d+) tensors\)")


def make_videos(root: str, n: int, frames: int = 64, size=(320, 256)):
    """n mp4v files of a random image rolling 3 px a frame, size (w, h)."""
    import cv2

    paths = []
    rng = np.random.RandomState(0)
    for i in range(n):
        p = os.path.join(root, f"v{i:03d}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, size)
        base = rng.randint(0, 255, (size[1], size[0], 3), np.uint8)
        for t in range(frames):
            w.write(np.roll(base, t * 3, axis=1))
        w.release()
        paths.append(p)
    return paths


class _Tee(io.StringIO):
    """Keeps what is written and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def _last_epoch(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "log.txt")) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def run(root: str, device: str = "cuda") -> dict:
    """The recipe in directory `root`; returns the record."""
    resolve_device(device)
    t0 = time.time()
    paths = make_videos(root, 8, frames=48, size=(128, 96))
    csv = os.path.join(root, "list.csv")
    with open(csv, "w") as f:
        for i, p in enumerate(paths):
            f.write(f"{p} {i % 2}\n")
    common = ["--batch_size", "4", "--input_size", "32", "--num_frames",
              "4", "--decode_height", "48", "--decode_width", "64",
              "--num_workers", "1", "--device", device]
    pt_out = os.path.join(root, "pt")
    pt_state = PT.main(PT.get_args([
        "--model", "pretrain_videomae_tiny_debug", "--decoder_depth", "1",
        "--data_path", csv, "--mask_type", "tube", "--epochs", "2",
        "--warmup_epochs", "0", "--save_ckpt_freq", "1",
        "--output_dir", pt_out] + common))
    ckpts = sorted(glob.glob(os.path.join(pt_out, "checkpoint-*.pth")))
    if not ckpts:
        raise RuntimeError("the pretrain CLI wrote no checkpoint")
    ft_out = os.path.join(root, "ft")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        FT.main(FT.get_args([
            "--model", "vit_tiny_debug", "--data_path", csv, "--val_path",
            csv, "--test_path", csv, "--nb_classes", "2", "--finetune",
            ckpts[-1], "--epochs", "2", "--warmup_epochs", "0",
            "--save_ckpt_freq", "2", "--aa", "rand-m7-n1-mstd0.5-inc1",
            "--drop_path", "0.0", "--output_dir", ft_out] + common))
    loaded = INIT_LINE.search(tee.getvalue())
    if loaded is None:
        raise RuntimeError("the finetune CLI did not load the pretrain "
                           "checkpoint")
    last = _last_epoch(ft_out)
    return {
        "metric": "e2e recipe (decode -> pretrain -> checkpoint -> "
                  "finetune -> eval)",
        "device": device_record(device),
        "pretrain_steps": int(pt_state.step),
        "pretrain_final_loss": _last_epoch(pt_out)["train_loss"],
        "pretrain_checkpoint": os.path.basename(ckpts[-1]),
        "finetune_init_tensors": int(loaded.group(1)),
        "finetune_steps": last["step"],
        "finetune_last_epoch": last,
        "wall_s": time.time() - t0,
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="e2e_") as root:
        rec = run(root, args.device)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
