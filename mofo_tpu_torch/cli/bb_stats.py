"""Motion-box dataset statistics (video_BB_ratio.py / Epic_BB_ratio_*.py):
iterates a box JSON and reports the mean fraction of the frame area that
the motion boxes cover, the sanity check of the offline box pipeline
(video_BB_ratio.py:152-157). A copy of mofo_tpu/cli/bb_stats.py (numpy
only), which the port keeps so that it imports nothing of the JAX package.

Usage:
  python -m mofo_tpu_torch.cli.bb_stats --bb_json boxes.json --height 240 \
      --width 320
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser("Motion-box statistics")
    p.add_argument("--bb_json", required=True)
    p.add_argument("--height", default=240, type=int)
    p.add_argument("--width", default=320, type=int)
    return p.parse_args(argv)


def main(args=None):
    if args is None:
        args = get_args()
    with open(args.bb_json) as f:
        data = json.load(f)
    ratios = []
    per_video = {}
    for vid, frames in data.items():
        vr = []
        for fr in frames:
            for lb in fr.get("labels", []):
                b = lb["box2d"]
                area = max(b["x2"] - b["x1"], 0) * max(
                    b["y2"] - b["y1"], 0
                )
                vr.append(area / float(args.height * args.width))
        if vr:
            per_video[vid] = float(np.mean(vr))
            ratios.extend(vr)
    mean_ratio = float(np.mean(ratios)) if ratios else 0.0
    print(f"videos: {len(per_video)}  frames: {len(ratios)}")
    print(f"mean bbox area ratio: {mean_ratio:.4f}")
    return mean_ratio, per_video


if __name__ == "__main__":
    main()
