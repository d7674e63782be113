"""Offline motion-box factory: the command line entry point.

Counterpart of mofo_tpu/cli/motion_factory.py, plus --device (default
cuda). One command replaces the reference's three-stage pipeline
(motion_map_creator.py --data-type flow / mag, then
bounding_box_creator_*.py): per video, decode (the port's VideoReader),
TV-L1 optical flow of every consecutive pair in batched calls on the
device (as many pairs a call as a memory budget allows), motion-boundary magnitude maps over a sliding window and per-frame
motion boxes with temporal cleanup and the clip-union overwrite on the
host, then everything into one Unsupervised_BB JSON. --flow_backend dis |
farneback computes the flow with OpenCV on the host instead.

Usage:
  python -m mofo_tpu_torch.cli.motion_factory --data_path train.csv \\
      --output Unsupervised_BB_SSV2_train.json [--window 8] [--device cpu]
  # intermediate motion-map videos: add --motion_map_dir dir/

Each video's line gives its boxes and its seconds by stage (decode, flow,
maps, boxes, write); a video that fails is skipped with a "SKIP" line, as
mofo_tpu's CLI does.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data.filelist import (
    ClipEntry,
    MotionBoxIndex,
    read_setting_file,
)
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.factory import bbox, flow, motion_maps

VIDEO_EXTENSIONS = (".mp4", ".webm", ".avi", ".mkv")


def get_args(argv=None):
    p = argparse.ArgumentParser("MOFO offline motion-box factory (PyTorch)")
    p.add_argument("--data_path", required=True,
                   help="'path label' list or a single video")
    p.add_argument("--output", required=True, help="merged bbox json")
    p.add_argument("--flow_backend", default="tvl1",
                   choices=["tvl1", "dis", "farneback"])
    p.add_argument("--window", default=8, type=int,
                   help="motion-boundary temporal window (4 for Kinetics)")
    p.add_argument("--max_frames", default=64, type=int,
                   help="cap decoded frames per video (stride-sampled)")
    p.add_argument("--no_clip_union", action="store_true",
                   help="keep per-frame boxes (skip the union overwrite)")
    p.add_argument("--motion_map_dir", default=None,
                   help="also write motion-map mp4s here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where TV-L1 runs")
    return p.parse_args(argv)


# Bytes a pair holds at the peak of a batched TV-L1 call, per pixel of a
# frame: 1594.7 MB for 58 pairs at 256 x 320 is 335.6 (torch.cuda's peak,
# NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py phase factory).
PAIR_BYTES_PER_PIXEL = 336
CUDA_FREE_SHARE = 0.5  # of the card's free bytes, for one call's pairs
CPU_FLOW_BUDGET = 2 << 30  # bytes of one call's pairs on the host


def flow_budget(device: torch.device) -> int:
    """Bytes one TV-L1 call may hold: a share of the card's free memory,
    or a fixed cap on the host."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0] * CUDA_FREE_SHARE)
    return CPU_FLOW_BUDGET


def pairs_per_call(height: int, width: int, budget: int) -> int:
    return max(1, budget // (PAIR_BYTES_PER_PIXEL * height * width))


def video_flows(frames: np.ndarray, args, device: torch.device,
                budget: int = None) -> np.ndarray:
    """(T, H, W, 3) uint8 frames -> (T-1, H, W, 2) float32 flows: TV-L1 of
    consecutive chunks of pairs, one batched call a chunk, each at most
    pairs_per_call(H, W, budget) pairs (budget: flow_budget(device) when
    None; each pair's flow is the one a call per pair gives), or OpenCV per
    pair on the host. float32 as mofo_tpu hands them to the maps:
    ndimage.convolve keeps its input's dtype, and float64 would change the
    uint8 maps."""
    if args.flow_backend == "tvl1":
        budget = flow_budget(device) if budget is None else budget
        step = pairs_per_call(frames.shape[1], frames.shape[2], budget)
        return np.concatenate([
            flow.tvl1_flow_batch(frames[i:i + step + 1], device=device)
            .cpu().numpy()
            for i in range(0, len(frames) - 1, step)
        ])
    return np.stack([
        flow.compute_flow(frames[i], frames[i + 1],
                          backend=args.flow_backend)
        for i in range(len(frames) - 1)
    ])


def magnitude_maps(flows: np.ndarray, window: int) -> list:
    """One uint8 motion-boundary magnitude map per flow pair, over the
    sliding window. The flow components are stacked like the reference's
    packed flow images (x and y treated as separate images in the boundary
    sum)."""
    flow_imgs = []
    for f in flows:
        flow_imgs.append(f[..., 0])
        flow_imgs.append(f[..., 1])
    mags = motion_maps.motion_magnitude_frames_np(flow_imgs, window=window)
    # one magnitude frame per pair (the pair's x / y maps were interleaved)
    return mags[::2]


def frame_boxes(mags: list, n_frames: int, clip_union: bool) -> list:
    """Per-frame boxes of n_frames frames from the pairs' maps; the final
    frame (no outgoing flow) repeats the last box."""
    boxes = bbox.extract_boxes(mags, clip_union=clip_union)
    if len(boxes) < n_frames:
        boxes = list(boxes) + [boxes[-1]] * (n_frames - len(boxes))
    return boxes


def process_video(path: str, args, device: torch.device, reader=VideoReader
                  ) -> tuple:
    """(per-frame boxes, seconds by stage) of one video."""
    seconds = {}
    t0 = time.perf_counter()
    with reader(path) as vr:
        n = len(vr)
        ids = np.arange(n)
        if n > args.max_frames:
            ids = np.linspace(0, n - 1, args.max_frames).astype(np.int64)
        frames = vr.get_batch(ids)
    seconds["decode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flows = video_flows(frames, args, device)
    seconds["flow"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mags = magnitude_maps(flows, args.window)
    seconds["maps"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    boxes = frame_boxes(mags, len(frames), not args.no_clip_union)
    seconds["boxes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.motion_map_dir:
        _write_motion_video(path, mags, args.motion_map_dir)
    seconds["write"] = time.perf_counter() - t0
    return boxes, seconds


def _write_motion_video(src_path: str, mags, out_dir: str):
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(src_path)
    h, w = mags[0].shape[:2]
    out = cv2.VideoWriter(
        os.path.join(out_dir, name),
        cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h), isColor=False,
    )
    for m in mags:
        out.write(m)
    out.release()


def main(args=None, reader=VideoReader) -> dict:
    """Writes the merged box JSON. Returns {"boxes": {video: boxes},
    "seconds": {video: seconds by stage}, "skipped": {video: error}}; the
    JSON's write time is spread over the videos' "write". `reader` opens
    the videos (no CLI flag reaches it)."""
    if args is None:
        args = get_args()
    device = resolve_device(args.device)
    if args.data_path.endswith(VIDEO_EXTENSIONS):
        entries = [ClipEntry(args.data_path, 0)]
    else:
        entries = read_setting_file(args.data_path)

    per_video, seconds, skipped = {}, {}, {}
    for e in entries:
        key = MotionBoxIndex.video_key(e.path)
        try:
            per_video[key], seconds[key] = process_video(
                e.path, args, device, reader)
        except Exception as exc:  # noqa: BLE001 — a bad video is skipped
            skipped[key] = repr(exc)
            print(f"SKIP {key}: {exc}")
            continue
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in seconds[key].items())
        print(f"{key}: {len(per_video[key])} boxes ({stages})")
    t0 = time.perf_counter()
    bbox.write_bbox_json(args.output, per_video)
    share = (time.perf_counter() - t0) / max(len(per_video), 1)
    for s in seconds.values():
        s["write"] += share
    print(f"wrote {len(per_video)} videos to {args.output}")
    return {"boxes": per_video, "seconds": seconds, "skipped": skipped}


if __name__ == "__main__":
    main()
