"""Dataset cleaning and re-encoding (scripts/data/data_clean.py and
data_clean_Epic_kitchen.py): re-encodes videos to a uniform mp4 (240p
short side by default), checks that each decodes, and reports or skips
corrupt files. A copy of mofo_tpu/cli/data_clean.py: OpenCV encodes (cv2,
imported only by reencode); the check decodes through the port's
VideoReader (the native FFmpeg library, else cv2).

Usage:
  python -m mofo_tpu_torch.cli.data_clean --src_dir raw/ --dst_dir mp4/ \
      [--short_side 240] [--validate_only]
"""

from __future__ import annotations

import argparse
import os


def get_args(argv=None):
    p = argparse.ArgumentParser("dataset cleaner")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--dst_dir", default=None)
    p.add_argument("--short_side", default=240, type=int)
    p.add_argument("--fps", default=0, type=float,
                   help="0 = keep source fps")
    p.add_argument("--validate_only", action="store_true")
    p.add_argument("--extensions",
                   default=".mp4,.webm,.avi,.mkv,.mov", type=str)
    return p.parse_args(argv)


def validate(path: str) -> bool:
    """Reference validation: decodable + non-trivial size
    (kinetics.py:229-243)."""
    from mofo_tpu_torch.data.video_reader import VideoReader

    if not os.path.exists(path) or os.path.getsize(path) < 1024:
        return False
    try:
        with VideoReader(path) as vr:
            if len(vr) < 1:
                return False
            vr.get_batch([0])
        return True
    except Exception:
        return False


def reencode(src: str, dst: str, short_side: int, fps: float) -> bool:
    import cv2

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        return False
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    out_fps = fps or src_fps
    if h <= w:
        oh, ow = short_side, int(round(w * short_side / h))
    else:
        oh, ow = int(round(h * short_side / w)), short_side
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    out = cv2.VideoWriter(
        dst, cv2.VideoWriter_fourcc(*"mp4v"), out_fps, (ow, oh)
    )
    ok_any = False
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.write(cv2.resize(frame, (ow, oh)))
        ok_any = True
    cap.release()
    out.release()
    return ok_any and validate(dst)


def main(args=None):
    if args is None:
        args = get_args()
    exts = tuple(args.extensions.split(","))
    files = sorted(
        os.path.join(args.src_dir, f)
        for f in os.listdir(args.src_dir)
        if f.lower().endswith(exts)
    )
    good, bad = 0, []
    for src in files:
        if args.validate_only:
            if validate(src):
                good += 1
            else:
                bad.append(src)
            continue
        name = os.path.splitext(os.path.basename(src))[0] + ".mp4"
        dst = os.path.join(args.dst_dir, name)
        if os.path.exists(dst) and validate(dst):
            good += 1
            continue
        if reencode(src, dst, args.short_side, args.fps):
            good += 1
        else:
            bad.append(src)
    print(f"ok: {good}  bad: {len(bad)}")
    for b in bad:
        print(f"BAD {b}")
    return good, bad


if __name__ == "__main__":
    main()
