"""Offline EPIC-KITCHENS preprocessing: action-segment cutting and
ground-truth hand-object annotation conversion. A copy of
mofo_tpu/factory/epic_segments.py.

Host-side factory steps covering the last two reference scripts
(`scripts/data/Epic-kitchen/Preprocess_epic_data.py:1-237`,
`Preprocess_epic_annot.py:1-180`):

1. ``cut_action_segments`` — one mp4 per EPIC_100_{split}.csv action row
   (``video_{row}.MP4``), re-encoded from the official per-video RGB
   frame dumps (``<root>/<participant>/rgb_frames/<video_id>/
   frame_%010d.jpg``). This produces the pre-cut segment layout
   `data/epic.EpicClipDataset` assumes. Same semantics as the reference:
   frames ``start_frame..stop_frame`` inclusive with its +1 filename
   offset (`Preprocess_epic_data.py:146-148` opens ``format(i + 1)``),
   cv2 ``mp4v`` writer at the row fps, skip-if-exists resume, process
   pool. (The reference's ``cv2.VideoWriter(out, fourcc, fps)`` call
   drops the required frameSize argument — a latent crash; we pass the
   first frame's size, which is the intent.)

2. ``convert_hoa_detections`` — per-video hand-object detection pickles
   -> per-action files (`Preprocess_epic_annot.py:113-141`). The
   reference needs the ``epic_kitchens`` package for its protobuf
   pickles and re-dumps python pickles keyed ``detection_{row}.pkl``;
   here three input schemas are accepted (see ``_frame_boxes``) and the
   output is JSON, plus an optional merged Unsupervised_BB-style json
   (per-frame union of hand+object boxes keyed ``video_{row}``) that
   `data/filelist.MotionBoxIndex` consumes directly — the GT-box
   counterpart of the motion-box BB experiments.

No device involvement: this is bounded IO work, multiprocessing is the
right tool (matches the reference's ``Pool(20)``).
"""

from __future__ import annotations

import csv
import json
import os
import pickle
import multiprocessing
from typing import Dict, List, Optional, Sequence, Tuple

# EPIC-100 rgb_frames are extracted at 50 fps (dataset release note);
# used when the csv carries no fps column (the official EPIC_100 csvs
# don't — the reference reads item["fps"] from a locally augmented csv)
DEFAULT_FPS = 50.0


def read_epic_rows(csv_path: str) -> List[Dict]:
    """EPIC_100_{split}.csv rows as dicts, one per action segment.

    Keeps the row index as ``index`` — the reference names outputs by
    the pandas iterrows() index (`Preprocess_epic_data.py:63-66`).
    """
    rows = []
    with open(csv_path, newline="") as f:
        for i, row in enumerate(csv.DictReader(f)):
            rows.append(
                {
                    "index": i,
                    "participant_id": row["participant_id"],
                    "video_id": row["video_id"],
                    "start_frame": int(row["start_frame"]),
                    "stop_frame": int(row["stop_frame"]),
                    "fps": float(row.get("fps") or DEFAULT_FPS),
                }
            )
    return rows


def frame_jpg_path(
    frames_root: str, participant_id: str, video_id: str, frame_idx: int
) -> str:
    """Path of one extracted RGB frame, with the reference's +1 offset
    (frame files are 1-based; the reference opens ``format(i + 1)`` for
    loop index i — `Preprocess_epic_data.py:146-148`)."""
    return os.path.join(
        frames_root,
        participant_id,
        "rgb_frames",
        video_id,
        "frame_{:010d}.jpg".format(frame_idx + 1),
    )


def cut_one_segment(
    row: Dict, frames_root: str, out_dir: str, dry_run: bool = False
) -> str:
    """Write ``video_{index}.MP4`` for one csv row. Returns a status
    string ('exists' / 'ok' / 'missing:<path>' / 'planned')."""
    out_path = os.path.join(out_dir, f"video_{row['index']}.MP4")
    if os.path.exists(out_path):
        return "exists"
    paths = [
        frame_jpg_path(
            frames_root, row["participant_id"], row["video_id"], i
        )
        for i in range(row["start_frame"], row["stop_frame"] + 1)
    ]
    for p in paths:
        if not os.path.exists(p):
            return f"missing:{p}"
    if dry_run:
        return "planned"
    import cv2  # heavy import kept out of module load

    first = cv2.imread(paths[0])
    if first is None:
        return f"unreadable:{paths[0]}"
    h, w = first.shape[:2]
    os.makedirs(out_dir, exist_ok=True)
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), row["fps"], (w, h)
    )
    try:
        writer.write(first)
        for p in paths[1:]:
            frame = cv2.imread(p)
            if frame is None:
                return f"unreadable:{p}"
            writer.write(frame)
    finally:
        writer.release()
    return "ok"


def cut_action_segments(
    csv_path: str,
    frames_root: str,
    out_dir: str,
    workers: int = 1,
    dry_run: bool = False,
    limit: Optional[int] = None,
) -> Dict[str, int]:
    """Cut every action row of one split csv. Returns status counts."""
    rows = read_epic_rows(csv_path)
    if limit is not None:
        rows = rows[:limit]
    args = [(row, frames_root, out_dir, dry_run) for row in rows]
    if workers > 1:
        # spawned workers: forking a process that holds threads is unsafe
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            statuses = pool.starmap(cut_one_segment, args)
    else:
        statuses = [cut_one_segment(*a) for a in args]
    counts: Dict[str, int] = {}
    for s in statuses:
        key = s.split(":", 1)[0]
        counts[key] = counts.get(key, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Hand-object detection conversion
# ---------------------------------------------------------------------------

Box = List[float]  # [left, top, right, bottom]


def _frame_boxes(det) -> Tuple[List[Box], List[Box]]:
    """(hand_boxes, object_boxes) for one frame detection record.

    Three schemas, tried in order:
      - dict with 'hands'/'objects' lists of [l, t, r, b] (also the
        output schema, so conversions are idempotent);
      - FrameDetections-like object: ``.hands``/``.objects`` items with
        ``.bbox.left/.top/.right/.bottom`` (what the epic_kitchens
        package unpickles; duck-typed so the package isn't required);
      - protobuf-serialized bytes, parsed via epic_kitchens when it IS
        importable (raw release pickles).
    """
    if isinstance(det, dict):
        return (
            [list(map(float, b)) for b in det.get("hands", [])],
            [list(map(float, b)) for b in det.get("objects", [])],
        )
    if isinstance(det, (bytes, str)):
        from epic_kitchens.hoa.types import FrameDetections  # optional dep

        det = FrameDetections.from_protobuf_str(det)
    hands = [
        [float(h.bbox.left), float(h.bbox.top),
         float(h.bbox.right), float(h.bbox.bottom)]
        for h in det.hands
    ]
    objects = [
        [float(o.bbox.left), float(o.bbox.top),
         float(o.bbox.right), float(o.bbox.bottom)]
        for o in det.objects
    ]
    return hands, objects


def load_hoa_detections(path: str) -> List:
    """One per-video hand-object pickle -> list of per-frame records."""
    with open(path, "rb") as f:
        return pickle.load(f)


def union_box(
    boxes: Sequence[Box], empty: Sequence[float] = (0.0, 0.0, 1.0, 1.0)
) -> Box:
    """Min/max union of all boxes in one frame; the BB pipeline's empty
    box ([0,0,1,1], transforms.py:110-114 convention) when none."""
    if not boxes:
        return list(empty)
    return [
        min(b[0] for b in boxes),
        min(b[1] for b in boxes),
        max(b[2] for b in boxes),
        max(b[3] for b in boxes),
    ]


def convert_hoa_detections(
    csv_path: str,
    annot_root: str,
    out_dir: str,
    merged_json: Optional[str] = None,
    limit: Optional[int] = None,
) -> Dict[str, int]:
    """Per-action GT hand-object files from per-video pickles.

    For each csv row: load ``<annot_root>/<participant>/<video>.pkl``,
    slice frames ``[start_frame:stop_frame]`` (the reference's list
    slice, `Preprocess_epic_annot.py:128`), write
    ``detection_{index}.json`` with {'objects': [...], 'hands': [...]}
    (per-frame box lists — the reference's pickle payload, as JSON).

    merged_json: additionally write one Unsupervised_BB-style json
    mapping ``video_{index}`` -> per-frame union-box labels, the format
    `MotionBoxIndex.from_file` reads — pointing the BB-focused finetune
    at GT hand-object boxes instead of motion boxes.
    """
    from mofo_tpu_torch.factory.bbox import boxes_to_labels

    rows = read_epic_rows(csv_path)
    if limit is not None:
        rows = rows[:limit]
    os.makedirs(out_dir, exist_ok=True)
    counts: Dict[str, int] = {}
    merged: Dict[str, List] = {}
    cache_path, cache_dets = None, None
    for row in rows:
        out_path = os.path.join(out_dir, f"detection_{row['index']}.json")
        pkl = os.path.join(
            annot_root, row["participant_id"], row["video_id"] + ".pkl"
        )
        if not os.path.exists(pkl):
            counts["missing"] = counts.get("missing", 0) + 1
            continue
        if pkl != cache_path:  # csv rows are grouped by video
            cache_path, cache_dets = pkl, load_hoa_detections(pkl)
        seg = cache_dets[row["start_frame"]:row["stop_frame"]]
        hands, objects = [], []
        for det in seg:
            h, o = _frame_boxes(det)
            hands.append(h)
            objects.append(o)
        if not os.path.exists(out_path):
            with open(out_path, "w") as f:
                json.dump({"objects": objects, "hands": hands}, f)
        counts["ok"] = counts.get("ok", 0) + 1
        if merged_json is not None:
            merged[f"video_{row['index']}"] = boxes_to_labels(
                [union_box(h + o) for h, o in zip(hands, objects)]
            )
    if merged_json is not None:
        os.makedirs(
            os.path.dirname(os.path.abspath(merged_json)), exist_ok=True
        )
        with open(merged_json, "w") as f:
            json.dump(merged, f)
    return counts
