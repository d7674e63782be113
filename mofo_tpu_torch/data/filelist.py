"""Dataset index parsing: file lists, EK-100 CSVs, motion-box JSONs.

A copy of mofo_tpu/data/filelist.py (numpy only), which the port keeps so
that it imports nothing of the JAX package. Formats:
  - "path [duration] label" space-separated setting files
    (kinetics.py:500-516; the label is the LAST field)
  - EK-100 annotation CSVs: participant / video ids in columns 1:3,
    narration column 8, verb 10, noun 12, timestamps 4:6
    (epic_kitchens.py:452-463, utils.py:556-582)
  - Unsupervised_BB_<ds>_<split>.json motion-box files:
    {video: [{labels: [{box2d: {x1, y1, x2, y2}, gt_annotation}, ...]},
    ...]} indexed per frame (kinetics.py:1014-1021)
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mofo_tpu_torch.eval.multiview import action_label_space


@dataclasses.dataclass
class ClipEntry:
    path: str
    label: int


def read_setting_file(path: str) -> List[ClipEntry]:
    """Parse a "path [duration] label" list (kinetics.py:500-516)."""
    if not os.path.exists(path):
        raise RuntimeError(f"Setting file {path} doesn't exist.")
    clips = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" ")
            if len(parts) < 2:
                raise RuntimeError(
                    f"Video input format is not correct: {line!r}")
            clips.append(ClipEntry(path=parts[0], label=int(parts[-1])))
    return clips


@dataclasses.dataclass
class EpicEntry:
    participant_id: str
    video_id: str
    narration: str
    verb: int
    noun: int
    start_timestamp: str
    stop_timestamp: str
    index: int  # row index -> video_<i>.mp4 naming (epic_kitchens.py:460)


def datetime2sec(s: str) -> float:
    """'HH:MM:SS.ss' -> seconds (epic_kitchens.py:976-978)."""
    hh, mm, ss = s.split(":")
    return int(hh) * 3600 + int(mm) * 60 + float(ss)


def read_epic_csv(path: str) -> List[EpicEntry]:
    entries = []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for i, row in enumerate(reader):
            entries.append(EpicEntry(
                participant_id=row[1], video_id=row[2], narration=row[8],
                verb=int(row[10]), noun=int(row[12]),
                start_timestamp=row[4], stop_timestamp=row[5], index=i))
    return entries


def epic_action_space(
    csv_paths: Sequence[str],
) -> Tuple[List[str], Dict[str, int], List[Tuple[int, int]]]:
    """The EK action ('verb:noun') label space of the train + validation
    CSVs (generate_label_map, utils.py:556-582): (vn_list, mapping_vn2act,
    the (verb, noun) pair of each action class for marginalization)."""
    pairs = [(e.verb, e.noun) for p in csv_paths for e in read_epic_csv(p)]
    vn_list, mapping = action_label_space(pairs)
    action_to_vn = [tuple(int(x) for x in vn.split(":")) for vn in vn_list]
    return vn_list, mapping, action_to_vn


class MotionBoxIndex:
    """Per-frame motion bounding boxes from an Unsupervised_BB json.

    get(video_key, frame_ids) -> (T, 4) float32 (x1, y1, x2, y2); missing
    videos / frames yield the empty box [0, 0, 1, 1] (the BB-aware crop's
    empty-box convention, transforms.py:110-114).
    """

    EMPTY = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)

    def __init__(self, data: Dict):
        self._data = data

    @classmethod
    def from_file(cls, path: str) -> "MotionBoxIndex":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    @staticmethod
    def video_key(path: str) -> str:
        """The reference's key: the basename without its extension
        (kinetics.py:1014)."""
        return os.path.basename(path).rsplit(".", 1)[0]

    def get(self, video_key: str, frame_ids: Sequence[int]) -> np.ndarray:
        frames = self._data.get(video_key)
        out = np.zeros((len(frame_ids), 4), dtype=np.float32)
        for i, fid in enumerate(frame_ids):
            box = None
            if frames is not None and 0 <= fid < len(frames):
                labels = frames[fid].get("labels", [])
                if labels:
                    b = labels[0]["box2d"]
                    box = np.array([b["x1"], b["y1"], b["x2"], b["y2"]],
                                   dtype=np.float32)
            out[i] = box if box is not None else self.EMPTY
        return out

    def union_box(self, video_key: str,
                  frame_ids: Sequence[int]) -> np.ndarray:
        """Min / max union over the sampled frames (the global-union
        variant, kinetics.py:563-690)."""
        boxes = self.get(video_key, frame_ids)
        return np.array([boxes[:, 0].min(), boxes[:, 1].min(),
                         boxes[:, 2].max(), boxes[:, 3].max()],
                        dtype=np.float32)
