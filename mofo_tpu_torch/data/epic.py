"""EPIC-KITCHENS-100 dataset: timestamp-delimited action clips.

Counterpart of mofo_tpu/data/epic.py (the reference's epic_kitchens.py
VideoClassyDataset (+ _BB), the loader wired into the runners,
datasets.py:217-226, 420-429):
  - samples come from the EPIC_100 CSVs; row i maps to video_<i>.mp4 in
    <root>/<split> (pre-cut action segments, epic_kitchens.py:455-463)
  - frame ids: a jittered uniform grid over the clip in train mode, its
    centres in validation (get_frame_ids, epic_kitchens.py:967-974)
  - labels: verb / noun / the 'verb:noun' action id of the sorted action
    space (utils.py:556-582)
  - test mode reads the validation videos and expands (chunk, crop) views
    like the SSV2 dataset
Videos open through the `reader` field, as in data.pipeline.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from mofo_tpu_torch.data import sampling
from mofo_tpu_torch.data.filelist import EpicEntry, MotionBoxIndex
from mofo_tpu_torch.data.pipeline import expand_views
from mofo_tpu_torch.data.video_reader import VideoReader


@dataclasses.dataclass
class EpicClipDataset:
    entries: Sequence[EpicEntry]
    video_root: str
    split: str  # train | validation (test reads the validation videos)
    mode: str = "train"
    classtype: str = "action"  # verb | noun | action
    action_mapping: Optional[Dict[str, int]] = None  # for classtype=action
    num_frames: int = 16
    decode_size: Tuple[int, int] = (256, 320)
    test_num_segment: int = 2
    test_num_crop: int = 3
    boxes: Optional[MotionBoxIndex] = None
    reader: Callable = VideoReader

    def __post_init__(self):
        if self.classtype == "action" and self.action_mapping is None:
            raise ValueError("classtype=action needs action_mapping")
        if self.mode == "test":
            self._views = expand_views(len(self.entries),
                                       self.test_num_segment,
                                       self.test_num_crop)

    def __len__(self) -> int:
        if self.mode == "test":
            return len(self._views)
        return len(self.entries)

    def _label(self, e: EpicEntry) -> int:
        if self.classtype == "verb":
            return e.verb
        if self.classtype == "noun":
            return e.noun
        return self.action_mapping[f"{e.verb}:{e.noun}"]

    def _video_path(self, e: EpicEntry) -> str:
        sub = "validation" if self.mode == "test" else self.split
        return os.path.join(self.video_root, sub, f"video_{e.index}.mp4")

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.mode == "test":
            entry_idx, chunk_nb, split_nb = self._views[i]
        else:
            entry_idx, chunk_nb, split_nb = i, 0, 0
        e = self.entries[entry_idx]
        path = self._video_path(e)
        h, w = self.decode_size
        with self.reader(path, width=w, height=h) as vr:
            n = len(vr)
            if self.mode == "train":
                ids = sampling.timestamp_frame_ids(
                    0, n - 1, num_segments=self.num_frames, jitter=True,
                    rng=np.random)
            elif self.mode == "validation":
                ids = sampling.timestamp_frame_ids(
                    0, n - 1, num_segments=self.num_frames, jitter=False)
            else:
                grid = sampling.uniform_test_indices(
                    n, num_segment=self.num_frames,
                    test_num_segment=self.test_num_segment)
                ids = grid[chunk_nb::self.test_num_segment]
            ids = np.clip(ids, 0, n - 1)
            frames = vr.get_batch(ids)
        out = {
            "clip": frames,
            "label": np.int32(self._label(e)),
            "video_idx": np.int32(entry_idx),
            "chunk_nb": np.int32(chunk_nb),
            "split_nb": np.int32(split_nb),
        }
        if self.boxes is not None:
            out["boxes"] = self.boxes.get(MotionBoxIndex.video_key(path), ids)
        return out
