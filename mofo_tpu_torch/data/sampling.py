"""Frame-index samplers: a copy of mofo_tpu/data/sampling.py (numpy only),
which the port keeps so that it imports nothing of the JAX package.

Each reproduces one of the reference's sampling strategies exactly: the
same arithmetic and, given the process-global numpy RNG (np.random), the
same RNG call sequence. The global RNG is the contract: the datasets draw
from it as the reference's do, so a seed gives the reference's samples.

  tsn_frame_ids          — pretraining TSN segment sampling + the decode
                           walk (kinetics.py:518-561). The reference calls
                           np.random.seed(10) per video (kinetics.py:520),
                           which makes the clip choice deterministic per
                           duration; pin_seed=True reproduces that quirk,
                           the default uses the caller's rng.
  dense_train_indices    — Kinetics-style strided dense clips
                           (kinetics.py:253-271)
  dense_test_indices     — full-video stride enumeration
                           (kinetics.py:246-252)
  uniform_train_indices  — SSV2 TSN uniform sampling (ssv2.py:249-258)
  uniform_test_indices   — SSV2 test tick grid, half-offset + zero-offset
                           views, sorted (ssv2.py:238-247); the chunk is
                           buffer[temporal_start::2] downstream
  timestamp_frame_ids    — EK jittered uniform ids over a [start, end]
                           frame window (epic_kitchens.py:967-974)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _rng(rng: Optional[np.random.RandomState]):
    return rng if rng is not None else np.random


def tsn_frame_ids(num_frames: int, *, num_segments: int = 1,
                  skip_length: int = 32, new_step: int = 2,
                  temporal_jitter: bool = False,
                  rng: Optional[np.random.RandomState] = None,
                  pin_seed: bool = False) -> np.ndarray:
    """Frame ids for one pretraining clip. The defaults are the pretrain
    recipe's: 16 frames x sampling rate 2 => skip_length 32. Returns
    skip_length // new_step ids per segment."""
    if pin_seed:
        np.random.seed(10)
        r = np.random
    else:
        r = _rng(rng)

    average_duration = (num_frames - skip_length + 1) // num_segments
    if average_duration > 0:
        offsets = np.multiply(list(range(num_segments)), average_duration) \
            + r.randint(average_duration, size=num_segments)
    elif num_frames > max(num_segments, skip_length):
        offsets = np.sort(r.randint(num_frames - skip_length + 1,
                                    size=num_segments))
    else:
        offsets = np.zeros((num_segments,), dtype=np.int64)
    offsets = offsets + 1

    if temporal_jitter:
        skip_offsets = r.randint(new_step, size=skip_length // new_step)
    else:
        skip_offsets = np.zeros(skip_length // new_step, dtype=int)

    # the decode walk (kinetics.py:543-555)
    frame_ids: List[int] = []
    for seg_ind in offsets:
        offset = int(seg_ind)
        for i in range(0, skip_length // new_step):
            if offset + skip_offsets[i] <= num_frames:
                frame_ids.append(offset + skip_offsets[i] - 1)
            else:
                frame_ids.append(offset - 1)
            if offset + new_step < num_frames:
                offset += new_step
    return np.asarray(frame_ids, dtype=np.int64)


def dense_train_indices(num_frames: int, *, clip_len: int = 16,
                        frame_sample_rate: int = 4, num_segment: int = 1,
                        sample_rate_scale: int = 1,
                        rng: Optional[np.random.RandomState] = None
                        ) -> np.ndarray:
    """Kinetics-style dense strided clip (kinetics.py:253-271)."""
    r = _rng(rng)
    converted_len = int(clip_len * frame_sample_rate)
    seg_len = num_frames // num_segment
    all_index: List[int] = []
    for i in range(num_segment):
        if seg_len <= converted_len:
            index = np.linspace(0, seg_len, num=seg_len // frame_sample_rate)
            index = np.concatenate((index, np.ones(
                clip_len - seg_len // frame_sample_rate) * seg_len))
            index = np.clip(index, 0, seg_len - 1).astype(np.int64)
        else:
            end_idx = r.randint(converted_len, seg_len)
            str_idx = end_idx - converted_len
            index = np.linspace(str_idx, end_idx, num=clip_len)
            index = np.clip(index, str_idx, end_idx - 1).astype(np.int64)
        all_index.extend(list(index + i * seg_len))
    return np.asarray(all_index[::sample_rate_scale], dtype=np.int64)


def dense_test_indices(num_frames: int, *, clip_len: int = 16,
                       frame_sample_rate: int = 4) -> np.ndarray:
    """Full-video stride enumeration for test mode (kinetics.py:246-252)."""
    all_index = list(range(0, num_frames, frame_sample_rate))
    while len(all_index) < clip_len:
        all_index.append(all_index[-1])
    return np.asarray(all_index, dtype=np.int64)


def uniform_train_indices(num_frames: int, *, num_segment: int = 16,
                          rng: Optional[np.random.RandomState] = None
                          ) -> np.ndarray:
    """SSV2 TSN uniform sampling (ssv2.py:249-258)."""
    r = _rng(rng)
    average_duration = num_frames // num_segment
    if average_duration > 0:
        idx = np.multiply(list(range(num_segment)), average_duration) \
            + r.randint(average_duration, size=num_segment)
    elif num_frames > num_segment:
        idx = np.sort(r.randint(num_frames, size=num_segment))
    else:
        idx = np.zeros((num_segment,))
    return np.asarray(idx, dtype=np.int64)


def uniform_test_indices(num_frames: int, *, num_segment: int = 16,
                         test_num_segment: int = 2) -> np.ndarray:
    """SSV2 test tick grid (ssv2.py:238-247): half-offset + zero-offset
    views interleaved by sorting; callers take [chunk_nb::2]."""
    tick = num_frames / float(num_segment)
    all_index = [int(tick / 2.0 + tick * x) for x in range(num_segment)] + [
        int(tick * x) for x in range(num_segment)]
    while len(all_index) < num_segment * test_num_segment:
        all_index.append(all_index[-1])
    return np.sort(np.asarray(all_index, dtype=np.int64))


def timestamp_frame_ids(start_frame: int, end_frame: int, *,
                        num_segments: int = 16, jitter: bool = True,
                        rng: Optional[np.random.RandomState] = None
                        ) -> np.ndarray:
    """EK clip sampling between action-segment timestamps
    (epic_kitchens.py:967-974)."""
    r = _rng(rng)
    frame_ids = np.convolve(
        np.linspace(start_frame, end_frame, num_segments + 1), [0.5, 0.5],
        mode="valid")
    if jitter:
        seg_size = float(end_frame - start_frame - 1) / num_segments
        shift = (r.rand(num_segments) - 0.5) * seg_size
        frame_ids = frame_ids + shift
    return frame_ids.astype(np.int64)
