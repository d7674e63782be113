"""Host-side input pipeline: datasets, the sampler and a prefetching loader
that feeds the device.

Counterpart of mofo_tpu/data/pipeline.py, which replaces torch DataLoader +
DistributedSampler (run_mae_pretraining.py:187-206). Host work stays thin:
fixed-size uint8 frames are decoded (the native decoder scales while it
decodes) and stacked into a batch; all augmentation runs batched on the
device (ops.augment).

  ShardedSampler       — DistributedSampler semantics: a per-epoch seeded
                         permutation, padded to a multiple of the world
                         size, strided per process
  PretrainClipDataset  — a file list + TSN sampling (+ motion boxes)
  FinetuneClipDataset  — classification clips: dense (Kinetics) / uniform
                         (SSV2) samplers, train / validation / test modes,
                         test mode expanded into (chunk, split) views
  SyntheticClipDataset — random uint8 clips (+ labels, boxes) from a seed
  collate              — stacks samples into numpy batch arrays
  PrefetchLoader       — a background thread batches (num_workers threads
                         or forked processes fetch the samples of one
                         batch), pins the batch and the consumer moves it
                         to the device

The datasets draw their random frame ids from the process-global np.random,
as the reference's do: after np.random.seed(s) a dataset returns the
reference's samples. They open videos through their `reader` field, a
callable (path, width=, height=) -> an object with __len__, get_batch and
the context manager; VideoReader unless a test or a check on the card gives
an in-memory one.

With W processes each rank's sampler takes its stride rank::W of the
epoch's permutation, padded by wrapping to a multiple of W (validation
too, as mofo_tpu/data/pipeline.py:66-69 pads), so every rank makes the same
number of batches, and its loader pins them and copies them to the rank's
own device (cuda:<local rank>).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import multiprocessing as mp
import os
import pickle
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core.device import DeviceLike, resolve_device
from mofo_tpu_torch.data import sampling
from mofo_tpu_torch.data.filelist import ClipEntry, MotionBoxIndex
from mofo_tpu_torch.data.video_reader import VideoReader


@functools.lru_cache(maxsize=65536)
def _entry_loadable(path: str, reader: Callable = VideoReader) -> bool:
    """The reference's bad-video guards (kinetics.py:229-243): exists, at
    least 1 KB, decodable. Cached per (path, reader) for the life of the
    process."""
    if not os.path.exists(path) or os.path.getsize(path) < 1024:
        return False
    try:
        with reader(path) as vr:
            return len(vr) > 0
    except (RuntimeError, OSError):
        return False


def _resilient_entry(entries, i: int, reader: Callable = VideoReader):
    """Skip-and-resample on corrupt or missing videos (the reference's
    while-loop resample in __getitem__, kinetics.py:92-97, 229-243): up to
    10 draws from the global np.random."""
    entry = entries[i]
    tries = 0
    while not _entry_loadable(entry.path, reader) and tries < 10:
        j = int(np.random.randint(len(entries)))
        print(f"video {entry.path} not loadable; resampling index {j}")
        entry = entries[j]
        tries += 1
    return entry


class ShardedSampler:
    """Per-epoch shuffled, per-process strided index sampler (torch
    DistributedSampler semantics: pad to a multiple of world size by
    wrapping, then take rank::world)."""

    def __init__(self, n: int, rank: int = 0, world: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.n = n
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(
                self.n)
        else:
            order = np.arange(self.n)
        total = ((self.n + self.world - 1) // self.world) * self.world
        if total > self.n:
            order = np.concatenate([order, order[: total - self.n]])
        return order[self.rank::self.world]


@dataclasses.dataclass
class PretrainClipDataset:
    """Decoded clips for MAE pretraining (the VideoMAE / VideoMAE_BB
    datasets, kinetics.py:377-561, 996-1064): uint8 frames at a fixed
    decoded size; masking and augmentation happen on the device."""

    entries: Sequence[ClipEntry]
    num_frames: int = 16
    sampling_rate: int = 2
    decode_size: Tuple[int, int] = (256, 320)  # (h, w)
    boxes: Optional[MotionBoxIndex] = None
    pin_seed: bool = False  # the reference's np.random.seed(10) quirk
    reader: Callable = VideoReader

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        entry = _resilient_entry(self.entries, i, self.reader)
        h, w = self.decode_size
        with self.reader(entry.path, width=w, height=h) as vr:
            ids = sampling.tsn_frame_ids(
                len(vr), skip_length=self.num_frames * self.sampling_rate,
                new_step=self.sampling_rate, pin_seed=self.pin_seed,
                rng=np.random)
            frames = vr.get_batch(ids)
        out = {"clip": frames}
        if self.boxes is not None:
            # the boxes stay in the factory's pixel space, which decode_size
            # must match (the reference hardcodes both to one preprocessed
            # resolution, kinetics.py:915-917); the step's augment_fn maps
            # them through the crop
            out["boxes"] = self.boxes.get(MotionBoxIndex.video_key(
                entry.path), ids)
        return out


def expand_views(n_entries: int, segments: int,
                 crops: int) -> List[Tuple[int, int, int]]:
    """The (entry, chunk_nb, split_nb) of every test view, entry-major, as
    the reference's test datasets expand each video (ssv2.py:68-77)."""
    return [(i, c, s) for i in range(n_entries) for c in range(segments)
            for s in range(crops)]


@dataclasses.dataclass
class FinetuneClipDataset:
    """Classification clips (VideoClsDataset / SSVideoClsDataset). mode:
    train | validation | test. In test mode each entry is expanded into
    test_num_segment x test_num_crop views tagged (chunk_nb, split_nb)."""

    entries: Sequence[ClipEntry]
    mode: str = "train"
    sampler: str = "uniform"  # dense | uniform
    num_frames: int = 16
    frame_sample_rate: int = 4  # the dense sampler's stride
    decode_size: Tuple[int, int] = (256, 320)
    test_num_segment: int = 2
    test_num_crop: int = 3
    boxes: Optional[MotionBoxIndex] = None
    reader: Callable = VideoReader

    def __post_init__(self):
        assert self.sampler in ("dense", "uniform"), self.sampler
        if self.mode == "test":
            self._views = expand_views(len(self.entries),
                                       self.test_num_segment,
                                       self.test_num_crop)

    def __len__(self) -> int:
        if self.mode == "test":
            return len(self._views)
        return len(self.entries)

    def _frame_ids(self, duration: int, chunk_nb: int = 0) -> np.ndarray:
        if self.mode == "train":
            if self.sampler == "dense":
                return sampling.dense_train_indices(
                    duration, clip_len=self.num_frames,
                    frame_sample_rate=self.frame_sample_rate, rng=np.random)
            return sampling.uniform_train_indices(
                duration, num_segment=self.num_frames, rng=np.random)
        if self.mode == "validation":
            if self.sampler == "dense":
                return sampling.dense_test_indices(
                    duration, clip_len=self.num_frames,
                    frame_sample_rate=self.frame_sample_rate)
            # SSV2 validation: uniform mid-segment ticks
            tick = duration / float(self.num_frames)
            return np.asarray(
                [int(tick / 2.0 + tick * x) for x in range(self.num_frames)],
                dtype=np.int64)
        if self.sampler == "dense":
            # Kinetics-style: the full strided enumeration, then a temporal
            # window offset by chunk_nb (kinetics.py:144-155, 246-252)
            all_idx = sampling.dense_test_indices(
                duration, clip_len=self.num_frames,
                frame_sample_rate=self.frame_sample_rate)
            n = len(all_idx)
            if n > self.num_frames:
                start = int(round((n - self.num_frames) * chunk_nb
                                  / max(self.test_num_segment - 1, 1)))
                return all_idx[start:start + self.num_frames]
            return all_idx
        # SSV2-style: the tick grid; the chunk takes [chunk_nb::segments]
        grid = sampling.uniform_test_indices(
            duration, num_segment=self.num_frames,
            test_num_segment=self.test_num_segment)
        return grid[chunk_nb::self.test_num_segment]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self.mode == "test":
            entry_idx, chunk_nb, split_nb = self._views[i]
        else:
            entry_idx, chunk_nb, split_nb = i, 0, 0
        entry = _resilient_entry(self.entries, entry_idx, self.reader)
        h, w = self.decode_size
        with self.reader(entry.path, width=w, height=h) as vr:
            ids = np.clip(self._frame_ids(len(vr), chunk_nb), 0, len(vr) - 1)
            frames = vr.get_batch(ids)
        out = {
            "clip": frames,
            "label": np.int32(entry.label),
            "video_idx": np.int32(entry_idx),
            "chunk_nb": np.int32(chunk_nb),
            "split_nb": np.int32(split_nb),
        }
        if self.boxes is not None:
            out["boxes"] = self.boxes.get(MotionBoxIndex.video_key(
                entry.path), ids)
        return out


@dataclasses.dataclass
class SyntheticClipDataset:
    """Random uint8 clips (+ labels / boxes) for tests and benchmarks; sample
    i is drawn from np.random.RandomState(seed + i)."""

    n: int = 64
    num_frames: int = 16
    decode_size: Tuple[int, int] = (256, 320)
    num_classes: int = 10
    with_boxes: bool = False
    seed: int = 0

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + i)
        h, w = self.decode_size
        out = {
            "clip": rng.randint(0, 256, (self.num_frames, h, w, 3),
                                dtype=np.uint8),
            "label": np.int32(rng.randint(self.num_classes)),
            "video_idx": np.int32(i),
            "chunk_nb": np.int32(0),
            "split_nb": np.int32(0),
        }
        if self.with_boxes:
            x1 = rng.randint(0, w // 2)
            y1 = rng.randint(0, h // 2)
            box = [x1, y1, x1 + rng.randint(8, w // 2),
                   y1 + rng.randint(8, h // 2)]
            out["boxes"] = np.tile(np.asarray(box, np.float32),
                                   (self.num_frames, 1))
        return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# process workers: module-level so that they pickle; each worker unpickles
# the dataset once, when the pool starts (mofo_tpu/data/pipeline.py:294-305)
_PROC_DATASET = None


def _proc_init(dataset_bytes: bytes) -> None:
    global _PROC_DATASET
    _PROC_DATASET = pickle.loads(dataset_bytes)


def _proc_getitem(i: int):
    return _PROC_DATASET[i]


class PrefetchLoader:
    """Background loader: sample -> batch -> pinned host tensors -> device.

    - A background thread assembles up to `prefetch` batches ahead; with
      num_workers > 1 the samples of a batch are fetched concurrently in a
      thread pool (the reference's DataLoader(num_workers) per rank; FFmpeg
      decode releases the GIL). The threads share the process's np.random,
      from which the datasets draw (ROADMAP Queue 3).
    - worker_mode="process" fetches them in a pool of num_workers processes
      instead, for datasets whose Python work holds the GIL. The pool is
      forked when iteration starts, from the consumer's thread, and each
      worker unpickles the dataset once: as in mofo_tpu, every worker
      starts from the parent's np.random state at that moment (spawn would
      draw other frame ids). The workers only decode on the host and never
      touch CUDA, which a forked child of a process with CUDA up must not.
    - On a CUDA device each batch is pinned on the host and copied without
      blocking the host (the copy is ordered on the current stream).
    - drop_last=False pads the final partial batch up to batch_size by
      wrapping to the front of the index list (DistributedSampler-style);
      padded rows are False in the emitted "valid" mask.
    - An exception raised while fetching is raised again in the consumer.
    """

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 device: DeviceLike = None, prefetch: int = 2,
                 drop_last: bool = True, num_workers: int = 1,
                 worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: thread or process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.worker_mode = worker_mode

    def __len__(self) -> int:
        n = len(self.sampler.indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _pool(self):
        """The workers of one iteration (None with one worker)."""
        if self.num_workers == 1:
            return None
        if self.worker_mode == "thread":
            return cf.ThreadPoolExecutor(self.num_workers)
        pool = cf.ProcessPoolExecutor(
            self.num_workers, mp_context=mp.get_context("fork"),
            initializer=_proc_init, initargs=(pickle.dumps(self.dataset),))
        pool.submit(int).result()  # fork every worker now, in this thread
        return pool

    def _fetch(self, sel, pool) -> Dict[str, torch.Tensor]:
        if pool is not None and len(sel) > 1:
            if self.worker_mode == "process":
                samples = list(pool.map(_proc_getitem,
                                        [int(i) for i in sel]))
            else:
                samples = list(pool.map(lambda i: self.dataset[int(i)], sel))
        else:
            samples = [self.dataset[int(i)] for i in sel]
        batch = {k: torch.from_numpy(v) for k, v in collate(samples).items()}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _batches(self, put, stop: threading.Event, pool) -> None:
        """Runs in the background thread: puts every batch, then None."""
        try:
            idxs = self.sampler.indices()
            for b in range(len(self)):
                if stop.is_set():
                    return
                sel = idxs[b * self.batch_size:(b + 1) * self.batch_size]
                n_real = len(sel)
                if not self.drop_last and n_real < self.batch_size:
                    sel = np.concatenate(
                        [sel, np.resize(idxs, self.batch_size - n_real)])
                batch = self._fetch(sel, pool)
                if not self.drop_last:
                    valid = np.zeros(len(sel), dtype=bool)
                    valid[:n_real] = True
                    batch["valid"] = torch.from_numpy(valid)
                put(batch)
        except Exception as e:  # surfaced to the consumer, which raises it
            put(e)
        finally:
            put(None)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        pool = self._pool()
        worker = threading.Thread(target=self._batches,
                                  args=(put, stop, pool), daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield {k: v.to(self.device, non_blocking=True)
                       for k, v in item.items()}
        finally:
            stop.set()
            worker.join(timeout=10)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
