"""Host-side input pipeline: the sampler, synthetic clips and a prefetching
loader that feeds the device.

Counterpart of mofo_tpu/data/pipeline.py (:66-98, 253-454), which replaces
torch DataLoader + DistributedSampler (run_mae_pretraining.py:187-206). Host
work stays thin: fixed-size uint8 frames are stacked into a batch, and all
augmentation runs batched on the device (ops.augment).

  ShardedSampler       — DistributedSampler semantics: a per-epoch seeded
                         permutation, padded to a multiple of the world
                         size, strided per process
  SyntheticClipDataset — random uint8 clips (+ labels, boxes) from a seed
  MultiViewDataset     — a dataset's clips as test_num_segment x
                         test_num_crop views tagged (chunk_nb, split_nb), as
                         the reference's test datasets expand them
  collate              — stacks samples into numpy batch arrays
  PrefetchLoader       — a background thread batches (num_workers threads
                         fetch the samples of one batch), pins the batch and
                         the consumer moves it to the device

PretrainClipDataset (video decoding through native/decoder) and the
loader's process mode and multi-process sharding are not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core.device import DeviceLike, resolve_device


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


@dataclasses.dataclass
class MultiViewDataset:
    """Each clip of `base` as num_segment x num_crop test views tagged
    (chunk_nb, split_nb), the way the reference's test datasets expand each
    video (ssv2.py:68-77). Views are ordered split-major, so that a batch
    mostly holds one spatial window; the view's pixels are the base
    sample's (the synthetic clips have no segments to sample), the window
    is test_view_augment's."""

    base: object
    num_segment: int = 2
    num_crop: int = 3

    def __len__(self) -> int:
        return len(self.base) * self.num_segment * self.num_crop

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        n = len(self.base)
        split, rest = divmod(i, n * self.num_segment)
        chunk, video = divmod(rest, n)
        out = dict(self.base[video])
        out["chunk_nb"], out["split_nb"] = np.int32(chunk), np.int32(split)
        return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchLoader:
    """Background loader: sample -> batch -> pinned host tensors -> device.

    - A background thread assembles up to `prefetch` batches ahead; with
      num_workers > 1 the samples of a batch are fetched concurrently in a
      thread pool (the reference's DataLoader(num_workers) per rank).
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
                 drop_last: bool = True, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        n = len(self.sampler.indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, sel, pool) -> Dict[str, torch.Tensor]:
        if pool is not None and len(sel) > 1:
            samples = list(pool.map(lambda i: self.dataset[int(i)], sel))
        else:
            samples = [self.dataset[int(i)] for i in sel]
        batch = {k: torch.from_numpy(v) for k, v in collate(samples).items()}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _batches(self, put, stop: threading.Event) -> None:
        """Runs in the background thread: puts every batch, then None."""
        pool = (cf.ThreadPoolExecutor(self.num_workers)
                if self.num_workers > 1 else None)
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
            if pool is not None:
                pool.shutdown(wait=True)
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

        worker = threading.Thread(target=self._batches, args=(put, stop),
                                  daemon=True)
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
