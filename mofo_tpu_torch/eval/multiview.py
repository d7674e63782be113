"""Multi-clip x multi-crop test-time aggregation and EK-100 verb/noun
marginalization: a copy of mofo_tpu/eval/multiview.py (numpy only), which
the port keeps so that it imports nothing of the JAX package.

Reference behaviour: test datasets expand each video into (test_num_segment
x test_num_crop) views tagged (chunk_nb, split_nb) (ssv2.py:68-77); per
video, duplicate (chunk, split) rows are dropped, each view is softmaxed,
the views are averaged and top1 / top5 taken (engine_for_finetuning.py:
227-348). gather_across_processes merges every process's view rows, in
process order (mofo_tpu/eval/multiview.py:130-175, which replaces the
reference's per-rank prediction files, engine_for_finetuning.py:281-339);
the rows a sampler's wrap-padding repeats are dropped as duplicates by
merge_feats, as there.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.parallel import ddp


def softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


class MultiViewAggregator:
    """Accumulates per-view logits and computes video-level metrics.

    add(video_ids, chunk_ids, split_ids, logits, labels) may be called any
    number of times (once per eval batch); finalize() returns (top1, top5,
    per-video predictions)."""

    def __init__(self):
        self._rows: List[Tuple[str, int, int, np.ndarray, int]] = []

    def add(self, video_ids: Sequence, chunk_ids: Sequence[int],
            split_ids: Sequence[int], logits: np.ndarray,
            labels: Sequence[int]) -> None:
        logits = np.asarray(logits, dtype=np.float64)
        for vid, c, s, lg, lb in zip(video_ids, chunk_ids, split_ids, logits,
                                     labels):
            self._rows.append((str(vid), int(c), int(s), lg, int(lb)))

    def merge_feats(self) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
        """Drops duplicate (video, chunk, split) rows, softmaxes each view
        and averages them per video (engine_for_finetuning.py:299-324)."""
        feats: Dict[str, List[np.ndarray]] = {}
        labels: Dict[str, int] = {}
        seen = set()
        for vid, c, s, lg, lb in self._rows:
            if (vid, c, s) in seen:
                continue
            seen.add((vid, c, s))
            feats.setdefault(vid, []).append(softmax_np(lg))
            labels[vid] = lb
        return {vid: np.mean(v, axis=0) for vid, v in feats.items()}, labels

    def finalize(self) -> Tuple[float, float, Dict[str, int]]:
        """(top1 %, top5 %, {video: predicted class}) (compute_video,
        engine_for_finetuning.py:341-348)."""
        feats, labels = self.merge_feats()
        top1, top5, preds = [], [], {}
        for vid, feat in feats.items():
            label = labels[vid]
            pred = int(np.argmax(feat))
            preds[vid] = pred
            top1.append(1.0 if pred == label else 0.0)
            top5.append(1.0 if label in np.argsort(-feat)[:5] else 0.0)
        return (float(np.mean(top1)) * 100.0, float(np.mean(top5)) * 100.0,
                preds)


def gather_across_processes(agg: MultiViewAggregator,
                            group=None) -> MultiViewAggregator:
    """Every process's view rows in one aggregator, in process order: with
    one process, the aggregator itself. With a mesh's batch axis `group`,
    the rows of its ranks only (each batch coordinate's rows once, not once
    per model peer). Every process must call it."""
    size = distributed.process_count() if group is None else group.size
    if size == 1:
        return agg
    merged = MultiViewAggregator()
    for rows in ddp.all_gather_object(agg._rows, group):
        merged._rows.extend(rows)
    return merged


def get_marginal_indexes(action_to_vn: Sequence[Tuple[int, int]],
                         mode: str) -> List[np.ndarray]:
    """action_to_vn: (verb_id, noun_id) per action class index. Returns, per
    verb (or noun) id, the action indices that contain it (utils.py:
    584-606)."""
    col = 0 if mode == "verb" else 1
    ids = np.array([a[col] for a in action_to_vn])
    out = []
    for v in range(ids.max() + 1):
        vals = np.nonzero(ids == v)[0]
        out.append(vals if len(vals) > 0 else np.array([0]))
    return out


def marginalize(probs: np.ndarray, indexes: List[np.ndarray]) -> np.ndarray:
    """(B, n_actions) probabilities -> (B, n_verbs or n_nouns)."""
    return np.stack([probs[:, ilist].sum(1) for ilist in indexes], axis=1)


def action_label_space(verb_noun_pairs: Sequence[Tuple[int, int]]
                       ) -> Tuple[List[str], Dict[str, int]]:
    """The sorted 'verb:noun' action label space (generate_label_map,
    utils.py:556-582): (vn_list, mapping_vn2act). sorted() on the string
    keys ('10:1' < '2:1') is the reference's lexicographic class order."""
    vn_list = sorted({f"{v}:{n}" for v, n in verb_noun_pairs})
    return vn_list, {vn: i for i, vn in enumerate(vn_list)}
