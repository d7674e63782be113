"""Classification losses and top-k metrics.

Counterpart of mofo_tpu/train/losses.py. Criterion selection mirrors
run_class_finetuning.py:476-495: mixup active -> soft-target cross
entropy; label smoothing > 0 -> label-smoothing cross entropy; otherwise
plain cross entropy. Log-softmax runs in f32.
"""

from __future__ import annotations

import torch


def _logp(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _nll(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -torch.gather(logp, -1, targets.long()[:, None])[:, 0]


def soft_target_cross_entropy(logits: torch.Tensor,
                              soft_targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: mean over the batch of
    -sum(target * log_softmax(logits))."""
    return torch.sum(-soft_targets * _logp(logits), dim=-1).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor,
                                  targets: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy."""
    logp = _logp(logits)
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * _nll(logp, targets)
            + smoothing * smooth).mean()


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    return _nll(_logp(logits), targets).mean()


def cross_entropy_per_sample(logits: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    return _nll(_logp(logits), targets)


def topk_hits(logits: torch.Tensor, targets: torch.Tensor,
              topk=(1,)) -> tuple:
    """Per-sample top-k hit indicators (f32 0/1); ties rank in index order,
    as the JAX package's stable argsort ranks them."""
    ranks = torch.argsort(-logits, dim=-1, stable=True)
    return tuple(
        (ranks[:, :k] == targets.long()[:, None]).any(dim=-1).float()
        for k in topk
    )


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             topk=(1,)) -> tuple:
    """timm accuracy: top-k percentages (0..100)."""
    return tuple(h.mean() * 100.0 for h in topk_hits(logits, targets, topk))
