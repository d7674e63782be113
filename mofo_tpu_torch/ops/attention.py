"""Reference-parity attention math, head-major.

Counterpart of mofo_tpu/ops/attention.py's xla_attention (:40-74): the
reference's naive O(N^2) attention (modeling_finetune.py:88-95) with the
softmax in float32. The port's blocks run flash_attention_qkv; this is
the tests' oracle and nothing on the training path calls it.
"""

from __future__ import annotations

import torch


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """q, k, v: (B, H, N, Dh) -> (B, H, N, Dh). Logits and softmax in f32,
    probabilities cast back to the input dtype before P.V."""
    dtype = q.dtype
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(probs, v)
