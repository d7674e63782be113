"""Head-major attention: reference-parity math and the dispatcher.

Counterpart of mofo_tpu/ops/attention.py:
  - xla_attention (:40-74): the reference's naive O(N^2) attention
    (modeling_finetune.py:88-95) with the softmax in float32, as plain
    tensor math (the JAX package leaves it to XLA; it is no kernel);
  - dot_product_attention (:77-127): "auto" takes the flash kernel (K4,
    ops.flash_attention.flash_attention) for sequences of at least
    _PALLAS_MIN_SEQ tokens whose q and kv lengths agree, and xla_attention
    otherwise; "pallas" always takes the kernel, "xla" never. Unlike the
    JAX "auto", the choice depends on shapes only, never on the device: the
    device only chooses between a kernel and its plain version.
"""

from __future__ import annotations

import torch

from mofo_tpu_torch.ops.flash_attention import flash_attention

# Sequences at least this long take the flash kernel under "auto"
# (mofo_tpu/ops/attention.py:24-30).
_PALLAS_MIN_SEQ = 128


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


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention entry point. q, k, v: (B, H, N, Dh)."""
    if impl == "auto":
        long_self = q.shape[2] >= _PALLAS_MIN_SEQ and q.shape[2] == k.shape[2]
        impl = "pallas" if long_self else "xla"
    if impl == "pallas":
        return flash_attention(q, k, v, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (auto, xla, "
                         "pallas)")
    return xla_attention(q, k, v, scale=scale)
