"""Head-major attention: reference-parity math and the dispatcher.

Counterpart of mofo_tpu/ops/attention.py:
  - xla_attention (:40-74): the reference's naive O(N^2) attention
    (modeling_finetune.py:88-95) with the softmax in float32, an optional
    additive bias and attention dropout, as plain tensor math (the JAX
    package leaves it to XLA; it is no kernel);
  - dot_product_attention (:77-127): "auto" takes the flash kernel (K4,
    ops.flash_attention.flash_attention) for sequences of at least
    _PALLAS_MIN_SEQ tokens whose q and kv lengths agree, with no bias and
    no active dropout, and xla_attention otherwise; "pallas" always takes
    the kernel (and raises on a bias or active dropout, which it cannot
    apply), "xla" never. Unlike the JAX "auto", the choice depends on
    shapes and switches only, never on the device: the device only chooses
    between a kernel and its plain version;
  - keep_mask: every dropout mask of the port (attention dropout here,
    models.layers.dropout and drop path), drawn from an explicit
    torch.Generator.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mofo_tpu_torch.ops.flash_attention import flash_attention
from mofo_tpu_torch.parallel import ddp

# Sequences at least this long take the flash kernel under "auto"
# (mofo_tpu/ops/attention.py:24-30).
_PALLAS_MIN_SEQ = 128


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where the plain math accumulates: f32, or f64 for f64 inputs (the
    float64 parity curve of tools/parity_artifact.py)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def keep_mask(shape: Sequence[int], rate: float,
              generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool keep mask of `shape` (batch first), each entry kept with
    probability 1 - rate (jax.random.bernoulli's uniform < p), drawn from
    `generator` on `device` through ddp.per_sample, so W ranks draw the
    rows one process draws on the global batch."""
    if generator is None:
        raise ValueError(f"dropout at rate {rate} needs an explicit "
                         "torch.Generator")
    return ddp.per_sample(lambda s: torch.rand(
        s, generator=generator, device=device), shape) < 1.0 - rate


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    head_range: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """q, k, v: (B, H, N, Dh) -> (B, H, N, Dh). Logits (plus `bias`,
    broadcast to (B, H, Nq, Nk)) and softmax in f32 (f64 for f64 inputs);
    with dropout active (dropout_rate > 0, not deterministic) the
    probabilities become where(keep, p / (1 - rate), 0), `keep` drawn from
    `generator` by keep_mask; then they are cast back to the input dtype
    before P.V.
    head_range (first, total) marks q's H heads as heads first.. of a
    module of `total` heads split over a mesh's model axis: the keep mask
    is drawn for all `total` heads and these H kept, so that the ranks
    together draw what one process draws."""
    dtype, acc = q.dtype, acc_dtype(q.dtype)
    logits = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.to(acc)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        shape = probs.shape
        if head_range is not None:
            first, total = head_range
            shape = (shape[0], total) + tuple(shape[2:])
        keep = keep_mask(shape, dropout_rate, generator, probs.device)
        if head_range is not None:
            keep = keep[:, first:first + probs.shape[1]]
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.matmul(probs.to(dtype), v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
    head_range: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Dispatching attention entry point. q, k, v: (B, H, N, Dh);
    head_range as xla_attention's."""
    drop_active = dropout_rate > 0.0 and not deterministic
    if impl == "auto":
        long_self = q.shape[2] >= _PALLAS_MIN_SEQ and q.shape[2] == k.shape[2]
        use_kernel = long_self and bias is None and not drop_active
        impl = "pallas" if use_kernel else "xla"
    if impl == "pallas":
        # the kernel applies neither a bias nor attention dropout: refuse
        # rather than drop them
        if bias is not None:
            raise ValueError(
                "impl='pallas' does not support an attention bias; use "
                "impl='xla' (or 'auto')."
            )
        if drop_active:
            raise ValueError(
                "impl='pallas' does not support attention dropout "
                f"(attn_drop_rate={dropout_rate}); use impl='xla' (or "
                "'auto', which falls back when dropout is active)."
            )
        return flash_attention(q, k, v, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} (auto, xla, "
                         "pallas)")
    return xla_attention(q, k, v, scale=scale, bias=bias,
                         dropout_rate=dropout_rate,
                         deterministic=deterministic, generator=generator,
                         head_range=head_range)
