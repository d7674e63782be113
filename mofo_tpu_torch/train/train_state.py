"""Train state: step, parameters, optimizer state and optional EMA.

Counterpart of mofo_tpu/train/train_state.py. `params` maps names to the
model's own parameter tensors, which the optimizer updates in place (the
JAX state is an immutable pytree; here the update saves a copy of the
weights and moments). `loss_scale` is the fp16 DynamicLossScale, None in
the other dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any
    ema_params: Optional[Params] = None
    loss_scale: Optional[Any] = None

    @classmethod
    def create(cls, model: torch.nn.Module, tx, use_ema: bool = False,
               loss_scale: Optional[Any] = None) -> "TrainState":
        params = dict(model.named_parameters())
        ema = (
            {n: p.detach().clone() for n, p in params.items()}
            if use_ema else None
        )
        return cls(step=0, params=params, opt_state=tx.init(params),
                   ema_params=ema, loss_scale=loss_scale)


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> None:
    """timm ModelEma rule, in place: ema = decay * ema + (1 - decay) * p."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(
        [params[n].to(ema[n].dtype) for n in names], 1.0 - decay
    ))
