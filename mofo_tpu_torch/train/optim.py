"""AdamW with per-step LR / WD schedules, the no-decay mask, global-norm
clipping and layer-wise LR decay, as plain tensor code.

Counterpart of the AdamW path of mofo_tpu/train/optim.create_optimizer
(:500-670), whose optax chain is
    [clip_by_global_norm] -> scale_by_adam -> + wd(t) * p (masked)
        -> * lr_scale (per parameter, layer decay) -> * -lr(t)
The update below repeats that chain operation for operation, so the two
packages agree to f32 rounding (reference semantics: torch AdamW,
p -= lr * lr_scale * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the
groups of optim_factory.get_parameter_groups and the scales of
LayerDecayValueAssigner). Parameters and moments are updated in place.
With `trainable` (--only_finetune_last) the other parameters get neither
moments nor updates (mofo_tpu/train/optim.py:514, 621-633: optax.masked
moments and exact-zero updates); the global-norm clip still sees every
gradient, as it does there. The rest of the optimizer zoo is not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

NO_DECAY_NAMES = ("pos_embed", "cls_token", "mask_token")


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    """ndim <= 1, names ending in 'bias', and the no_weight_decay set get
    no weight decay (optim_factory.py:49-88)."""
    return (
        param.ndim <= 1
        or name.endswith("bias")
        or any(part in NO_DECAY_NAMES for part in name.split("."))
    )


def decay_mask(params: Params) -> Dict[str, bool]:
    """name -> True where weight decay applies."""
    return {n: not is_no_decay(n, p) for n, p in params.items()}


def layer_id_for_name(name: str, num_layers: int) -> int:
    """get_num_layer_for_vit (optim_factory.py:24-35) on the port's
    parameter names, skipping the BB-focused model's 'backbone.' prefix
    (mofo_tpu/train/optim.py:78-95): 0 for the patch embedding and tokens,
    i + 1 for blocks.i, num_layers - 1 for everything else."""
    parts = name.split(".")
    if parts[0] == "backbone":
        parts = parts[1:]
    head = parts[0]
    if head in NO_DECAY_NAMES or head.startswith("patch_embed"):
        return 0
    if head == "blocks" and len(parts) > 1 and parts[1].isdigit():
        return int(parts[1]) + 1
    return num_layers - 1


def infer_depth(names: Iterable[str]) -> int:
    """Block depth from the parameter names (the largest blocks.i plus
    one), 12 when there are no blocks (mofo_tpu/train/optim.py:98-112)."""
    depth = 0
    for name in names:
        parts = name.split(".")
        for a, b in zip(parts, parts[1:]):
            if a == "blocks" and b.isdigit():
                depth = max(depth, int(b) + 1)
    return depth or 12


def layer_decay_scales(params: Params, depth: int,
                       layer_decay: float) -> Dict[str, float]:
    """name -> layer_decay ** (depth + 1 - layer_id)
    (run_class_finetuning.py:441-443)."""
    num_layers = depth + 2
    values = [layer_decay ** (depth + 1 - i) for i in range(num_layers)]
    return {n: values[layer_id_for_name(n, num_layers)] for n in params}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm in f32 (reference get_grad_norm_, utils.py:376-388):
    the norm of the per-tensor norms, a few launches for any count."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far: indexes the schedules
    mu: Params
    nu: Params


class AdamW:
    """optax's scale_by_adam -> scheduled decoupled weight decay -> the
    per-parameter lr scale (layer decay) -> -lr(t), after an optional
    clip_by_global_norm; only the `trained` parameters (all by default)
    have moments and are updated."""

    def __init__(self, params: Params, *, lr_schedule: np.ndarray,
                 wd_schedule: Optional[np.ndarray] = None,
                 weight_decay: float = 0.05,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None,
                 lr_scales: Optional[Dict[str, float]] = None,
                 trained: Optional[Iterable[str]] = None):
        self.mask = decay_mask(params)
        self.trained = list(params if trained is None else trained)
        self.lr_scales = lr_scales
        self.lr_schedule = np.asarray(lr_schedule, np.float32)
        self.wd_schedule = (
            None if wd_schedule is None
            else np.asarray(wd_schedule, np.float32)
        )
        self.weight_decay = np.float32(weight_decay)
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip_grad = clip_grad

    def init(self, params: Params) -> AdamWState:
        zeros = lambda: {n: torch.zeros_like(params[n])  # noqa: E731
                         for n in self.trained}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @staticmethod
    def _at(schedule: np.ndarray, count: int) -> float:
        return float(schedule[min(count, schedule.shape[0] - 1)])

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState,
               params: Params) -> None:
        """Applies one update to `params` and `state`, in place. Each line
        is one multi-tensor (foreach) operation over all parameters, in
        optax's order of operations and roundings."""
        names = self.trained
        g = [grads[n] for n in names]
        if self.clip_grad is not None and self.clip_grad > 0:
            g_norm = global_norm(grads.values())  # every gradient
            if not bool(g_norm < self.clip_grad):
                g = [(x / g_norm) * self.clip_grad for x in g]
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        # bias corrections in f32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        wd = (self.weight_decay if self.wd_schedule is None
              else self._at(self.wd_schedule, state.count))
        lr = self._at(self.lr_schedule, state.count)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        p = [params[n] for n in names]
        # mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        g1 = torch._foreach_mul(g, 1 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps)
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        # u += wd * p on the decayed parameters, then p += -lr * u
        decayed = [i for i, n in enumerate(names) if self.mask[n]]
        if decayed:
            torch._foreach_add_(
                [u[i] for i in decayed],
                torch._foreach_mul([p[i] for i in decayed], float(wd)),
            )
        if self.lr_scales is not None:
            groups: Dict[float, list] = {}
            for i, n in enumerate(names):
                groups.setdefault(self.lr_scales[n], []).append(u[i])
            for scale, group in groups.items():
                torch._foreach_mul_(group, scale)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)
        state.count = count


def create_optimizer(params: Params, *, opt: str = "adamw",
                     lr_schedule: np.ndarray,
                     wd_schedule: Optional[np.ndarray] = None,
                     weight_decay: float = 0.05,
                     betas: Tuple[float, float] = (0.9, 0.999),
                     eps: float = 1e-8,
                     clip_grad: Optional[float] = None,
                     layer_decay: Optional[float] = None,
                     depth: Optional[int] = None,
                     trainable: Optional[Callable[[str, torch.Tensor],
                                                  bool]] = None) -> AdamW:
    """The AdamW path of mofo_tpu.train.optim.create_optimizer. `params`
    maps the model's parameter names to its tensors. With layer_decay < 1
    each update is scaled by layer_decay_scales (depth inferred from the
    names unless given). trainable(name, tensor) picks the parameters that
    are trained (all without it); it must pick one."""
    if opt.lower() != "adamw":
        raise ValueError(f"optimizer {opt!r} is not ported yet (adamw only)")
    trained = None
    if trainable is not None:
        trained = [n for n, p in params.items() if trainable(n, p)]
        if not trained:
            raise ValueError("trainable selected no parameters (renamed "
                             "module?)")
    scales = None
    if layer_decay is not None and layer_decay < 1.0:
        scales = layer_decay_scales(
            params, infer_depth(params) if depth is None else depth,
            layer_decay)
    return AdamW(params, lr_schedule=lr_schedule, wd_schedule=wd_schedule,
                 weight_decay=weight_decay, betas=betas, eps=eps,
                 clip_grad=clip_grad, lr_scales=scales, trained=trained)
