"""The optimizer zoo: per-step LR / WD schedules, the no-decay mask,
global-norm clipping, layer-wise LR decay, --only_finetune_last, every
--opt name of mofo_tpu and AdaHessian's Hutchinson probe, as plain tensor
code.

Counterpart of mofo_tpu/train/optim.py (create_optimizer, :500-670), whose
optax chain is
    [clip_by_global_norm] -> moments -> + wd(t) * p (masked)
        -> * lr_scale (per parameter, layer decay) -> * 0 (frozen)
        -> * -lr(t) -> [lookahead]
Here the chain is the same list of stages over name-indexed tensors, in
multi-tensor (foreach) operations where the stage allows them, and the
parameters and the state are updated in place. The moment stages follow
optax 0.2.6 at the arguments mofo_tpu passes (its defaults otherwise):
  adam, adamw       scale_by_adam;  nadam: scale_by_adam(nesterov=True)
  sgd, nesterov     trace(momentum, nesterov=True); momentum: nesterov=False
  lamb              scale_by_adam, then the trust ratio on the Adam update
                    (before the decoupled decay, unlike timm's LAMB)
  lars              the trust ratio on the raw gradient, then trace
  adafactor         scale_by_factored_rms (decay 0.8, factor from 128, 1e-30)
  rmsprop           scale_by_rms(decay=0.9, eps)
  adadelta, lion, radam, novograd, adamax, yogi, adagrad (scale_by_rss from
  0), adabelief     their optax transforms
  adamp, sgdp       mofo_tpu's scale_by_adamp / scale_by_sgdp (nesterov):
                    the scale-invariance projection, their own decay
  adahessian        mofo_tpu's scale_by_adahessian: the second moment is the
                    EMA of the Hutchinson estimate (z * Hz)^2
fused* and nvnovograd are aliases; a lookahead_ prefix wraps any of them
(k = 6, alpha = 0.5, the last link, on real parameter deltas). adam, adamp
and sgdp get no decoupled decay stage: plain adam decays nothing, as in
mofo_tpu (not torch Adam's coupled decay). With `trainable` every entry but
adamp, sgdp and adahessian keeps moments for the trained parameters only
(optax.masked); those three keep and update moments for all and their
frozen parameters get no update; the clip sees every gradient.

The AdamW path runs the same operations in the same order as before the zoo
(bit for bit), and agrees with mofo_tpu to f32 rounding. AdamP's channel
view and Adafactor's factored axes are taken on mofo_tpu's layout of a
parameter (train/checkpoint.py's jax_layout, from the tables that carry
weights between the packages): Dense kernels there are (in, out), the
port's Linear weights (out, in); the patch embedding there is (t*p*p*C, D),
here a Conv3d (D, C, t, p, p).

On a mesh with an fsdp or model axis (parallel/mesh.py; create_optimizer's
`sharding`) the parameters, the gradients, the moments and the lookahead's
slow weights are this rank's shards, and every elementwise stage runs on
them as it is. What reads a whole tensor takes it over its shards: the
clip's global norm and the per-tensor norms of TrustRatio (lamb, lars) and
Novograd (Sharding.norms: each shard's squares summed over the axes its
parameter is cut on, a replicated one counted once). The stages that read
a tensor's layout or its rows take mofo_tpu's layout of the whole
parameter (mofo_tpu/train/optim.py:238-384, :573, where GSPMD shards the
state and inserts the reductions; here Sharding.sum_over does, one
all-reduce a mesh axis for all parameters):
  FactoredRMS   factored_dims on the full shape (a shard may fall under
                min_dim or swap equal sides); the row and column means are
                local sums, summed over the axis that cuts the reduced
                axis and divided by its full length, as is the mean of
                v_row; v_row and v_col stay cut where the parameter is
                (Sharding.reduced_layout, the checkpoints' layout of them)
  AdamP, SGDP   adamp_project_sharded: each channel row's dot product and
                squared norms summed over the axes that cut the other jax
                axes, the layer view's over every cutting axis; the channel
                view's max decided by a sum of the rows at or above the
                threshold over the axis that cuts the rows (exact, and the
                same on every rank); dim_ch and dim_ly from the full shape
  AdaHessian    elementwise; its probe (hutchinson_diag) is drawn whole
                and sharded (rademacher), and differentiated through the
                mesh's twice-differentiable collectives
                (parallel/tensor_parallel.py)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mofo_tpu_torch.parallel.mesh import Layout
from mofo_tpu_torch.train.checkpoint import jax_layout, torch_layout

Params = Dict[str, torch.Tensor]
Tensors = List[torch.Tensor]

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


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------


def _bc(b: float, n: int) -> float:
    """1 - b^n in f32, as optax computes its bias corrections."""
    return float(np.float32(1) - np.float32(b) ** np.float32(n))


def _ema(avg: Tensors, x: Tensors, decay: float) -> None:
    """avg = (1 - decay) * x + decay * avg, in place."""
    x1 = torch._foreach_mul(x, 1 - decay)
    torch._foreach_mul_(avg, decay)
    torch._foreach_add_(avg, x1)


class Stage:
    """One link of the chain. `fields` name its per-parameter state,
    `keys` the checkpoint key of a field where the reference's torch
    optimizer has one (the field's own name otherwise). update(u, state,
    p, names, count, hessian_diag) maps the incoming updates to new
    tensors (it never writes into `u`) and updates the field lists of
    `state` in place; `count` is the number of updates applied before."""

    fields: Tuple[str, ...] = ()
    keys: Dict[str, str] = {}
    # parallel.mesh.Sharding on a mesh that cuts parameters (the optimizer
    # sets it), None otherwise
    sharding = None

    def norms(self, names: Sequence[str], ts: Tensors) -> Tensors:
        """Each tensor's whole f32 norm."""
        if self.sharding is None:
            return torch._foreach_norm(ts)
        return self.sharding.norms(names, ts)

    def init(self, name: str, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {f: torch.zeros_like(p) for f in self.fields}

    def layouts(self, name: str, p: torch.Tensor,
                lay: Layout) -> Dict[str, Layout]:
        """field -> where a mesh cuts its tensor of parameter `name`, whose
        own layout is `lay` (the checkpoints gather and shard by it)."""
        return dict.fromkeys(self.fields, lay)

    def update(self, u: Tensors, state: Dict[str, Tensors], p: Tensors,
               names: List[str], count: int,
               hessian_diag: Optional[Tensors]) -> Tensors:
        raise NotImplementedError


ADAM_KEYS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


class ScaleByAdam(Stage):
    """optax.scale_by_adam (transform.py:246); nesterov is NAdam's
    mu_hat = b1 * mu / (1 - b1^(n+1)) + (1 - b1) * g / (1 - b1^n)."""

    fields, keys = ("mu", "nu"), ADAM_KEYS

    def __init__(self, b1: float, b2: float, eps: float,
                 nesterov: bool = False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def update(self, u, state, p, names, count, hessian_diag):
        b1, b2 = self.b1, self.b2
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        # mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        _ema(mu, u, b1)
        g2 = torch._foreach_mul(u, u)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        if self.nesterov:
            out = torch._foreach_div(mu, _bc(b1, n + 1))
            torch._foreach_mul_(out, b1)
            g1 = torch._foreach_div(u, _bc(b1, n))
            torch._foreach_mul_(g1, 1 - b1)
            torch._foreach_add_(out, g1)
        else:
            out = torch._foreach_div(mu, _bc(b1, n))
        # u = mu_hat / (sqrt(nu / bc2) + eps)
        den = torch._foreach_div(nu, _bc(b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


class Trace(Stage):
    """optax.trace (transforms/_accumulation.py:37): trace = g + d * trace,
    the update g + d * trace with nesterov, else the trace."""

    fields, keys = ("trace",), {"trace": "momentum_buffer"}

    def __init__(self, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov

    def update(self, u, state, p, names, count, hessian_diag):
        t = state["trace"]
        torch._foreach_mul_(t, self.decay)
        torch._foreach_add_(t, u)
        if self.nesterov:
            return torch._foreach_add(u, torch._foreach_mul(t, self.decay))
        return [x.clone() for x in t]


class TrustRatio(Stage):
    """optax.scale_by_trust_ratio (transform.py:998) at its defaults:
    u * |p| / |u|, or u where either norm is 0."""

    def update(self, u, state, p, names, count, hessian_diag):
        pn, un = self.norms(names, p), self.norms(names, u)
        ratio = [torch.where((a == 0) | (b == 0), torch.ones_like(a), a / b)
                 for a, b in zip(pn, un)]
        return torch._foreach_mul(u, ratio)


def factored_dims(shape: Sequence[int],
                  min_dim: int = 128) -> Optional[Tuple[int, int]]:
    """optax's _factored_dims (factorized.py:37): the second largest and
    the largest axis, when the second largest has min_dim or more."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class FactoredRMS(Stage):
    """optax.scale_by_factored_rms (factorized.py:79): Adafactor's row and
    column second moments for parameters with two axes of 128 or more,
    chosen and kept on mofo_tpu's layout; a full second moment (v)
    otherwise. The unused fields hold one 0, as optax's do."""

    fields = ("v_row", "v_col", "v")

    def __init__(self, decay_rate: float = 0.8, min_dim: int = 128,
                 eps: float = 1e-30):
        self.decay_rate, self.min_dim, self.eps = decay_rate, min_dim, eps

    def _dims(self, name: str,
              p: torch.Tensor) -> Optional[Tuple[int, int]]:
        """factored_dims of the whole parameter in mofo_tpu's layout (on a
        mesh not of this rank's shard, which may fall under min_dim or
        swap two equal sides)."""
        shape = (tuple(jax_layout(name, p).shape) if self.sharding is None
                 else self.sharding.full_jax_shape(name, p.shape))
        return factored_dims(shape, self.min_dim)

    def init(self, name, p):
        shape = tuple(jax_layout(name, p).shape)
        one = torch.zeros(1, dtype=p.dtype, device=p.device)
        dims = self._dims(name, p)
        if dims is None:
            return {"v_row": one, "v_col": one.clone(),
                    "v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": p.new_zeros(np.delete(shape, d0).tolist()),
                "v_col": p.new_zeros(np.delete(shape, d1).tolist()),
                "v": one}

    def layouts(self, name, p, lay):
        dims = self._dims(name, p)
        if self.sharding is None or dims is None:
            return {"v_row": Layout(), "v_col": Layout(), "v": lay}
        d1, d0 = dims
        return {"v_row": self.sharding.reduced_layout(name, d0),
                "v_col": self.sharding.reduced_layout(name, d1),
                "v": Layout()}

    def _means(self, items) -> Tensors:
        """x.mean(dim, keepdim) for each (x, dim, keepdim, name, jax_axis):
        whole over the shards where the mesh cuts jax axis `jax_axis` of
        parameter `name` (x's dim), a local sum summed over that mesh axis
        and divided by the full length; the local mean otherwise."""
        out, cut = [], []
        for x, dim, keepdim, name, axis in items:
            key = (None if self.sharding is None
                   else self.sharding.jax_cuts(name).get(axis))
            if key is None:
                out.append(x.mean(dim=dim, keepdim=keepdim))
                continue
            n = x.shape[dim] * getattr(self.sharding.mesh, key).size
            cut.append((len(out), n))
            out.append((x.sum(dim=dim, keepdim=keepdim), (key,)))
        if cut:
            sums = self.sharding.sum_over([out[i] for i, _ in cut])
            for (i, n), total in zip(cut, sums):
                out[i] = total / n
        return out

    def update(self, u, state, p, names, count, hessian_diag):
        t = np.float32(count + 1)
        decay = np.float32(1) - t ** np.float32(-self.decay_rate)
        keep, fresh = float(decay), float(np.float32(1) - decay)
        out: List[Optional[torch.Tensor]] = [None] * len(u)
        factored = []  # (i, name, (d1, d0), g in mofo_tpu's layout, g^2 + eps)
        for i, (g, name) in enumerate(zip(u, names)):
            dims = self._dims(name, g)
            if dims is None:  # elementwise: the port's layout will do
                v = state["v"][i]
                v.mul_(keep).add_(fresh * (g * g + self.eps))
                out[i] = g * v ** -0.5
                continue
            gj = jax_layout(name, g)
            factored.append((i, name, dims, gj, gj * gj + self.eps))
        n = len(factored)
        rows = [state["v_row"][i] for i, *_ in factored]
        cols = [state["v_col"][i] for i, *_ in factored]
        means = self._means(
            [(sq, d0, False, name, d0) for _, name, (_, d0), _, sq in factored]
            + [(sq, d1, False, name, d1)
               for _, name, (d1, _), _, sq in factored])
        for row, col, m_row, m_col in zip(rows, cols, means[:n], means[n:]):
            row.mul_(keep).add_(fresh * m_row)
            col.mul_(keep).add_(fresh * m_col)
        # v_row's own mean over its axis d1 (one lower once d0 is gone)
        row_means = self._means(
            [(row, d1 - 1 if d1 > d0 else d1, True, name, d1)
             for row, (_, name, (d1, d0), _, _) in zip(rows, factored)])
        for row, col, rm, (i, name, (d1, d0), gj, _) in zip(
                rows, cols, row_means, factored):
            row_factor = (row / rm) ** -0.5
            col_factor = col ** -0.5
            uj = gj * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            out[i] = torch_layout(name, uj, u[i].shape).contiguous()
        return out


class ScaleByRMS(Stage):
    """optax.scale_by_rms (transform.py:95) with eps_in_sqrt and no bias
    correction: g / sqrt(nu + eps)."""

    fields, keys = ("nu",), {"nu": "square_avg"}

    def __init__(self, decay: float, eps: float):
        self.decay, self.eps = decay, eps

    def update(self, u, state, p, names, count, hessian_diag):
        nu = state["nu"]
        _ema(nu, torch._foreach_mul(u, u), self.decay)
        den = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(den)
        return torch._foreach_mul(den, u)


class Adadelta(Stage):
    """optax.scale_by_adadelta (transform.py:534) at rho 0.9, eps 1e-6."""

    fields, keys = ("e_g", "e_x"), {"e_g": "square_avg",
                                    "e_x": "acc_delta"}

    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = rho, eps

    def update(self, u, state, p, names, count, hessian_diag):
        e_g, e_x = state["e_g"], state["e_x"]
        _ema(e_g, torch._foreach_mul(u, u), self.rho)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        out = torch._foreach_mul(num, u)
        _ema(e_x, torch._foreach_mul(out, out), self.rho)
        return out


class Lion(Stage):
    """optax.scale_by_lion (transform.py:417): sign((1 - b1) g + b1 mu),
    then mu = (1 - b2) g + b2 mu."""

    fields, keys = ("mu",), {"mu": "exp_avg"}

    def __init__(self, b1: float, b2: float):
        self.b1, self.b2 = b1, b2

    def update(self, u, state, p, names, count, hessian_diag):
        mu = state["mu"]
        out = torch._foreach_mul(u, 1 - self.b1)
        torch._foreach_add_(out, torch._foreach_mul(mu, self.b1))
        out = [torch.sign(x) for x in out]
        _ema(mu, u, self.b2)
        return out


class RAdam(Stage):
    """optax.scale_by_radam (transform.py:773): the rectified Adam update
    where the variance is tractable (rho >= 5), mu_hat before."""

    fields, keys = ("mu", "nu"), ADAM_KEYS

    def __init__(self, b1: float, b2: float, eps: float,
                 threshold: float = 5.0):
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold

    def update(self, u, state, p, names, count, hessian_diag):
        b1, b2, f32 = self.b1, self.b2, np.float32
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, b1)
        _ema(nu, torch._foreach_mul(u, u), b2)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f32(b2) ** f32(n)
        ro = f32(ro_inf) - f32(2 * n) * b2t / (f32(1) - b2t)
        out = torch._foreach_div(mu, _bc(b1, n))
        if ro < self.threshold:
            return out
        r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                          / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        torch._foreach_mul_(out, r)
        den = torch._foreach_div(nu, _bc(b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


class Novograd(Stage):
    """optax.scale_by_novograd (transform.py:1205): a per-tensor second
    moment of |g|^2 (a 0-d tensor each), mu = b1 mu + g / (sqrt(nu) + eps),
    both started from the first gradient."""

    fields, keys = ("mu", "nu"), {"mu": "exp_avg", "nu": "exp_avg_sq"}

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, name, p):
        return {"mu": torch.zeros_like(p),
                "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def layouts(self, name, p, lay):
        return {"mu": lay, "nu": Layout()}

    def update(self, u, state, p, names, count, hessian_diag):
        mu, nu = state["mu"], state["nu"]
        sq = [x * x for x in self.norms(names, u)]
        first = count == 0
        if first:
            torch._foreach_copy_(nu, sq)
        else:
            _ema(nu, sq, self.b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_add_(den, self.eps)
        step = torch._foreach_div(u, den)
        if first:
            torch._foreach_copy_(mu, step)
        else:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, step)
        return [x.clone() for x in mu]


class Adamax(Stage):
    """optax.scale_by_adamax (transform.py:376): mu_hat / max(|g| + eps,
    b2 * nu)."""

    fields, keys = ("mu", "nu"), {"mu": "exp_avg", "nu": "exp_inf"}

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def update(self, u, state, p, names, count, hessian_diag):
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, self.b1)
        a = [x.abs() for x in u]
        torch._foreach_add_(a, self.eps)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_maximum_(nu, a)
        out = torch._foreach_div(mu, _bc(self.b1, count + 1))
        torch._foreach_div_(out, nu)
        return out


class ScaleByRSS(Stage):
    """optax.scale_by_rss (transform.py:46) from 0: g / sqrt(sum g^2 + eps),
    0 where the sum is 0."""

    fields, keys = ("sum_of_squares",), {"sum_of_squares": "sum"}

    def __init__(self, eps: float):
        self.eps = eps

    def update(self, u, state, p, names, count, hessian_diag):
        s = state["sum_of_squares"]
        torch._foreach_add_(s, torch._foreach_mul(u, u))
        inv = torch._foreach_add(s, self.eps)
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(x > 0, i, torch.zeros_like(i))
               for x, i in zip(s, inv)]
        return torch._foreach_mul(inv, u)


class Belief(Stage):
    """optax.scale_by_belief (transform.py:659): the second moment of the
    prediction error g - mu, plus eps_root."""

    fields, keys = ("mu", "nu"), {"mu": "exp_avg", "nu": "exp_avg_var"}

    def __init__(self, b1: float, b2: float, eps: float,
                 eps_root: float = 1e-16):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def update(self, u, state, p, names, count, hessian_diag):
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, self.b1)
        err = torch._foreach_sub(u, mu)
        _ema(nu, torch._foreach_mul(err, err), self.b2)
        torch._foreach_add_(nu, self.eps_root)
        out = torch._foreach_div(mu, _bc(self.b1, n))
        den = torch._foreach_div(nu, _bc(self.b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


class Yogi(Stage):
    """optax.scale_by_yogi (transform.py:717): moments from 1e-6, nu moved
    by (1 - b2) g^2 towards g^2 (additively)."""

    fields, keys = ("mu", "nu"), ADAM_KEYS

    def __init__(self, b1: float, b2: float, eps: float,
                 initial: float = 1e-6):
        self.b1, self.b2, self.eps, self.initial = b1, b2, eps, initial

    def init(self, name, p):
        return {f: torch.full_like(p, self.initial) for f in self.fields}

    def update(self, u, state, p, names, count, hessian_diag):
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, self.b1)
        g2 = torch._foreach_mul(u, u)
        step = [torch.sign(v - s) * s for v, s in zip(nu, g2)]
        torch._foreach_mul_(step, 1 - self.b2)
        torch._foreach_sub_(nu, step)
        out = torch._foreach_div(mu, _bc(self.b1, n))
        den = torch._foreach_div(nu, _bc(self.b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


def adamp_project(name: str, p: torch.Tensor, grad: torch.Tensor,
                  perturb: torch.Tensor, delta: float, wd_ratio: float,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """AdamP / SGDP's projection (mofo_tpu/train/optim.py:238-279): where a
    parameter looks scale-invariant (the gradient nearly orthogonal to it
    in the channel view, else the layer view) the radial part of the update
    goes and its decay shrinks by wd_ratio. The channel view is axis 0 of
    mofo_tpu's layout (jax_layout). Returns (update, ratio)."""
    if p.ndim < 2:
        return perturb, torch.ones((), dtype=p.dtype, device=p.device)
    pj, gj, uj = (jax_layout(name, t) for t in (p, grad, perturb))

    def rows(x, channel: bool):
        return x.reshape(x.shape[0], -1) if channel else x.reshape(1, -1)

    def cosine_max(channel: bool):
        gm, pm = rows(gj, channel), rows(pj, channel)
        num = (gm * pm).sum(dim=1).abs()
        den = (torch.linalg.vector_norm(gm, dim=1)
               * torch.linalg.vector_norm(pm, dim=1) + eps)
        return (num / den).max(), gm.shape[1]

    def projected(channel: bool):
        pm = rows(pj, channel)
        un = pm / (torch.linalg.vector_norm(pm, dim=1, keepdim=True) + eps)
        um = rows(uj, channel)
        return (um - un * (un * um).sum(dim=1, keepdim=True)).reshape(
            pj.shape)

    cos_ch, dim_ch = cosine_max(True)
    cos_ly, dim_ly = cosine_max(False)
    use_ch = cos_ch < float(np.float32(delta / np.sqrt(dim_ch)))
    use_ly = ~use_ch & (cos_ly < float(np.float32(delta / np.sqrt(dim_ly))))
    out = torch.where(use_ch, projected(True),
                      torch.where(use_ly, projected(False), uj))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    ratio = torch.where(use_ch | use_ly, one * wd_ratio, one)
    return torch_layout(name, out, p.shape), ratio


def adamp_project_sharded(sharding, names: Sequence[str], ps: Tensors,
                          grads: Tensors, perturbs: Tensors, delta: float,
                          wd_ratio: float, eps: float) -> list:
    """adamp_project of parameters that a mesh cuts (parallel/mesh.py's
    Sharding), each taken whole over its shards in mofo_tpu's layout
    (mofo_tpu/train/optim.py:238-279). In the channel view (rows on jax
    axis 0) each row's <g, p>, |g|^2, |p|^2 and <u, p> are local sums,
    summed over the mesh axes that cut the other jax axes; the layer view's
    are their totals, summed again over the axis that cuts the rows. The
    channel cosines' max is below the threshold exactly when no row reaches
    it: a count of such rows summed over the axis that cuts the rows decides
    it, so use_ch and use_ly come out the same on every rank. dim_ch and
    dim_ly are the full shape's. Two rounds of Sharding.sum_over for all
    the parameters. Returns (update, ratio, use_ch, use_ly) a parameter."""
    views, first = [], []
    for name, p, g, u in zip(names, ps, grads, perturbs):
        pj = jax_layout(name, p)
        pm = pj.reshape(pj.shape[0], -1)
        gm, um = (jax_layout(name, t).reshape(pm.shape) for t in (g, u))
        views.append((pj.shape, pm, um))
        cuts = sharding.jax_cuts(name)
        rows = [(a * b).sum(dim=1) for a, b in ((gm, pm), (gm, gm),
                                                 (pm, pm), (um, pm))]
        first.append((torch.stack(rows),
                      [key for axis, key in cuts.items() if axis != 0]))
    sums = sharding.sum_over(first)
    second = []
    for name, p, (dot, gg, pp, up) in zip(names, ps, sums):
        full = sharding.full_jax_shape(name, p.shape)
        cos = dot.abs() / (gg.sqrt() * pp.sqrt() + eps)
        thr = float(np.float32(delta / np.sqrt(np.prod(full[1:]))))
        reach = (~(cos < thr)).sum(dtype=torch.float32)  # a NaN reaches it
        rows_cut = sharding.jax_cuts(name).get(0)
        second.append((torch.stack([reach, dot.sum(), gg.sum(), pp.sum(),
                                    up.sum()]),
                       [rows_cut] if rows_cut else []))
    layers = sharding.sum_over(second)
    out = []
    for name, p, (shape, pm, um), (_, _, pp, up), layer in zip(
            names, ps, views, sums, layers):
        reach, dot_l, gg_l, pp_l, up_l = layer
        dim_ly = np.prod(sharding.full_jax_shape(name, p.shape))
        use_ch = reach == 0
        cos_ly = dot_l.abs() / (gg_l.sqrt() * pp_l.sqrt() + eps)
        use_ly = ~use_ch & (cos_ly < float(np.float32(delta
                                                      / np.sqrt(dim_ly))))
        # u - p^ <p^, u>, p^ = p / (|p| + eps), per row and for the layer
        n_row = (pp.sqrt() + eps)[:, None]
        by_row = um - (pm / n_row) * (up[:, None] / n_row)
        n_ly = pp_l.sqrt() + eps
        by_layer = um - (pm / n_ly) * (up_l / n_ly)
        o = torch.where(use_ch, by_row,
                        torch.where(use_ly, by_layer, um)).reshape(shape)
        one = torch.ones((), dtype=p.dtype, device=p.device)
        ratio = torch.where(use_ch | use_ly, one * wd_ratio, one)
        out.append((torch_layout(name, o, p.shape), ratio, use_ch, use_ly))
    return out


class _Projected(Stage):
    """The shared tail of AdamP and SGDP: the projection and the decay
    wd(t) * ratio * p folded in on the decayed parameters. On a mesh the
    parameters it cuts project through adamp_project_sharded."""

    def __init__(self, wd_at: Callable[[int], float], mask: Dict[str, bool],
                 delta: float = 0.1, wd_ratio: float = 0.1,
                 eps: float = 1e-8):
        self.wd_at, self.mask = wd_at, mask
        self.delta, self.wd_ratio, self.eps = delta, wd_ratio, eps

    def project(self, g, p, perturb, names, count):
        wd = np.float32(self.wd_at(count))
        cut = [i for i, (n, pi) in enumerate(zip(names, p))
               if self.sharding is not None and pi.ndim >= 2
               and not self.sharding.layouts[n].replicated]
        whole = dict(zip(cut, adamp_project_sharded(
            self.sharding, [names[i] for i in cut], [p[i] for i in cut],
            [g[i] for i in cut], [perturb[i] for i in cut], self.delta,
            self.wd_ratio, self.eps))) if cut else {}
        out = []
        for i, (gi, pi, di, name) in enumerate(zip(g, p, perturb, names)):
            if i in whole:
                ui, ratio = whole[i][:2]
            else:
                ui, ratio = adamp_project(name, pi, gi, di, self.delta,
                                          self.wd_ratio, self.eps)
            if self.mask[name]:
                ui = ui + (float(wd) * ratio) * pi
            out.append(ui)
        return out


class AdamP(_Projected):
    """mofo_tpu's scale_by_adamp (optim.py:282-337)."""

    fields, keys = ("mu", "nu"), ADAM_KEYS

    def __init__(self, wd_at, mask, b1: float, b2: float, eps: float):
        super().__init__(wd_at, mask, eps=eps)
        self.b1, self.b2 = b1, b2

    def update(self, u, state, p, names, count, hessian_diag):
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, self.b1)
        _ema(nu, torch._foreach_mul(u, u), self.b2)
        den = torch._foreach_div(nu, _bc(self.b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        perturb = torch._foreach_div(mu, _bc(self.b1, n))
        torch._foreach_div_(perturb, den)
        return self.project(u, p, perturb, names, count)


class SGDP(_Projected):
    """mofo_tpu's scale_by_sgdp (optim.py:345-384) with nesterov, as the
    factory builds it (:611): buf = m * buf + g, d_p = g + m * buf."""

    fields, keys = ("buf",), {"buf": "momentum_buffer"}

    def __init__(self, wd_at, mask, momentum: float):
        super().__init__(wd_at, mask)
        self.momentum = momentum

    def update(self, u, state, p, names, count, hessian_diag):
        buf = state["buf"]
        torch._foreach_mul_(buf, self.momentum)
        torch._foreach_add_(buf, u)
        d_p = torch._foreach_add(u, torch._foreach_mul(buf, self.momentum))
        return self.project(u, p, d_p, names, count)


class AdaHessian(Stage):
    """mofo_tpu's scale_by_adahessian (optim.py:393-456) at the factory's
    hessian_power 1: Adam's first moment of the gradient, the second of the
    Hutchinson estimate h, u = mu_hat / (sqrt(nu_hat) + eps)."""

    fields, keys = ("mu", "nu"), {"mu": "exp_avg",
                                  "nu": "exp_hessian_diag_sq"}

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def update(self, u, state, p, names, count, hessian_diag):
        if hessian_diag is None:
            raise ValueError(
                "adahessian needs the hessian_diag argument: build the step "
                "with second_order=True (see hutchinson_diag)")
        n = count + 1
        mu, nu = state["mu"], state["nu"]
        _ema(mu, u, self.b1)
        _ema(nu, torch._foreach_mul(hessian_diag, hessian_diag), self.b2)
        out = torch._foreach_div(mu, _bc(self.b1, n))
        den = torch._foreach_div(nu, _bc(self.b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(out, den)
        return out


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptState:
    """count: updates applied so far (indexes the schedules); buffers:
    field -> name -> tensor, the moment stages' state (mu and nu for the
    Adam family, read as state.mu / state.nu); keys: field -> checkpoint
    key; slow: the lookahead's slow weights, None without lookahead;
    layouts: field -> name -> where the mesh cuts the tensor (parallel/
    mesh.py's Layout), for an optimizer made with a sharding (None
    otherwise)."""

    count: int
    buffers: Dict[str, Params]
    keys: Dict[str, str]
    slow: Optional[Params] = None
    layouts: Optional[Dict[str, Dict[str, Layout]]] = None

    def __getattr__(self, field: str) -> Params:
        buffers = self.__dict__.get("buffers")
        if buffers is None or field not in buffers:
            raise AttributeError(field)
        return buffers[field]


class Optimizer:
    """[clip] -> `stages` -> [decoupled decay] -> [layer decay] -> frozen
    parameters dropped -> -lr(t) -> [lookahead], over the parameters
    `trained` (all by default). The stages see the `trained` parameters
    only, or every parameter when `full` (adamp, sgdp, adahessian)."""

    def __init__(self, params: Params, stages: List[Stage], *,
                 lr_schedule: np.ndarray, wd_at: Callable[[int], float],
                 mask: Dict[str, bool], decoupled: bool = True,
                 clip_grad: Optional[float] = None,
                 lr_scales: Optional[Dict[str, float]] = None,
                 trained: Optional[Iterable[str]] = None, full: bool = False,
                 lookahead: Optional[Tuple[int, float]] = None,
                 sharding=None):
        if sharding is not None and sharding.mesh.sharded:
            for stage in stages:
                stage.sharding = sharding
        self.sharding = sharding
        self.stages = stages
        self.lr_schedule = np.asarray(lr_schedule, np.float32)
        self.wd_at, self.mask, self.decoupled = wd_at, mask, decoupled
        self.clip_grad = clip_grad
        self.lr_scales = lr_scales
        self.trained = list(params if trained is None else trained)
        self.moment_names = (list(params) if full and trained is not None
                             else self.trained)
        self.lookahead = lookahead

    def init(self, params: Params) -> OptState:
        buffers: Dict[str, Params] = {}
        keys: Dict[str, str] = {}
        layouts = None if self.sharding is None else {}
        for stage in self.stages:
            for f in stage.fields:
                buffers[f] = {}
                keys[f] = stage.keys.get(f, f)
            for n in self.moment_names:
                for f, t in stage.init(n, params[n]).items():
                    buffers[f][n] = t
                if layouts is not None:
                    for f, lay in stage.layouts(
                            n, params[n], self.sharding.layouts[n]).items():
                        layouts.setdefault(f, {})[n] = lay
        slow = None
        if self.lookahead is not None:  # real copies, never aliases
            slow = {n: params[n].detach().clone() for n in self.trained}
        return OptState(count=0, buffers=buffers, keys=keys, slow=slow,
                        layouts=layouts)

    @staticmethod
    def _at(schedule: np.ndarray, count: int) -> float:
        return float(schedule[min(count, schedule.shape[0] - 1)])

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params,
               hessian_diag: Optional[Params] = None) -> None:
        """Applies one update to `params` and `state`, in place.
        hessian_diag (name -> z * Hz) feeds adahessian."""
        names = self.moment_names
        u = [grads[n] for n in names]
        if self.clip_grad is not None and self.clip_grad > 0:
            g_norm = (global_norm(grads.values())  # every gradient
                      if self.sharding is None
                      else self.sharding.global_norm(grads))
            if not bool(g_norm < self.clip_grad):
                u = [(x / g_norm) * self.clip_grad for x in u]
        count = state.count
        p = [params[n] for n in names]
        hd = (None if hessian_diag is None
              else [hessian_diag[n] for n in names])
        for stage in self.stages:
            u = stage.update(
                u, {f: [state.buffers[f][n] for n in names]
                    for f in stage.fields}, p, names, count, hd)
        if names is not self.trained:  # frozen parameters: no update
            at = {n: i for i, n in enumerate(names)}
            names = self.trained
            u = [u[at[n]] for n in names]
            p = [params[n] for n in names]
        if self.decoupled:  # u += wd * p on the decayed parameters
            decayed = [i for i, n in enumerate(names) if self.mask[n]]
            if decayed:
                torch._foreach_add_(
                    [u[i] for i in decayed],
                    torch._foreach_mul([p[i] for i in decayed],
                                       float(self.wd_at(count))))
        if self.lr_scales is not None:
            groups: Dict[float, list] = {}
            for i, n in enumerate(names):
                groups.setdefault(self.lr_scales[n], []).append(u[i])
            for scale, group in groups.items():
                torch._foreach_mul_(group, scale)
        torch._foreach_mul_(u, -self._at(self.lr_schedule, count))
        if self.lookahead is not None and (count + 1) % self.lookahead[0] == 0:
            # the sync step: slow += alpha * (p + u - slow); u = slow - p
            slow = [state.slow[n] for n in names]
            fast = torch._foreach_add(p, u)
            torch._foreach_sub_(fast, slow)
            torch._foreach_mul_(fast, self.lookahead[1])
            torch._foreach_add_(slow, fast)
            u = torch._foreach_sub(slow, p)
        torch._foreach_add_(p, u)
        state.count = count + 1


# ---------------------------------------------------------------------------
# AdaHessian's probe
# ---------------------------------------------------------------------------


def is_second_order(opt: str) -> bool:
    """Does this zoo entry need the Hutchinson probe (the lookahead_ prefix
    stripped)? (mofo_tpu/train/optim.py:459-467)"""
    opt = opt.lower()
    if opt.startswith("lookahead_"):
        opt = opt[len("lookahead_"):]
    return opt == "adahessian"


def rademacher(params: Params, generator: Optional[torch.Generator] = None,
               sharding=None) -> Params:
    """A +-1 tensor like each parameter, drawn in order from `generator`.
    With a sharding (parallel.mesh's) each is drawn on the parameter's full
    shape and this rank's shard kept: the z one process draws from the
    same generator state, cut as the parameter is."""
    out = {}
    for n, p in params.items():
        shape = p.shape if sharding is None else sharding.full_shape(
            n, p.shape)
        z = torch.randint(0, 2, shape, generator=generator,
                          device=p.device).to(p.dtype) * 2 - 1
        out[n] = z if sharding is None else sharding.shard(n, z).contiguous()
    return out


def hutchinson_diag(grad_fn: Callable[[Params], Params], params: Params,
                    z: Optional[Params] = None,
                    generator: Optional[torch.Generator] = None) -> Params:
    """One-probe Hutchinson estimate of diag(H): z * (H z), z Rademacher
    (mofo_tpu/train/optim.py:470-497); exact on quadratics with a diagonal
    H for any z. grad_fn(params) returns the gradients with their graph
    (torch.autograd.grad(..., create_graph=True)); H z is the gradient of
    sum <g, z> in f32. z is drawn from `generator` unless given (the tests
    inject mofo_tpu's draws). A parameter with no second-order path gets
    a zero estimate.

    On a mesh (params and z this rank's shards) each rank differentiates
    the sum of its own terms, and that is the one-process probe: the model
    ranks' terms of a model-sharded parameter add up to its <g, z>, and
    that sum (a reduce_from) has the identity for its backward, so each
    rank's own terms give the same Hz without a collective; a parameter
    replicated over model has its gradient whole on every model rank, one
    value held M times, so its term enters once on each; the fsdp ranks
    hold different rows, and the gathers' twice-differentiable backward
    (parallel/tensor_parallel.py) sums their terms as it sums their
    gradients."""
    if z is None:
        z = rademacher(params, generator)
    names = list(params)
    g = grad_fn(params)
    gz = sum((g[n].float() * z[n].float()).sum() for n in names
             if g[n] is not None and g[n].requires_grad)
    hz = torch.autograd.grad(gz, [params[n] for n in names],
                             allow_unused=True)
    return {n: z[n] * (torch.zeros_like(params[n]) if h is None else h)
            for n, h in zip(names, hz)}


# ---------------------------------------------------------------------------
# The factory
# ---------------------------------------------------------------------------

ALIASES = {"fusedadam": "adam", "fusedadamw": "adamw", "fusedsgd": "sgd",
           "fusedmomentum": "momentum", "fusedlamb": "lamb",
           "fusednovograd": "novograd", "nvnovograd": "novograd"}
# the entries whose moments cover every parameter under `trainable`
FULL_MOMENTS = ("adamp", "sgdp", "adahessian")


def create_optimizer(params: Params, *, opt: str = "adamw",
                     lr_schedule: np.ndarray,
                     wd_schedule: Optional[np.ndarray] = None,
                     weight_decay: float = 0.05,
                     betas: Tuple[float, float] = (0.9, 0.999),
                     eps: float = 1e-8, momentum: float = 0.9,
                     clip_grad: Optional[float] = None,
                     layer_decay: Optional[float] = None,
                     depth: Optional[int] = None,
                     extra_no_decay: Sequence[str] = (),
                     trainable: Optional[Callable[[str, torch.Tensor],
                                                  bool]] = None,
                     sharding=None) -> Optimizer:
    """mofo_tpu.train.optim.create_optimizer on the model's named
    parameters. `opt` is any zoo name (module docstring); others raise
    ValueError("Unknown optimizer: ..."). extra_no_decay names parts of
    parameter names that get no decay. With layer_decay < 1 each update is
    scaled by layer_decay_scales (depth inferred from the names unless
    given). trainable(name, tensor) picks the parameters that are trained
    (all without it); it must pick one. `sharding` (parallel.mesh.
    shard_model's) takes the whole-tensor norms over the parameters'
    shards; the module docstring says what it refuses."""
    opt = opt.lower()
    lookahead = None
    if opt.startswith("lookahead_"):
        lookahead, opt = (6, 0.5), opt[len("lookahead_"):]
    opt = ALIASES.get(opt, opt)
    mask = decay_mask(params)
    if extra_no_decay:
        extra = set(extra_no_decay)
        mask = {n: m and not extra & set(n.split("."))
                for n, m in mask.items()}
    wd_sched = (None if wd_schedule is None
                else np.asarray(wd_schedule, np.float32))
    wd_const = np.float32(weight_decay)

    def wd_at(count: int):
        if wd_sched is None:
            return wd_const
        return float(wd_sched[min(count, wd_sched.shape[0] - 1)])

    b1, b2 = betas
    stages = {
        "adamw": lambda: [ScaleByAdam(b1, b2, eps)],
        "adam": lambda: [ScaleByAdam(b1, b2, eps)],
        "sgd": lambda: [Trace(momentum, True)],
        "nesterov": lambda: [Trace(momentum, True)],
        "momentum": lambda: [Trace(momentum, False)],
        "lamb": lambda: [ScaleByAdam(b1, b2, eps), TrustRatio()],
        "adafactor": lambda: [FactoredRMS()],
        "rmsprop": lambda: [ScaleByRMS(0.9, eps)],
        "adadelta": lambda: [Adadelta()],
        "lars": lambda: [TrustRatio(), Trace(momentum, False)],
        "lion": lambda: [Lion(b1, b2)],
        "nadam": lambda: [ScaleByAdam(b1, b2, eps, nesterov=True)],
        "radam": lambda: [RAdam(b1, b2, eps)],
        "novograd": lambda: [Novograd(b1, b2, eps)],
        "adamax": lambda: [Adamax(b1, b2, eps)],
        "adagrad": lambda: [ScaleByRSS(eps)],
        "adabelief": lambda: [Belief(b1, b2, eps)],
        "yogi": lambda: [Yogi(b1, b2, eps)],
        "adamp": lambda: [AdamP(wd_at, mask, b1, b2, eps)],
        "sgdp": lambda: [SGDP(wd_at, mask, momentum)],
        "adahessian": lambda: [AdaHessian(b1, b2, eps)],
    }
    if opt not in stages:
        raise ValueError(f"Unknown optimizer: {opt}")
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
    return Optimizer(params, stages[opt](), lr_schedule=lr_schedule,
                     wd_at=wd_at, mask=mask,
                     decoupled=opt not in ("adam", "adamp", "sgdp"),
                     clip_grad=clip_grad, lr_scales=scales, trained=trained,
                     full=opt in FULL_MOMENTS, lookahead=lookahead,
                     sharding=sharding)
