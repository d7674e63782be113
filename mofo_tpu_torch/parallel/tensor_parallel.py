"""Collectives over one axis of a mesh, and the autograd functions of the
model axis (tensor parallelism over heads and hidden units) and of the fsdp
axis (parameters gathered before use).

mofo_tpu leaves both to GSPMD: params carry NamedShardings
(mofo_tpu/parallel/mesh.py:106-191) and XLA inserts the all-gathers and
reductions inside the jitted step. Here each rank calls its kernels on
plain local tensors, and the communication is explicit:

  copy_to(x, axis)        identity forward, all-reduce backward: the input
                          of a column-parallel layer (qkv, fc1, the MCA's q
                          and kv), whose rank holds some of its output rows
  reduce_from(x, axis)    all-reduce forward, identity backward: the partial
                          products of a row-parallel layer (proj, fc2)
  gather_from(x, axis)    all-gather forward, this rank's slice backward: the
                          MCA's head-sharded attention output before its
                          proj, which mofo_tpu shards over fsdp only
  gather_fsdp(p, axis, d) all-gather forward along dim d, reduce-scatter
                          backward: a parameter's fsdp shard, gathered
                          before use (and kept by autograd for the
                          backward); its gradient comes back summed over
                          the fsdp ranks and cut to the shard

Each backward is the partner function, not a raw collective, so that a
backward taken with create_graph=True (AdaHessian's Hessian-vector
product, train/optim.hutchinson_diag) is itself differentiable across the
ranks: copy_to's backward is reduce_from and reduce_from's copy_to;
gather_from's backward takes this rank's slice through a function whose
backward is gather_from; gather_fsdp's backward is a reduce-scatter
function whose backward is the all-gather. A raw collective there would
record only this rank's part, and the second derivative would drop the
other ranks' terms.

An Axis is one axis of the mesh as this rank sees it: its size, this rank's
coordinate on it, the global ranks along it and their process group (None
at size 1, where every collective is the identity).

The backends. NCCL moves CUDA tensors. gloo reduces CUDA tensors
(all_reduce) but has no CUDA all-gather: all_gather stages a CUDA tensor
through the host on gloo, by an explicit branch on the backend (the card's
machine runs the mesh's ranks on one GPU over gloo, as NCCL refuses two
ranks on one device). reduce_scatter is an all-reduce and this rank's
chunk on every backend (twice the bytes of reduce_scatter_tensor, which
gloo lacks in some torch versions); nothing here falls back to one
process.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = None  # torch.distributed ProcessGroup; None at size 1


def _via_host(t: torch.Tensor, axis: Axis) -> bool:
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def all_reduce(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of `t` over the axis (a new tensor; `t` at size 1)."""
    if axis is None or axis.size == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather(t: torch.Tensor, axis: Optional[Axis],
               dim: int = 0) -> torch.Tensor:
    """The axis's tensors concatenated along `dim`, in axis order."""
    if axis is None or axis.size == 1:
        return t
    host = _via_host(t, axis)
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


def reduce_scatter(t: torch.Tensor, axis: Optional[Axis],
                   dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `t` over the axis."""
    if axis is None or axis.size == 1:
        return t
    return all_reduce(t, axis).chunk(axis.size, dim)[axis.index].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFrom.apply(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _CopyTo.apply(g, ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _SliceTo.apply(g, ctx.axis, ctx.dim), None, None


class _SliceTo(torch.autograd.Function):
    """This rank's slice along dim of a tensor whole on every rank of the
    axis (gather_from's backward); its backward gathers the slices."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.chunk(axis.size, dim)[axis.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherFrom.apply(g, ctx.axis, ctx.dim), None, None


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(p.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """reduce_scatter (gather_fsdp's backward); its backward is the
    all-gather of the chunks."""

    @staticmethod
    def forward(ctx, g, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(g, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _GatherFsdp.apply(g, ctx.axis, ctx.dim), None, None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Optional[Axis],
                dim: int = -1) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _GatherFrom.apply(x, axis, dim % x.ndim)


# parameter id -> its gathered value, inside `gathered` (eval only)
_GATHERED: Optional[Dict[int, torch.Tensor]] = None


def gather_fsdp(p: torch.Tensor, axis: Optional[Axis],
                dim: int) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return p
    if _GATHERED is not None and id(p) in _GATHERED:
        return _GATHERED[id(p)]
    return _GatherFsdp.apply(p, axis, dim)


@contextlib.contextmanager
def gathered(values: Dict[int, torch.Tensor]) -> Iterator[None]:
    """Inside, gather_fsdp of a parameter whose id is in `values` returns
    that value without a collective (mesh.gathered fills it)."""
    global _GATHERED
    kept = _GATHERED
    _GATHERED = values
    try:
        yield
    finally:
        _GATHERED = kept


def param(module: torch.nn.Module, name: str) -> torch.Tensor:
    """module.<name>, gathered over fsdp when shard_model sharded it there
    (module._fsdp_dims names the dim, module._fsdp_axis the axis)."""
    p = getattr(module, name)
    dims = module.__dict__.get("_fsdp_dims")
    if p is None or not dims or name not in dims:
        return p
    return gather_fsdp(p, module.__dict__["_fsdp_axis"], dims[name])
