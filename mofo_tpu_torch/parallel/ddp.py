"""Data parallelism across processes: the counterpart of the data axis of
mofo_tpu/parallel/mesh.py (the batch sharded over ('data',), gradients
reduced by the jitted step's psum), and the batch layout that the mesh's
(data x fsdp) batch axis shares (parallel/mesh.py: the fsdp and model axes).

The contract: W ranks, each with a local batch of B rows and update_freq k,
all seeded alike, compute what one process computes on the global batch G'
of W * B rows whose microbatch i is the concatenation over ranks r = 0..W-1
of rank r's local microbatch i. For k = 1 that is mofo_tpu's global batch,
rows rank-major as make_array_from_process_local_data lays them out; for
k > 1 it is the batch whose leading reshape (mofo_tpu/train/
pretrain_step.py:177-181) makes the same microbatches. On a mesh the
"ranks" of this layout are the batch coordinates b = d * fsdp + f (W =
data * fsdp of them), and the model peers of a coordinate hold the same
rows.

  global_rows      - the positions in G' of a rank's local rows
  wrap_model       - DistributedDataParallel over the model (gradients
                     averaged over the ranks in its backward); the wrapped
                     module keeps the reference's state_dict names. It is
                     the data-only path (fsdp = model = 1); a sharded mesh
                     reduces its gradients itself (mesh.Sharding)
  data_parallel    - (rank, world) of a wrapped model, None otherwise
  global_draws / per_sample - inside a data-parallel step every per-sample
                     random draw is made at the global count from the
                     step's generator (the same on every rank) and the rank
                     keeps its rows, so the ranks draw what one process
                     draws for G'; with one process per_sample is the draw
  all_reduce_sum, exchange_flipped, all_gather_object, broadcast_object -
                     the collectives the steps, the metrics and the
                     multi-view test use; the first three take a mesh's
                     batch axis (`group`, a tensor_parallel.Axis) to run
                     over the batch coordinates only, the whole world by
                     default

gloo moves CUDA tensors only for all_reduce and broadcast: its
point-to-point sends and gathers of CUDA tensors go through the host, by
an explicit branch on the backend. NCCL reduces CUDA tensors only: a CPU
tensor goes through the current device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from mofo_tpu_torch.core.device import device_of

# (rank, world, k) while a data-parallel step makes its draws
_LAYOUT: Optional[Tuple[int, int, int]] = None
# the mesh's batch axis while a sharded step makes its draws
_GROUP = None


def global_rows(rank: int, world: int, batch: int, k: int = 1) -> np.ndarray:
    """Positions in G' of rank `rank`'s `batch` local rows, its batch split
    into k microbatches of m = batch / k rows: local row j sits at
    i * world * m + rank * m + (j mod m), i = j // m."""
    if batch % k:
        raise ValueError(f"batch {batch} does not split into {k} micro")
    m = batch // k
    j = np.arange(batch)
    return (j // m) * world * m + rank * m + j % m


def wrap_model(model: torch.nn.Module) -> DistributedDataParallel:
    """The model under DistributedDataParallel on its own device, over the
    default process group. Buffers are not broadcast on each forward (the
    models hold constant tables only); parameters start equal on every
    rank (the same seed) and DDP broadcasts rank 0's once. Save and load
    through the inner module (`unwrap`), whose names carry no `module.`."""
    dev = device_of(model)
    ids = [dev.index if dev.index is not None
           else torch.cuda.current_device()] if dev.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids,
                                   broadcast_buffers=False)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def data_parallel(model: torch.nn.Module) -> Optional[Tuple[int, int]]:
    """(rank, world) when the model is wrapped by wrap_model, else None."""
    if not isinstance(model, DistributedDataParallel):
        return None
    group = model.process_group
    return dist.get_rank(group), dist.get_world_size(group)


@contextlib.contextmanager
def global_draws(rank: int, world: int, k: int = 1, group=None):
    """Inside, per_sample draws at the global count: a leading dimension of
    n local rows in k microbatches is drawn as world * n rows and the
    rows global_rows(rank, world, n, k) are kept. `group` is a mesh's batch
    axis (rank and world its index and size), None for the whole world:
    batch_group() returns it inside."""
    global _LAYOUT, _GROUP
    kept = _LAYOUT, _GROUP
    _LAYOUT = None if world == 1 else (rank, world, k)
    _GROUP = group
    try:
        yield
    finally:
        _LAYOUT, _GROUP = kept


def layout() -> Optional[Tuple[int, int, int]]:
    """(rank, world, k) inside global_draws with world > 1, else None."""
    return _LAYOUT


def batch_group():
    """The batch axis of the global_draws around the caller (None: the
    whole world)."""
    return _GROUP


def per_sample(draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape: Sequence[int]) -> torch.Tensor:
    """draw(shape), a tensor whose leading dimension is the batch: outside
    global_draws the draw itself; inside, the draw at the global count,
    this rank's rows of it."""
    shape = tuple(shape)
    if _LAYOUT is None:
        return draw(shape)
    rank, world, k = _LAYOUT
    full = draw((world * shape[0],) + shape[1:])
    rows = torch.from_numpy(global_rows(rank, world, shape[0], k))
    return full.index_select(0, rows.to(full.device))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks (of the batch axis `group`) of `t` (a new
    tensor on t's device)."""
    pg = None if group is None else group.group
    if group is not None and group.size == 1:
        return t.clone()
    if dist.get_backend(pg) == "nccl" and not t.is_cuda:
        out = t.to(torch.cuda.current_device())
        dist.all_reduce(out, group=pg)
        return out.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=pg)
    return out


def exchange_flipped(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank W-1-r's rows of x, flipped along dim 0: the mixup partner of
    rank r's rows, as the partner of global row g is W * B - 1 - g. For odd
    W the middle rank keeps its own rows. A send / receive between the two
    ranks of a pair (an all-gather would move W times the bytes). With a
    mesh's batch axis `group`, r and W are the batch coordinate and their
    count, and the partner is the rank at coordinate W-1-r of the same
    model coordinate."""
    if group is None:
        rank, world = dist.get_rank(), dist.get_world_size()
        peer = world - 1 - rank
    else:
        rank = group.ranks[group.index]
        peer = group.ranks[group.size - 1 - group.index]
    if peer == rank:
        return torch.flip(x, dims=[0])
    via_host = x.is_cuda and dist.get_backend() == "gloo"
    send = (x.cpu() if via_host else x).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                       dist.P2POp(dist.irecv, recv, peer)]):
        req.wait()
    return torch.flip(recv.to(x.device) if via_host else recv, dims=[0])


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's `obj` (picklable, host objects), in rank order (of the
    batch axis `group`)."""
    if group is None:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out
    if group.size == 1:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.group)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank: one decision for all (an early stop,
    a save)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
