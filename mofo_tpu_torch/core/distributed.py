"""Process topology of a run: the counterpart of
mofo_tpu/core/distributed.py (reference init_distributed_mode,
utils.py:255-296).

init_distributed_mode reads the reference's launcher conventions
(torch.distributed's RANK / WORLD_SIZE / LOCAL_RANK, SLURM, OpenMPI) and,
for a world of more than one process, pins the process to its local GPU and
joins the process group: NCCL on CUDA, gloo on the CPU. A world of W > 1
whose backend cannot start raises; it never carries on as one process.
Without a launcher (or with a world of 1) the run is one process and no
group is formed.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# (rank, world size, local-rank variable) of each launcher convention
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_LOCAL_RANK"))


def launcher_world() -> Tuple[Optional[int], Optional[int]]:
    """(rank, world size) from the launcher's environment, (None, None)
    when no launcher set them."""
    env = os.environ
    for rank, size, _ in _LAUNCHERS:
        if rank in env and size in env:
            return int(env[rank]), int(env[size])
    return None, None


def local_rank() -> int:
    """This process's GPU on its node: the launcher's local rank (0 when
    none is set)."""
    env = os.environ
    for rank, size, local in _LAUNCHERS:
        if rank in env and size in env:
            return int(env.get(local, 0))
    return 0


def init_distributed_mode(verbose: bool = True, device: str = "cuda",
                          backend: Optional[str] = None,
                          init_method: str = "env://") -> bool:
    """Joins the launcher's process group when it asks for more than one
    process; returns whether it did (False for one process, and for a
    process already in a group of the launcher's size, which its caller
    formed with an init_method of its own). `device` ("cuda" or "cpu")
    picks the backend, NCCL or gloo, unless `backend` names one; on CUDA
    the process is pinned to cuda:<local rank> first. `init_method` is
    env:// (MASTER_ADDR and MASTER_PORT, default 127.0.0.1:29500 as in
    mofo_tpu/core/distributed.py:44-45) or a file:// / tcp:// URL."""
    rank, size = launcher_world()
    if size is None or size <= 1:
        if verbose:
            print("Not using distributed mode (single process)")
        return False
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise RuntimeError(
                f"already in a process group as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}; the launcher says {rank} of "
                f"{size}")
        return False
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the launcher asks for {size} processes on "
                               "CUDA and no CUDA device is available")
        torch.cuda.set_device(local_rank())
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    if verbose:
        print(f"| distributed init (rank {rank}/{size}, local rank "
              f"{local_rank()}, {backend}): {init_method}", flush=True)
    return True


def destroy() -> None:
    """Leaves the process group (a no-op for one process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Waits for every process (a no-op for one)."""
    if process_count() > 1:
        dist.barrier()


def run_device(device: str) -> str:
    """The runners' device: cuda:<local rank> for "cuda", else `device`."""
    return f"cuda:{local_rank()}" if device == "cuda" else device


def setup_printing(force: bool = False):
    """Master-only printing (utils.py:211-223): returns a print function
    that is a no-op on non-zero processes unless force."""
    main = is_main_process()

    def maybe_print(*args, **kwargs):
        if main or force:
            print(*args, **kwargs, flush=True)

    return maybe_print
