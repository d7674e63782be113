"""Process topology of a run: the single-process counterpart of
mofo_tpu/core/distributed.py (reference init_distributed_mode,
utils.py:255-296).

The port trains in one process on one device. init_distributed_mode reads
the same launcher conventions as the reference (torch.distributed's RANK /
WORLD_SIZE, SLURM, OpenMPI) and raises when they ask for more than one
process: multi-process training (DDP) is not ported yet (ROADMAP Queue 1,
slice 2, item 12).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def launcher_world() -> Tuple[Optional[int], Optional[int]]:
    """(rank, world size) from the launcher's environment, (None, None)
    when no launcher set them."""
    env = os.environ
    for rank, size in (("RANK", "WORLD_SIZE"),
                       ("SLURM_PROCID", "SLURM_NTASKS"),
                       ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")):
        if rank in env and size in env:
            return int(env[rank]), int(env[size])
    return None, None


def init_distributed_mode(verbose: bool = True) -> None:
    """Checks that the launcher asks for one process."""
    _, size = launcher_world()
    if size is not None and size > 1:
        raise NotImplementedError(
            f"the launcher asks for {size} processes: multi-process "
            "training (DDP) is not ported yet (ROADMAP Queue 1, slice 2, "
            "item 12)")
    if verbose:
        print("Not using distributed mode (single process)")


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def is_main_process() -> bool:
    return process_index() == 0


def setup_printing(force: bool = False):
    """Master-only printing (utils.py:211-223): returns a print function
    that is a no-op on non-zero processes unless force."""
    main = is_main_process()

    def maybe_print(*args, **kwargs):
        if main or force:
            print(*args, **kwargs, flush=True)

    return maybe_print
