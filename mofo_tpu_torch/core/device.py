"""Where the port's entry points run: on CUDA unless the caller asks for the
CPU. No entry point moves to the CPU on its own."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for (or implied) and no
    GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_of(module: torch.nn.Module) -> Optional[torch.device]:
    """The device of a module's parameters (None for a module without)."""
    for p in module.parameters():
        return p.device
    return None
