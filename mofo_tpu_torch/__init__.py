"""mofo_tpu_torch: the PyTorch / CUDA port of mofo_tpu for NVIDIA Hopper.

The JAX package mofo_tpu is the reference and this package imports nothing
of it (nor JAX). Entry points run on CUDA unless the caller passes
device="cpu"; the attention kernels are hand-written CUDA
(mofo_tpu_torch/csrc), built with nvcc at first use.
"""

from mofo_tpu_torch.version import __version__

__all__ = ["__version__"]
