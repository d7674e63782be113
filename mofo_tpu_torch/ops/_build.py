"""Builds the CUDA sources under mofo_tpu_torch/csrc into one shared library
with a plain C interface and loads it with ctypes (one nvcc call compiles
every source).

The library is compiled with nvcc for sm_90a at first use, into
mofo_tpu_torch/build/ (git-ignored), under a name keyed by the sources'
content, so a second call in the same checkout reuses it. A failed build
raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
SOURCES = ("qkv_flash_attention.cu", "mh_flash_attention.cu",
           "hm_flash_attention.cu")
HEADERS = ("flash_tiles.cuh",)  # included by the sources, part of the key
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C entry points (see the csrc/*.cu sources)
SIGNATURES = {
    "qkv_attn_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "qkv_attn_bwd_dkv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "qkv_attn_bwd_dq": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "mh_attn_fwd": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    "mh_attn_bwd_dkv": [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P],
    "mh_attn_bwd_dq": [_P] * 8 + [_I] * 7 + [_F, _F, _I, _P],
    "hm_attn_fwd": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    "hm_attn_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    "hm_attn_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _F, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "mofo_tpu_torch cannot be built"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmofo_kernels_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compiles the library unless it is already built. Returns the path,
    the seconds spent and nvcc's report (registers, shared memory and
    spills of every kernel, from -Xptxas -v)."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True,
                "report": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "cached": False,
            "report": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's argtypes and restype
    declared (builds it first if needed)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
