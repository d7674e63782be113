"""The C interface of the port's CUDA sources against what Python declares.

The kernels are loaded with ctypes (mofo_tpu_torch/ops/_build.py), so a
wrong argtypes list is no compile error: it passes a pointer as a 32-bit
int or shifts every later argument, and crashes or computes garbage only on
the card. These tests parse the sources here and hold each `extern "C"`
entry point against `_build.SIGNATURES`, and hold the files under csrc/
against the lists the build hashes into its key.
"""

import ctypes
import re

import pytest
import torch

from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import flash_attention as fa

ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
CTYPE = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


def _kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    words = param.replace("const ", "").split()
    if len(words) != 2 or words[0] not in ("int", "float"):
        raise AssertionError(f"unexpected C parameter {param!r}")
    return words[0]


def _entry_points() -> dict:
    found = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for fn, params in ENTRY.findall(text):
            assert fn not in found, f"{fn} defined twice"
            found[fn] = [_kind(p) for p in params.split(",")]
    return found


def test_every_entry_point_is_declared_and_no_other():
    assert set(_entry_points()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_argtypes_match_the_c_parameters(name):
    kinds = _entry_points()[name]
    declared = _build.SIGNATURES[name]
    assert len(declared) == len(kinds), (name, kinds)
    assert declared == [CTYPE[k] for k in kinds], (name, kinds)


def test_every_kernel_wrapper_has_an_entry_point():
    assert set(fa.KERNELS) <= set(_build.SIGNATURES)


def test_the_build_key_covers_every_source_and_header():
    on_disk = {p.name for p in _build.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    assert on_disk == set(_build.SOURCES) | set(_build.HEADERS)
    assert {n for n in on_disk if n.endswith(".cuh")} == set(_build.HEADERS)


def test_every_include_of_a_source_is_a_listed_header():
    for name in _build.SOURCES + _build.HEADERS:
        text = (_build.CSRC / name).read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in _build.HEADERS, (name, inc)


def test_the_library_name_follows_the_headers(monkeypatch, tmp_path):
    """A change to a header gives the library another name, so a stale
    build is never loaded."""
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / _build.HEADERS[-1]
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


# the mma.sync tile helpers that the bf16 kernels were built from before
# they became TMA + wgmma kernels
REMOVED_HELPERS = ("load_bf16", "mm_nt", "mm_nn", "to_a", "store_rows",
                   "kMmaThreads", "kRowsH", "pack_bf")


@pytest.mark.parametrize("name", _build.SOURCES + _build.HEADERS)
def test_no_source_uses_the_removed_mma_sync_helpers(name):
    """Every bf16 kernel is a wgmma kernel: no source has mma.sync in its
    assembly or names a helper that went with the old kernels."""
    text = (_build.CSRC / name).read_text()
    assert "mma.sync.aligned" not in text
    for helper in REMOVED_HELPERS:
        assert not re.search(rf"\b{helper}\b", text), (name, helper)


def test_the_prep_pass_is_declared_for_k3():
    assert "mh_attn_bwd_prep" in _entry_points()
    assert "mh_attn_bwd_prep" in fa.MH_KERNELS
    assert "mh_attn_bwd_prep" not in fa.MH_F32_KERNELS


def _dispatched_head_dims() -> set:
    """The head dims wgmma_tiles.cuh's by_head_dim instantiates (its cases;
    its default refuses)."""
    text = (_build.CSRC / "wgmma_tiles.cuh").read_text()
    body = text[text.index("int by_head_dim("):]
    body = body[:body.index("\n}\n")]
    assert "default:\n      return kBadArgument;" in body
    return {int(d) for d in re.findall(r"integral_constant<int, (\d+)>",
                                       body)}


def _entry_bodies(source: str) -> dict:
    """name -> the body of each `extern "C"` entry point of a source."""
    text = (_build.CSRC / source).read_text()
    starts = [(m.group(1), m.start()) for m in ENTRY.finditer(text)]
    ends = [s for _, s in starts[1:]] + [len(text)]
    return {name: text[s:e] for (name, s), e in zip(starts, ends)}


def test_every_qkv_head_dim_is_instantiated_and_gated():
    """K1/K2's entry points dispatch on D through by_head_dim: every D of
    HEAD_DIMS has an instance and any other D is refused; D above 128
    goes to K3's entry points (the strip kernels); the C signatures take D
    as an int after H, so SIGNATURES already carries it."""
    assert _dispatched_head_dims() == set(fa.HEAD_DIMS)
    for name, body in _entry_bodies("qkv_flash_attention.cu").items():
        assert "by_head_dim(D" in body, name
    text = (_build.CSRC / "qkv_flash_attention.cu").read_text()
    assert text.count("if constexpr (D > 128)") == 3
    for k3 in ("mh_attn_fwd(", "mh_attn_bwd_dkv(", "mh_attn_bwd_dq("):
        assert text.count(k3) == 2, k3  # declared, then called
    for name in fa.QKV_KERNELS:
        assert name in _build.SIGNATURES
        params = dict(_entry_points())[name]
        assert params.count("int") >= 4, (name, params)


def test_k4_head_dims_are_instantiated():
    assert _dispatched_head_dims() == set(fa.HEAD_DIMS)
    for name, body in _entry_bodies("hm_flash_attention.cu").items():
        assert "by_head_dim(D" in body, name


def test_k3_head_dims_are_instantiated():
    """K3's four entry points dispatch on D through by_head_dim too; dQ
    takes its output's row stride (K2 writes into dqkv through it)."""
    assert _dispatched_head_dims() == set(fa.HEAD_DIMS)
    bodies = _entry_bodies("mh_flash_attention.cu")
    assert set(bodies) == set(fa.MH_KERNELS)
    for name, body in bodies.items():
        assert "by_head_dim(D" in body, name
    assert "int lddq" in bodies["mh_attn_bwd_dq"]


@pytest.mark.parametrize("family,hd", [("qkv", 264), ("qkv", 320),
                                       ("qkv", 341), ("mh", 264),
                                       ("hm", 512)])
def test_the_qkv_gate_raises_outside_the_built_head_dims(family, hd):
    """Above 256 every family's gate takes the head dim at its width, the
    next multiple of 64 (the column-split kernels): at that width the gate
    passes and the check goes on to the device, at any other D it sends the
    caller to the padding first; below, it takes any D (head_dim_width
    gives the width it runs at)."""
    width = {264: 320, 320: 320, 341: 384, 512: 512}[hd]
    assert fa.head_dim_width(hd) == width
    gate = {"qkv": lambda d: fa._check_cuda(torch.zeros(2, 8, 3 * 4 * d), 4),
            "mh": lambda d: fa._check_mh(*[torch.zeros(2, 8, 4 * d)] * 3,
                                         None, 4),
            "hm": lambda d: fa._check_hm(torch.zeros(2, 8, d))}[family]
    with pytest.raises(ValueError, match="CUDA tensors"):
        gate(width)
    if hd != width:
        with pytest.raises(ValueError, match=f"pad it to {width}"):
            gate(hd)
    assert fa.qkv_head_dim(torch.zeros(2, 8, 3 * 4 * 200), 4) == 200
