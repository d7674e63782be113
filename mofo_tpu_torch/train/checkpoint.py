"""Weight carry between the JAX package and the port.

params_from_jax is the inverse of mofo_tpu/train/checkpoint.py's
import_torch_pretrain (:98-196): it takes the JAX PretrainVisionTransformer
parameter tree (nested dicts of numpy arrays) and returns a state_dict in
the reference VideoMAE layout that the port's modules carry, e.g.
encoder.blocks.0.attn.qkv.weight (out, in) and a Conv3d
patch_embed.proj.weight (D, C, p0, p, p). Saving, restoring and resuming
training state are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# flax leaf path (inside blocks_N) -> (torch name, transposed)
_BLOCK = {
    ("norm1", "scale"): ("norm1.weight", False),
    ("norm1", "bias"): ("norm1.bias", False),
    ("norm2", "scale"): ("norm2.weight", False),
    ("norm2", "bias"): ("norm2.bias", False),
    ("attn", "qkv_kernel"): ("attn.qkv.weight", True),
    ("attn", "q_bias"): ("attn.q_bias", False),
    ("attn", "v_bias"): ("attn.v_bias", False),
    ("attn", "proj_kernel"): ("attn.proj.weight", True),
    ("attn", "proj_bias"): ("attn.proj.bias", False),
    ("mlp", "fc1", "kernel"): ("mlp.fc1.weight", True),
    ("mlp", "fc1", "bias"): ("mlp.fc1.bias", False),
    ("mlp", "fc2", "kernel"): ("mlp.fc2.weight", True),
    ("mlp", "fc2", "bias"): ("mlp.fc2.bias", False),
    ("gamma_1",): ("gamma_1", False),
    ("gamma_2",): ("gamma_2", False),
}


def _leaves(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val, dtype=np.float32)


def _name(path, arr: np.ndarray, in_chans: int, tubelet_size: int):
    """(torch name, torch array) of one flax leaf."""
    if path[0] in ("encoder", "decoder") and path[1].startswith("blocks_"):
        i = int(path[1].split("_")[1])
        name, transposed = _BLOCK[tuple(path[2:])]
        return f"{path[0]}.blocks.{i}.{name}", arr.T if transposed else arr
    if path[:2] == ("encoder", "patch_embed"):
        if path[2] == "bias":
            return "encoder.patch_embed.proj.bias", arr
        # (p0*p*p*C, D), rows in (p0, p1, p2, c) order -> (D, C, p0, p, p)
        p = int(round((arr.shape[0] / (in_chans * tubelet_size)) ** 0.5))
        w = arr.reshape(tubelet_size, p, p, in_chans, arr.shape[1])
        return "encoder.patch_embed.proj.weight", w.transpose(4, 3, 0, 1, 2)
    if path[0] in ("encoder", "decoder") and path[1] in ("norm", "head"):
        leaf = {"scale": "weight", "kernel": "weight"}.get(path[2], path[2])
        return (f"{path[0]}.{path[1]}.{leaf}",
                arr.T if path[2] == "kernel" else arr)
    if path == ("encoder_to_decoder", "kernel"):
        return "encoder_to_decoder.weight", arr.T
    if path == ("mask_token",):
        return "mask_token", arr
    raise KeyError(f"no torch name for JAX parameter {'/'.join(path)}")


def params_from_jax(params: Mapping, *, in_chans: int = 3,
                    tubelet_size: int = 2) -> Dict[str, torch.Tensor]:
    """JAX PretrainVisionTransformer params -> the port's state_dict."""
    out = {}
    for path, arr in _leaves(params):
        name, value = _name(path, arr, in_chans, tubelet_size)
        out[name] = torch.from_numpy(np.array(value, order="C"))
    return out
