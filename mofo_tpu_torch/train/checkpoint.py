"""Weight carry between the JAX package and the port.

params_from_jax is the inverse of mofo_tpu/train/checkpoint.py's
import_torch_pretrain (:98-196) and import_torch_finetune (:199-239): it
takes a JAX parameter tree (nested dicts of numpy arrays) of a
PretrainVisionTransformer, a VisionTransformer or a
VisionTransformerBBFocused and returns a state_dict in the reference layout
that the port's modules carry, e.g. encoder.blocks.0.attn.qkv.weight
(out, in), a Conv3d patch_embed.proj.weight (D, C, p0, p, p),
backbone.blocks.0.mlp.fc1.weight or local_MCA.0.attn.q.weight.
finetune_init_from_pretrain starts a classifier from a pretrain model's
state_dict.

save_checkpoint, latest_checkpoint and auto_resume are the counterparts of
mofo_tpu/train/checkpoint.py:36-79: the JAX package saves orbax
directories, the port saves torch files checkpoint-<epoch>.pth in the
reference's layout (utils.py:411-496): {"model": state_dict, "optimizer":
torch AdamW's state_dict layout ("state" by parameter index with "step",
"exp_avg", "exp_avg_sq"; "param_groups" with the parameter names), "epoch",
"step", "args"}. A saved "model" loads into mofo_tpu through
load_torch_checkpoint + import_torch_pretrain.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

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


# flax leaf path (inside local_MCA_N) -> (torch name, transposed)
_MCA = {
    ("norm1", "scale"): ("norm1.weight", False),
    ("norm1", "bias"): ("norm1.bias", False),
    ("norm2", "scale"): ("norm2.weight", False),
    ("norm2", "bias"): ("norm2.bias", False),
    ("attn", "q_kernel"): ("attn.q.weight", True),
    ("attn", "kv_kernel"): ("attn.kv.weight", True),
    ("attn", "q_bias"): ("attn.q_bias", False),
    ("attn", "v_bias"): ("attn.v_bias", False),
    ("attn", "proj", "kernel"): ("attn.proj.weight", True),
    ("attn", "proj", "bias"): ("attn.proj.bias", False),
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
    full, scope = path, ()
    if path[0] in ("encoder", "decoder", "backbone"):
        scope, path = path[:1], path[1:]
    join = lambda *parts: ".".join(scope + parts)  # noqa: E731
    if path[0].startswith("blocks_"):
        name, transposed = _BLOCK[tuple(path[1:])]
        return (join("blocks", path[0].split("_")[1], name),
                arr.T if transposed else arr)
    if path[0] == "patch_embed":
        if path[1] == "bias":
            return join("patch_embed.proj.bias"), arr
        # (p0*p*p*C, D), rows in (p0, p1, p2, c) order -> (D, C, p0, p, p)
        p = int(round((arr.shape[0] / (in_chans * tubelet_size)) ** 0.5))
        w = arr.reshape(tubelet_size, p, p, in_chans, arr.shape[1])
        return join("patch_embed.proj.weight"), w.transpose(4, 3, 0, 1, 2)
    if path[0] in ("norm", "head", "fc_norm") and len(path) == 2:
        leaf = {"scale": "weight", "kernel": "weight"}.get(path[1], path[1])
        return (join(path[0], leaf),
                arr.T if path[1] == "kernel" else arr)
    if not scope and path[0].startswith("local_MCA_"):
        name, transposed = _MCA[tuple(path[1:])]
        return (f"local_MCA.{path[0].split('_')[-1]}.{name}",
                arr.T if transposed else arr)
    if not scope and path[0].startswith("soft_att_") and len(path) == 2:
        return f"{path[0]}.{path[1]}", arr  # weight (D, 1), b (1,)
    if full == ("encoder_to_decoder", "kernel"):
        return "encoder_to_decoder.weight", arr.T
    if full == ("mask_token",):
        return "mask_token", arr
    raise KeyError(f"no torch name for JAX parameter {'/'.join(full)}")


def params_from_jax(params: Mapping, *, in_chans: int = 3,
                    tubelet_size: int = 2) -> Dict[str, torch.Tensor]:
    """JAX PretrainVisionTransformer, VisionTransformer or
    VisionTransformerBBFocused params -> the port's state_dict. Raises on a
    leaf it has no name for."""
    out = {}
    for path, arr in _leaves(params):
        name, value = _name(path, arr, in_chans, tubelet_size)
        out[name] = torch.from_numpy(np.array(value, order="C"))
    return out


def finetune_init_from_pretrain(model: torch.nn.Module,
                                pretrain_state_dict: Mapping) -> list:
    """Copies a pretrain model's encoder (encoder.patch_embed.*,
    encoder.blocks.* and encoder.norm.* where the classifier has a final
    norm) into a classifier's backbone (`model.backbone` for the BB-focused
    model), keeping its fresh fc_norm, head and fusing modules: the
    counterpart of mofo_tpu/train/checkpoint.py:253-279 (reference
    run_class_finetuning.py:350-383). Returns the copied names."""
    target = getattr(model, "backbone", model)
    own = target.state_dict()
    copied = {}
    for name, value in pretrain_state_dict.items():
        if name.startswith("encoder.") and name[8:] in own:
            copied[name[8:]] = value
    if not copied:
        raise ValueError("no encoder.* entry of the pretrain state_dict "
                         "matches the classifier")
    target.load_state_dict(copied, strict=False)
    return sorted(copied)


def save_checkpoint(output_dir: str, model: torch.nn.Module, state,
                    epoch: int, args=None) -> str:
    """Writes the model, the AdamW moments and step, the train step and the
    epoch to <output_dir>/checkpoint-<epoch>.pth (through a temporary file,
    so a reader never sees half a file). `state` is the TrainState of
    `model`; `args` an argparse.Namespace of the run or None."""
    opt = state.opt_state
    names = list(state.params)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    payload = {
        "model": {k: cpu(v) for k, v in model.state_dict().items()},
        "optimizer": {
            "state": {i: {"step": torch.tensor(float(opt.count)),
                          "exp_avg": cpu(opt.mu[n]),
                          "exp_avg_sq": cpu(opt.nu[n])}
                      for i, n in enumerate(names)},
            "param_groups": [{"params": list(range(len(names))),
                              "param_names": names}],
        },
        "epoch": epoch,
        "step": state.step,
    }
    if state.ema_params is not None:
        payload["model_ema"] = {k: cpu(v) for k, v in state.ema_params.items()}
    if args is not None:
        payload["args"] = dict(vars(args))
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"checkpoint-{epoch}.pth")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module, state) -> int:
    """Restores a save_checkpoint file into `model` and its TrainState in
    place (parameters, AdamW moments and count, step, EMA). Returns the
    checkpoint's epoch. Raises when the parameter names differ."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    opt = ckpt["optimizer"]
    names = opt["param_groups"][0]["param_names"]
    if names != list(state.params):
        raise ValueError(f"{path} holds other parameters than the model")
    model.load_state_dict(ckpt["model"])
    with torch.no_grad():
        for i, n in enumerate(names):
            state.opt_state.mu[n].copy_(opt["state"][i]["exp_avg"])
            state.opt_state.nu[n].copy_(opt["state"][i]["exp_avg_sq"])
        if state.ema_params is not None and "model_ema" in ckpt:
            for n, v in ckpt["model_ema"].items():
                state.ema_params[n].copy_(v)
    state.opt_state.count = int(opt["state"][0]["step"]) if names else 0
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def latest_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    """(path, epoch) of checkpoint-<n>.pth with the highest n (the
    reference's auto_resume glob), None when there is none."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    for entry in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)\.pth", entry)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (os.path.join(output_dir, entry), int(m.group(1)))
    return best


def auto_resume(output_dir: str, model: torch.nn.Module,
                state) -> Optional[int]:
    """Restores the latest checkpoint of output_dir into model and state;
    returns its epoch, or None when there is none."""
    found = latest_checkpoint(output_dir)
    if found is None:
        return None
    return load_checkpoint(found[0], model, state)
