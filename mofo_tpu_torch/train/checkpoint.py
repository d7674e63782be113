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
a torch optimizer's state_dict layout ("state" by parameter index with
"step" and the optimizer's buffers; "param_groups" with the parameter
names), "epoch", "step", "args"}, plus "model_ema" with EMA and "scaler"
(the fp16 loss scale) when the run has them. The buffers carry the names
of the reference's torch optimizers where they have one ("exp_avg" /
"exp_avg_sq" for the Adam family and AdamP, "momentum_buffer" for SGD and
SGDP, "exp_hessian_diag_sq" for AdaHessian, "slow_buffer" with the group's
"lookahead_step" for lookahead), the optax stage's field names otherwise
(Adafactor's "v_row" / "v_col" / "v", ...). A saved "model" loads into
mofo_tpu through load_torch_checkpoint + import_torch_pretrain (or
import_torch_finetune).
save_checkpoint's `name` writes a named file instead, e.g. the finetune
runner's checkpoint-best.pth, which latest_checkpoint skips;
load_checkpoint restores any such file. load_pretrain_encoder reads the
pretrain .pth that --finetune names. With more than one process, rank 0
writes each file and every rank waits at a barrier after it; every rank
reads (on auto-resume and --finetune) onto its own device. The model
saved is the module itself, never its DistributedDataParallel wrapper, so
the names carry no `module.` prefix. A model sharded on a mesh
(parallel/mesh.py) is saved whole: every rank gathers each parameter, its
moments and its EMA to the full tensor in the reference's names and row
order (Sharding.full, a collective) and rank 0 writes them; a load reads
the full tensors on every rank and keeps each rank's shard, so a file
written on one mesh resumes on any other, or in one process. Each state
tensor is gathered and cut by its own layout (the optimizer's
OptState.layouts), not by its shape: Adafactor's row and column moments
are cut along the parameter's axes that survive in them, Novograd's
per-tensor moment is whole on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.device import device_of
from mofo_tpu_torch.parallel import ddp

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


# flax leaf path (inside a scope, at its top) -> (torch name, transposed)
_TOP = {
    ("norm", "scale"): ("norm.weight", False),
    ("norm", "bias"): ("norm.bias", False),
    ("fc_norm", "scale"): ("fc_norm.weight", False),
    ("fc_norm", "bias"): ("fc_norm.bias", False),
    ("head", "kernel"): ("head.weight", True),
    ("head", "bias"): ("head.bias", False),
}

# the patch embedding's (t*p*p*C, D) kernel as (t, p, p, C, D) -> the
# Conv3d weight (D, C, t, p, p)
_CONV_PERM = (4, 3, 0, 1, 2)
_SCOPES = ("encoder", "decoder", "backbone")
# torch name (inside blocks.N, local_MCA.N, or a scope's top) -> transposed
_TRANSPOSED = {"blocks": dict(_BLOCK.values()),
               "local_MCA": dict(_MCA.values()),
               None: dict(_TOP.values(),
                          **{"encoder_to_decoder.weight": True})}


def _layout(name: str) -> Tuple[bool, bool]:
    """(transposed, permuted): how _name lays out the port's parameter
    `name` from mofo_tpu's leaf; a name outside its tables (pos_embed,
    mask_token, soft_att_*) is the same array in both packages."""
    parts = name.split(".")
    if parts[0] in _SCOPES:
        parts = parts[1:]
    if parts == ["patch_embed", "proj", "weight"]:
        return False, True
    if parts[0] in ("blocks", "local_MCA"):
        return _TRANSPOSED[parts[0]].get(".".join(parts[2:]), False), False
    return _TRANSPOSED[None].get(".".join(parts), False), False


def jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """`t` (the port's parameter `name`, or a tensor of its shape) in
    mofo_tpu's layout, as _name maps one to the other: a Dense kernel
    (in, out) for a Linear weight (out, in), the (t*p*p*C, D) kernel for
    the Conv3d patch embedding; a view where it can be."""
    transposed, permuted = _layout(name)
    if permuted:
        inverse = tuple(int(i) for i in np.argsort(_CONV_PERM))
        return t.permute(inverse).reshape(-1, t.shape[0])
    return t.t() if transposed else t


def torch_layout(name: str, t: torch.Tensor,
                 shape: Sequence[int]) -> torch.Tensor:
    """The inverse of jax_layout for the port's parameter `name` of
    `shape`."""
    transposed, permuted = _layout(name)
    if permuted:
        D, C, tt, p, q = shape
        return t.reshape(tt, p, q, C, D).permute(_CONV_PERM)
    return t.t() if transposed else t


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
        return join("patch_embed.proj.weight"), w.transpose(_CONV_PERM)
    if tuple(path) in _TOP:
        name, transposed = _TOP[tuple(path)]
        return join(name), arr.T if transposed else arr
    if not scope and path[0].startswith("local_MCA_"):
        name, transposed = _MCA[tuple(path[1:])]
        return (f"local_MCA.{path[0].split('_')[-1]}.{name}",
                arr.T if transposed else arr)
    if not scope and path[0].startswith("soft_att_") and len(path) == 2:
        return f"{path[0]}.{path[1]}", arr  # weight (D, 1), b (1,)
    if full == ("encoder_to_decoder", "kernel"):  # _TRANSPOSED[None]
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


def load_pretrain_encoder(path: str, map_location="cpu"
                          ) -> Dict[str, torch.Tensor]:
    """The state_dict of a pretrain checkpoint (.pth / .pt, the reference's
    layout: "model" holding encoder.* names, as the port's pretrain runner
    writes it) for finetune_init_from_pretrain: the counterpart of
    mofo_tpu/cli/finetune.py:189-202. An orbax directory is a JAX format,
    which the port does not read."""
    if os.path.isdir(path) or not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"{path}: not a .pth file. An orbax checkpoint directory is the "
            "JAX package's format, which the port does not read; pass a "
            "torch checkpoint (the port's pretrain runner writes them)")
    sd = torch.load(path, map_location=map_location, weights_only=True)
    for key in ("model", "module"):
        if isinstance(sd.get(key), dict):
            return sd[key]
    return sd


def save_checkpoint(output_dir: str, model: torch.nn.Module, state,
                    epoch: int, args=None, name: Optional[str] = None) -> str:
    """Writes the model, the optimizer's state and count, the train step
    and the epoch to <output_dir>/checkpoint-<epoch>.pth, or
    <output_dir>/<name>.pth (through a temporary file, so a reader never
    sees half a file). `state` is the TrainState of `model`; `args` an
    argparse.Namespace of the run or None. A DistributedDataParallel wrapper
    is saved as its module. With more than one process rank 0 writes and
    every rank waits for it; all return the path."""
    model = ddp.unwrap(model)
    path = os.path.join(output_dir, f"{name or f'checkpoint-{epoch}'}.pth")
    sharding = model.__dict__.get("_sharding")
    if sharding is not None or distributed.is_main_process():
        payload = _payload(model, state, epoch, args, sharding)
        if distributed.is_main_process():
            _write(path, payload)
    distributed.barrier()
    return path


def _payload(model: torch.nn.Module, state, epoch: int, args,
             sharding=None) -> dict:
    opt = state.opt_state
    names = list(state.params)
    layouts = _state_layouts(opt, sharding)

    def cpu(n, t, lay=None):
        if sharding is not None:
            t = sharding.full(n, t, lay)
        return t.detach().cpu()

    per_param = {}
    for i, n in enumerate(names):
        entry = {opt.keys[f]: cpu(n, buf[n], layouts[f][n])
                 for f, buf in opt.buffers.items() if n in buf}
        if opt.slow is not None and n in opt.slow:
            entry["slow_buffer"] = cpu(n, opt.slow[n])
        if entry:  # torch keeps no state for a parameter it never updates
            per_param[i] = {"step": torch.tensor(float(opt.count)), **entry}
    group = {"params": list(range(len(names))), "param_names": names}
    if opt.slow is not None:
        group["lookahead_step"] = opt.count
    weights = (model.state_dict() if sharding is None
               else sharding.full_state_dict(model))
    payload = {
        "model": {k: v.detach().cpu() for k, v in weights.items()},
        "optimizer": {"state": per_param, "param_groups": [group]},
        "epoch": epoch,
        "step": state.step,
    }
    if state.ema_params is not None:
        payload["model_ema"] = {k: cpu(k, v)
                                for k, v in state.ema_params.items()}
    if state.loss_scale is not None:
        payload["scaler"] = {"scale": state.loss_scale.scale,
                             "good_steps": state.loss_scale.good_steps}
    if args is not None:
        payload["args"] = dict(vars(args))
    return payload


def _state_layouts(opt, sharding) -> Dict[str, Dict]:
    """field -> name -> the Layout of each optimizer state tensor (None: as
    its parameter) for a sharded model, whose optimizer must have been
    made with its sharding."""
    if sharding is None:
        return {f: dict.fromkeys(buf) for f, buf in opt.buffers.items()}
    if opt.layouts is None:
        raise ValueError("the optimizer of a model sharded on a mesh must "
                         "be made with its sharding (create_optimizer's "
                         "sharding=)")
    return opt.layouts


def _write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module, state) -> int:
    """Restores a save_checkpoint file into `model` and its TrainState in
    place (parameters, the optimizer's state and count, step, EMA), read
    onto the model's device; a model sharded on a mesh keeps this rank's
    shard of each tensor. Returns the checkpoint's epoch. Raises when the
    parameter names or the optimizer's buffers differ."""
    ckpt = torch.load(path, map_location=device_of(model) or "cpu",
                      weights_only=True)
    opt = ckpt["optimizer"]
    names = opt["param_groups"][0]["param_names"]
    if names != list(state.params):
        raise ValueError(f"{path} holds other parameters than the model")
    sharding = model.__dict__.get("_sharding")
    ours = state.opt_state
    layouts = _state_layouts(ours, sharding)
    if sharding is None:
        model.load_state_dict(ckpt["model"])
        local = lambda n, full, lay=None: full  # noqa: E731
    else:
        sharding.load_full_state_dict(model, ckpt["model"])
        local = sharding.shard
    saved = {names[i]: s for i, s in opt["state"].items()}
    targets = {}  # name -> checkpoint key -> (the state's tensor, layout)
    for f, buf in ours.buffers.items():
        for n, t in buf.items():
            targets.setdefault(n, {})[ours.keys[f]] = (t, layouts[f][n])
    for n, t in (ours.slow or {}).items():
        targets.setdefault(n, {})["slow_buffer"] = (t, None)
    if {n: sorted(k) for n, k in targets.items()} != {
            n: sorted(set(s) - {"step"}) for n, s in saved.items()}:
        raise ValueError(f"{path} holds the moments of other parameters "
                         "or of another optimizer")
    with torch.no_grad():
        for n, keys in targets.items():
            for key, (t, lay) in keys.items():
                t.copy_(local(n, saved[n][key], lay))
        if state.ema_params is not None and "model_ema" in ckpt:
            for n, v in ckpt["model_ema"].items():
                state.ema_params[n].copy_(local(n, v))
    ours.count = (int(next(iter(saved.values()))["step"]) if saved
                  else 0)
    if state.loss_scale is not None and "scaler" in ckpt:
        state.loss_scale = dataclasses.replace(
            state.loss_scale, scale=float(ckpt["scaler"]["scale"]),
            good_steps=int(ckpt["scaler"]["good_steps"]))
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
