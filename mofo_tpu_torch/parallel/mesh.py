"""The device mesh and its sharding rules: the counterpart of
mofo_tpu/parallel/mesh.py.

  axes ('data', 'fsdp', 'model') (:30)
    data  - data parallelism: the batch is sharded, gradients summed
    fsdp  - parameters, their gradients, the optimizer's moments and the
            EMA sharded along one weight axis and gathered before use; the
            batch is sharded over ('data', 'fsdp') jointly (:61-63)
    model - tensor parallelism over attention heads and MLP hidden units

One process is one device: a mesh of shape (data, fsdp, model) spans
data * fsdp * model processes, and rank r sits at coordinate (d, f, m) with
r = (d * fsdp + f) * model + m, the row-major order in which :55-57 lays
out jax.devices(). MeshConfig.resolve accepts exactly what mofo_tpu's
(:35-49) accepts for a world size, and raises ValueError (not an assert,
which python -O strips) with the same condition otherwise; it also refuses
an fsdp or model axis below 1.

The batch coordinate of a rank is b = d * fsdp + f, one of data * fsdp;
the model peers of a coordinate (the ranks that differ in m alone) hold
the same rows and make the same draws. The batch axis (`Mesh.batch`) is
the ranks that share this rank's m, in b order: the metrics, the eval
sums, mixup's partner rows and the multi-view merge run over it only, so
no model peer is counted twice.

spec_for_param is _spec_for_param (:106-144) keyed by the reference's
state_dict names in the torch layout (a Linear weight is (out, in), mofo_tpu's
Dense kernel (in, out); the Conv3d patch embedding (D, C, t, p, p) against
its (t*p*p*C, D) kernel): per dim, "fsdp", "model" or None. An axis whose
size does not divide its dim, or whose size is 1, is dropped (:154-168).
The port adds one rule of its own: a module whose heads do not divide over
the model axis (the ViT-B MCA's 3 x 256 at model 2, the ViT-S decoder's
3 x 64, the tiny BB model's 2 x 32 at model 4) stays replicated over model
and each model rank computes it whole, where GSPMD shards the projection's
dim anyway; this is the port's counterpart of the drop-axes rule. And the
fused qkv (and the MCA's kv) is split by heads inside each of q, k and v:
rank m holds rows [q_m; k_m; v_m] of the (3A, D) weight, not a contiguous
third of it (:123-124's P("fsdp", "model") on the (D, 3A) kernel cuts
across the q/k/v boundary, which GSPMD tolerates and a per-rank K1 cannot).
full_state_dict puts the rows back in the reference's order.

shard_model replaces each parameter with this rank's shard (same name, the
local shape) and tells the modules their model axis and their fsdp dims;
the returned Sharding (also `sharding_of(model)`) carries the layouts and
reduces gradients (the fsdp-sharded ones arrive summed over fsdp from the
gathers' backward and are summed over data; the others over the batch
axis; all divided by the batch coordinates' count), takes whole-tensor
norms over each parameter's shard axes, gathers full tensors for the
checkpoints and shards them back on load.

The optimizer stages that read a tensor's layout (train/optim.py's
Adafactor and AdamP / SGDP) work on mofo_tpu's layout of a parameter
(train/checkpoint.py's jax_layout: a Linear weight transposed, the Conv3d
patch embedding as its (t*p*p*C, D) kernel, so the fsdp cut of the conv's
D, torch dim 0, is jax axis 1). The Sharding gives them the full shape in
that layout (full_jax_shape), the mesh axis that cuts each jax axis
(jax_cuts), the layout of a tensor reduced over one jax axis
(reduced_layout: Adafactor's row and column moments stay cut where the
parameter is) and sums over the axes that cut a dim (sum_over: one
all-reduce a mesh axis for any number of tensors). A state tensor's layout
may differ from its parameter's, so the gathers and shards of the
checkpoints take an explicit one (full, shard).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mofo_tpu_torch.parallel import tensor_parallel as tp
from mofo_tpu_torch.parallel.tensor_parallel import Axis
from mofo_tpu_torch.train.checkpoint import _layout, jax_layout

AXES = ("data", "fsdp", "model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1 = all remaining devices
    fsdp: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int]:
        """(data, fsdp, model) for n_devices, as mofo_tpu's resolve."""
        for axis in ("fsdp", "model"):
            if getattr(self, axis) < 1:
                raise ValueError(f"{axis}={getattr(self, axis)}: an axis "
                                 "spans at least one device")
        data = self.data
        if data == -1:
            if n_devices % (self.fsdp * self.model):
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*model="
                    f"{self.fsdp * self.model}")
            data = n_devices // (self.fsdp * self.model)
        if data * self.fsdp * self.model != n_devices:
            raise ValueError(f"data*fsdp*model={data}*{self.fsdp}*"
                             f"{self.model} != {n_devices} devices")
        return (data, self.fsdp, self.model)


class Mesh:
    """The mesh as rank `rank` sees it: `shape`, `coord` (d, f, m) and the
    axes data, fsdp, model and batch (data x fsdp at this rank's m)."""

    def __init__(self, shape: Tuple[int, int, int], rank: int,
                 groups: Optional[Dict[Tuple[int, ...], object]] = None):
        D, F, M = shape
        self.shape, self.rank, self.world = shape, rank, D * F * M
        d, rest = divmod(rank, F * M)
        f, m = divmod(rest, M)
        self.coord = (d, f, m)
        groups = groups or {}

        def axis(name, ranks):
            ranks = tuple(ranks)
            return Axis(name, len(ranks), ranks.index(rank), ranks,
                        groups.get(ranks) if len(ranks) > 1 else None)

        at = lambda d_, f_, m_: (d_ * F + f_) * M + m_  # noqa: E731
        self.data = axis("data", (at(i, f, m) for i in range(D)))
        self.fsdp = axis("fsdp", (at(d, i, m) for i in range(F)))
        self.model = axis("model", (at(d, f, i) for i in range(M)))
        self.batch = axis("batch", (at(i, j, m) for i in range(D)
                                    for j in range(F)))

    @property
    def sharded(self) -> bool:
        """Whether the mesh shards parameters (fsdp or model above 1)."""
        return self.shape[1] > 1 or self.shape[2] > 1


def _axis_rank_sets(shape: Tuple[int, int, int]) -> List[Tuple[int, ...]]:
    """Every group of every axis (and the batch axis), in one order that
    every rank walks alike."""
    D, F, M = shape
    at = lambda d, f, m: (d * F + f) * M + m  # noqa: E731
    sets = []
    sets += [tuple(at(i, f, m) for i in range(D))
             for f in range(F) for m in range(M)]
    sets += [tuple(at(d, i, m) for i in range(F))
             for d in range(D) for m in range(M)]
    sets += [tuple(at(d, f, i) for i in range(M))
             for d in range(D) for f in range(F)]
    sets += [tuple(at(i, j, m) for i in range(D) for j in range(F))
             for m in range(M)]
    out = []
    for s in sets:
        if len(s) > 1 and s not in out:
            out.append(s)
    return out


def build_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh of `config` over the default process group (every rank
    calls it), or over this one process when no group is up. Raises
    ValueError for a mesh that resolve refuses at the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = config.resolve(world)
    groups = {}
    if world > 1:
        everyone = tuple(range(world))
        for ranks in _axis_rank_sets(shape):
            groups[ranks] = (dist.group.WORLD if ranks == everyone
                             else dist.new_group(list(ranks)))
    return Mesh(shape, rank, groups)


# ---------------------------------------------------------------------------
# The sharding rules
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]


def spec_for_param(name: str, shape: Sequence[int]) -> Spec:
    """The axis of each dim of the port's parameter `name` (torch layout):
    mofo_tpu's _spec_for_param (:106-144) on the same leaf, transposed with
    it. The MCA's proj is a plain Dense there (fsdp on its input dim)."""
    parts = name.split(".")
    mca = "local_MCA" in parts
    tail = ".".join(parts[-3:])
    if tail == "attn.qkv.weight":
        return ("model", "fsdp")
    if parts[-2:] in (["attn", "q_bias"], ["attn", "v_bias"]):
        return ("model",)
    if tail in ("attn.q.weight", "attn.kv.weight"):
        return ("model", "fsdp")
    if tail == "attn.proj.weight" and not mca:
        return ("fsdp", "model")
    if tail == "mlp.fc1.weight":
        return ("model", "fsdp")
    if tail == "mlp.fc1.bias":
        return ("model",)
    if tail == "mlp.fc2.weight":
        return ("fsdp", "model")
    if tail == "patch_embed.proj.weight":
        return ("fsdp",) + (None,) * (len(shape) - 1)
    if len(shape) == 2 and _layout(name)[0]:
        # a generic Dense kernel (head, encoder_to_decoder, the MCA's proj):
        # fsdp on its input dim
        return (None, "fsdp")
    return (None,) * len(shape)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a parameter is cut: the dim sharded over fsdp and the dim
    sharded over model (None for neither), and the sections of a fused
    projection (3 for qkv, 2 for kv) inside each of which the model axis
    splits the heads."""

    fsdp: Optional[int] = None
    model: Optional[int] = None
    sections: int = 1

    @property
    def replicated(self) -> bool:
        return self.fsdp is None and self.model is None


def sections_of(name: str) -> int:
    tail = ".".join(name.split(".")[-3:])
    return {"attn.qkv.weight": 3, "attn.kv.weight": 2}.get(tail, 1)


def layout_for(name: str, shape: Sequence[int], mesh_shape: Sequence[int],
               model_ok: bool = True) -> Layout:
    """spec_for_param with the axes dropped that do not divide their dim or
    have size 1 (:154-168), and the model axis dropped where `model_ok` is
    False (a module whose heads do not divide)."""
    sizes = {"fsdp": mesh_shape[1], "model": mesh_shape[2]}
    dims = {}
    for i, (n, axis) in enumerate(zip(shape, spec_for_param(name, shape))):
        if axis is None or sizes[axis] == 1 or n % sizes[axis]:
            continue
        if axis == "model" and not model_ok:
            continue
        dims[axis] = i
    return Layout(dims.get("fsdp"), dims.get("model"),
                  sections_of(name) if "model" in dims else 1)


def _take(x: torch.Tensor, dim: int, n: int, i: int,
          sections: int = 1) -> torch.Tensor:
    """Part i of n of x along dim, cut inside each of `sections` blocks."""
    shape = list(x.shape)
    view = x.reshape(shape[:dim] + [sections, n, shape[dim] // (sections * n)]
                     + shape[dim + 1:])
    shape[dim] //= n
    return view.select(dim + 1, i).reshape(shape)


def shard_tensor(full: torch.Tensor, lay: Layout, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a full tensor cut as `lay` says."""
    x = full
    if lay.model is not None:
        x = _take(x, lay.model, mesh.model.size, mesh.model.index,
                  lay.sections)
    if lay.fsdp is not None:
        x = _take(x, lay.fsdp, mesh.fsdp.size, mesh.fsdp.index)
    return x


def _jax_axis(name: str, dim: int) -> int:
    """The axis of mofo_tpu's layout of parameter `name` (jax_layout) that
    holds torch dim `dim`: transposed for a Linear weight; the Conv3d
    patch embedding's D (dim 0) is axis 1 of its (t*p*p*C, D) kernel, its
    other dims flatten into axis 0."""
    transposed, permuted = _layout(name)
    if permuted:
        return 1 if dim == 0 else 0
    return 1 - dim if transposed else dim


def _join(parts: Sequence[torch.Tensor], dim: int,
          sections: int = 1) -> torch.Tensor:
    """The inverse of _take over every i."""
    shape = list(parts[0].shape)
    split = [p.reshape(shape[:dim] + [sections, shape[dim] // sections]
                       + shape[dim + 1:]) for p in parts]
    shape[dim] *= len(parts)
    return torch.stack(split, dim + 1).reshape(shape)


# ---------------------------------------------------------------------------
# A model on the mesh
# ---------------------------------------------------------------------------


class Sharding:
    """A model's parameters on a mesh: `layouts` by parameter name."""

    def __init__(self, mesh: Mesh, layouts: Dict[str, Layout]):
        self.mesh, self.layouts = mesh, layouts

    # --- full tensors and shards -------------------------------------------

    def shard(self, name: str, full: torch.Tensor,
              lay: Optional[Layout] = None) -> torch.Tensor:
        """This rank's shard of a full tensor cut as `lay` says (by default
        as parameter `name` is)."""
        return shard_tensor(full, self.layouts[name] if lay is None else lay,
                            self.mesh)

    def local_shape(self, name: str, shape: Sequence[int]) -> Tuple[int, ...]:
        lay, out = self.layouts[name], list(shape)
        if lay.model is not None:
            out[lay.model] //= self.mesh.model.size
        if lay.fsdp is not None:
            out[lay.fsdp] //= self.mesh.fsdp.size
        return tuple(out)

    def full_shape(self, name: str, local: Sequence[int]) -> Tuple[int, ...]:
        """The inverse of local_shape."""
        lay, out = self.layouts[name], list(local)
        if lay.model is not None:
            out[lay.model] *= self.mesh.model.size
        if lay.fsdp is not None:
            out[lay.fsdp] *= self.mesh.fsdp.size
        return tuple(out)

    def full(self, name: str, local: torch.Tensor,
             lay: Optional[Layout] = None) -> torch.Tensor:
        """The full tensor, reference row order, from every rank's shard of
        a tensor cut as `lay` says (by default as parameter `name` is); a
        collective: every rank calls it."""
        lay, mesh = self.layouts[name] if lay is None else lay, self.mesh
        x = local.detach()
        if lay.fsdp is not None:
            x = tp.all_gather(x, mesh.fsdp, lay.fsdp)
        if lay.model is not None:
            parts = tp.all_gather(x, mesh.model, lay.model).chunk(
                mesh.model.size, lay.model)
            x = _join(parts, lay.model, lay.sections)
        return x

    # --- mofo_tpu's layout of a parameter ------------------------------------

    def full_jax_shape(self, name: str,
                       local: Sequence[int]) -> Tuple[int, ...]:
        """The full shape of parameter `name` (whose shard has the torch
        shape `local`) in mofo_tpu's layout."""
        full = torch.empty(self.full_shape(name, local), device="meta")
        return tuple(jax_layout(name, full).shape)

    def jax_cuts(self, name: str) -> Dict[int, str]:
        """jax axis -> the mesh axis ("fsdp" or "model") that cuts it, for
        each cut axis of parameter `name` in mofo_tpu's layout."""
        lay = self.layouts[name]
        return {_jax_axis(name, getattr(lay, key)): key
                for key in ("fsdp", "model") if getattr(lay, key) is not None}

    def reduced_layout(self, name: str, drop: int) -> Layout:
        """The layout of parameter `name`'s tensor in mofo_tpu's layout
        with jax axis `drop` reduced away: each other axis keeps its cut
        (the model cut its sections)."""
        dims = {}
        for axis, key in self.jax_cuts(name).items():
            if axis != drop:
                dims[key] = axis - (axis > drop)
        return Layout(dims.get("fsdp"), dims.get("model"),
                      self.layouts[name].sections if "model" in dims else 1)

    def sum_over(self, items: Sequence[Tuple[torch.Tensor, Sequence[str]]]
                 ) -> List[torch.Tensor]:
        """Each tensor summed over the mesh axes ("fsdp", "model") named
        with it: one flat all-reduce a mesh axis for all of them (one
        dtype). A tensor with no axis comes back as it is."""
        out = [t for t, _ in items]
        for key in ("fsdp", "model"):
            axis = getattr(self.mesh, key)
            at = [i for i, (_, keys) in enumerate(items) if key in keys]
            if not at or axis.size == 1:
                continue
            flat = tp.all_reduce(torch.cat([out[i].reshape(-1) for i in at]),
                                 axis)
            for i, part in zip(at, flat.split([out[i].numel()
                                               for i in at])):
                out[i] = part.view_as(out[i])
        return out

    # --- gradients and norms -----------------------------------------------

    def reduce_grads(self, *dicts: Dict[str, torch.Tensor]) -> None:
        """In place, the mean over the batch coordinates of each name ->
        tensor dict (the gradients; a second-order step's probes z * Hz
        too, which arrive summed as the gradients do): the fsdp-sharded
        tensors (already summed over fsdp by the gathers' backward) summed
        over data, every other one over the batch axis, then all divided by
        the count of batch coordinates."""
        mesh = self.mesh
        for axis, on_fsdp in ((mesh.data, True), (mesh.batch, False)):
            ts = [d[n] for d in dicts for n in d if d[n] is not None
                  and (self.layouts[n].fsdp is not None) == on_fsdp]
            if not ts or axis.size == 1:
                continue
            flat = tp.all_reduce(torch.cat([t.reshape(-1) for t in ts]), axis)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
        if mesh.batch.size > 1:
            torch._foreach_div_([t for d in dicts for t in d.values()
                                 if t is not None], float(mesh.batch.size))

    def sq_norms(self, names: Sequence[str],
                 tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared f32 norm of each tensor whole (a vector): each
        shard's squared norm summed over the axes its parameter is sharded
        over, a replicated one counted once."""
        local = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
        sq = local * local
        for axis, key in ((self.mesh.fsdp, "fsdp"), (self.mesh.model, "model")):
            if axis.size == 1:
                continue
            on = torch.tensor([getattr(self.layouts[n], key) is not None
                               for n in names], device=sq.device)
            if bool(on.any()):
                sq = torch.where(on, tp.all_reduce(sq * on, axis), sq)
        return sq

    def norms(self, names: Sequence[str],
              tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's whole f32 norm (0-d tensors)."""
        return list(torch.sqrt(self.sq_norms(names, tensors)).unbind())

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """train.optim.global_norm of the full gradients."""
        return torch.sqrt(self.sq_norms(list(grads), list(grads.values()))
                          .sum())

    # --- the model ----------------------------------------------------------

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's state_dict with every parameter whole, under the
        reference's names and row order (every rank calls it)."""
        out = {}
        for name, t in model.state_dict().items():
            out[name] = (self.full(name, t) if name in self.layouts
                         else t.detach())
        return out

    @torch.no_grad()
    def load_full_state_dict(self, model: nn.Module,
                             state_dict: Dict[str, torch.Tensor]) -> None:
        """Copies this rank's shard of each full tensor into the model
        (strict: the names must be the model's)."""
        own = model.state_dict()
        if set(own) != set(state_dict):
            missing = sorted(set(own) ^ set(state_dict))[:5]
            raise ValueError(f"the state_dict's names differ from the "
                             f"model's: {missing}")
        for name, t in own.items():
            value = state_dict[name].to(t.device)
            t.copy_(self.shard(name, value) if name in self.layouts
                    else value)

    @contextlib.contextmanager
    def gathered(self, model: nn.Module) -> Iterator[None]:
        """Inside, the forward reads every fsdp-sharded parameter from one
        gather made on entry (no collective over fsdp per call, so ranks may
        make different numbers of eval calls); no gradient flows."""
        values = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                if self.layouts[name].fsdp is not None:
                    values[id(p)] = tp.all_gather(
                        p.detach(), self.mesh.fsdp, self.layouts[name].fsdp)
        with tp.gathered(values):
            yield


def sharding_of(model: nn.Module) -> Optional[Sharding]:
    """The Sharding shard_model gave `model`, None for a model it did not
    shard."""
    return model.__dict__.get("_sharding")


def _model_axis_modules(model: nn.Module, M: int) -> Dict[str, bool]:
    """module name -> whether it splits over the model axis: attention
    modules whose heads divide by M, MLPs whose hidden units do."""
    from mofo_tpu_torch.models.layers import Attention, CrossAttention, Mlp

    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (Attention, CrossAttention)):
            out[name] = M > 1 and mod.num_heads % M == 0
        elif isinstance(mod, Mlp):
            out[name] = M > 1 and mod.fc1.out_features % M == 0
    return out


def shard_model(model: nn.Module, mesh: Mesh) -> Sharding:
    """Puts this rank's shard of each parameter in place (same names, local
    shapes), tells the attention and MLP modules their model axis and local
    heads and each module the dims its parameters gather over fsdp, and
    returns the Sharding. The model must be whole and equal on every rank
    (built from the same seed) and must not be wrapped."""
    if sharding_of(model) is not None:
        raise ValueError("the model is already sharded")
    splits = _model_axis_modules(model, mesh.shape[2])
    layouts = {}
    modules = dict(model.named_modules())
    for mod_name, split in splits.items():
        if split:
            modules[mod_name].set_model_axis(mesh.model)
    for name, p in list(model.named_parameters()):
        owner_name, _, pname = name.rpartition(".")
        owner = modules[owner_name]
        holder = owner_name
        while holder and holder not in splits:
            holder = holder.rpartition(".")[0]
        model_ok = splits.get(holder, False) if holder else False
        lay = layout_for(name, p.shape, mesh.shape, model_ok)
        layouts[name] = lay
        if lay.replicated:
            continue
        local = shard_tensor(p.detach(), lay, mesh).clone()
        setattr(owner, pname, nn.Parameter(local,
                                           requires_grad=p.requires_grad))
        if lay.fsdp is not None:
            owner.__dict__.setdefault("_fsdp_dims", {})[pname] = lay.fsdp
            owner.__dict__["_fsdp_axis"] = mesh.fsdp
    out = Sharding(mesh, layouts)
    model.__dict__["_sharding"] = out
    return out
