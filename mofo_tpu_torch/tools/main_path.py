"""The port's main path, built in one place for chip_smoke.py,
tools/profile_step.py and tests/test_torch_gpu.py.

- `build_step`: the ViT-B MOFO pretrain step of bench.py:119-157 (bf16,
  tube_bb masks, motion-weighted loss, AdamW with cosine schedules) on
  synthetic clips and boxes from a seed; with model=VITS_MODEL the same
  step at ViT-S width (its decoder runs K4).
- `build_finetune_step`: the ViT-B BB-focused MCA finetune step at the
  FinetuneConfig defaults (bf16, mixup 0.8 / cutmix 1.0, smoothing 0.1,
  drop path 0.1, AdamW with layer decay 0.75), its backbone started from
  the pretrain model through finetune_init_from_pretrain, on
  `synthetic_finetune_batch`; with `augment` on the finetune runner's
  uint8 clips (`synthetic_clips_u8`) augmented inside the step as the CLI
  does, with dtype="float16" under the dynamic loss scale.
- `attention_against_plain`: the fused-qkv attention kernels (K1/K2:
  forward, dK/dV, dQ) and their plain PyTorch versions on the same qkv;
  `mh_inputs` / `mh_attention_against_plain`: the same for the masked
  multihead kernels (K3) on q, k, v and a kv bias row;
  `hm_inputs` / `hm_attention_against_plain`: the same for the head-major
  kernels (K4) on (B*H, N, D) q, k, v, D in 16, 32, 64;
  `compare_with_plain` / `check_against_plain`: the bounds that hold one
  against the other, `check_prep` / `check_mh_prep` / `check_hm_prep`: the
  bf16 backwards' prep passes against their plain versions, and
  `planted_faults` /
  `hm_planted_faults`: wrong outputs those bounds must reject
  (`masked_kv_grad` checks that masked kv rows get zero dK/dV).
- `forced_draws` / `moved_draws` / `augment_against_cpu`: finetune_augment
  draws that force all 15 RandAugment ops (the geometric ones in both
  interpolations), and the bound that holds an augmentation on the card
  against the same one on the CPU.
- `MemoryReader` / `memory_box_json` / `frame_ids`: videos served from
  memory through the datasets' `reader` field, their motion boxes, and the
  frame ids read back from a clip, for the real-data runs on the card,
  where no video decoder is installed.
- `plain_attention`: inside it every attention wrapper takes its plain
  PyTorch version whatever the device; `build_step(..., plain=True)` and
  `build_finetune_step(..., plain=True)` run their steps so. It exists for
  the checks that hold a bf16 step on the card through the kernels against
  the same step through the plain versions; no CLI reaches it.
- Data parallelism: `rank_batch` / `global_batch` carry a global batch G'
  to a rank's local rows and back (parallel.ddp.global_rows);
  `pretrain_steps` / `finetune_steps` run a few steps of a model, wrapped
  by parallel.ddp.wrap_model or not, on a rank's batch or on G', drawing
  from a generator seeded per step, and return the metrics, the final
  parameters and (finetune) one validation pass with its multi-view merge:
  the rank processes and the single process at G' of chip_smoke.py's
  `ddp_two_ranks` and of tests/test_torch_ddp.py run these same functions.
  `build_step(..., wrap=True)` puts the main-path step under DDP.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import zlib

import numpy as np
import torch

from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.cli.finetune import make_train_augment
from mofo_tpu_torch.core.device import device_of
from mofo_tpu_torch.eval.multiview import (
    MultiViewAggregator,
    gather_across_processes,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import rand_augment as RA
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.checkpoint import finetune_init_from_pretrain
from mofo_tpu_torch.train.finetune_step import (
    make_eval_step,
    make_finetune_step,
)
from mofo_tpu_torch.train.loss_scale import DynamicLossScale
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

MODEL = "pretrain_videomae_base_patch16_224"
VITS_MODEL = "pretrain_videomae_small_patch16_224"
FINETUNE_MODEL = "vit_base_patch16_224_BB_focused"
OUTPUTS = ("out", "lse", "dq", "dk", "dv")

# f32: absolute bounds on out and lse, and on dq, dk, dv.
F32_ATOL = {"out": 1e-4, "lse": 1e-4, "dq": 5e-4, "dk": 5e-4, "dv": 5e-4}
# bf16: each of out, dq, dk, dv within BF16_REL of its own max|plain| (two
# bf16 ulps at the largest entry; the plain versions repeat the kernels'
# roundings), the lse (f32) within BF16_LSE_ATOL, and the bounds of
# tests/test_tpu_kernels.py:251-254 besides: rtol 5e-3 on sum(out^2),
# atol/rtol 3e-2 on dqkv.
BF16_REL = 2.0 ** -6
BF16_LSE_ATOL = 1e-4
# the K2 and K4 prep passes: q * scale (and k * scale) bit-equal to the plain
# version; delta, an f32 sum of D products taken in another order, within
# PREP_DELTA_RTOL of its row's sum of |dO * O|
PREP_DELTA_RTOL = 1e-5
# an augmentation on the card against the CPU: the share of output values
# within AUG_ATOL. A geometric op (cos / sin of two libms) or a rounding in
# equalize or posterize may move a pixel across a sampling or rounding
# boundary, so a few pixels may differ by more
AUG_ATOL = 1e-3
AUG_SHARE = 0.999
# the constant AdamW LR of pretrain_steps / finetune_steps
STEPS_LR = 1e-4


def synthetic_batch(B: int, generator: torch.Generator,
                    device: str) -> dict:
    """Normalized clips (B, 16, 224, 224, 3) and per-frame pixel boxes
    (B, 16, 4), drawn as bench.py:130-137 draws them."""
    clip = torch.randn((B, 16, 224, 224, 3), generator=generator,
                       device=device)
    xy1 = torch.rand((B, 16, 2), generator=generator, device=device) * 96.0
    wh = 48.0 + torch.rand((B, 16, 2), generator=generator,
                           device=device) * 80.0
    return {"clip": clip, "boxes": torch.cat([xy1, xy1 + wh], dim=-1)}


# wrapper -> the plain version that takes the same arguments
_PLAIN = {
    "qkv_attn_fwd": fa.attention_qkv_fwd_plain,
    "qkv_attn_bwd": fa.attention_qkv_bwd_plain,
    "mh_attn_fwd": fa.attention_mh_fwd_plain,
    "mh_attn_bwd": fa.attention_mh_bwd_plain,
    "hm_attn_fwd": fa.attention_hm_fwd_plain,
    "hm_attn_bwd": fa.attention_hm_bwd_plain,
}


@contextlib.contextmanager
def plain_attention():
    """Inside, the attention wrappers the autograd functions call (forward
    and backward of K1/K2, K3 and K4) are their plain PyTorch versions on
    any device, and no kernel is launched."""
    kept = {name: getattr(fa, name) for name in _PLAIN}
    try:
        for name, plain in _PLAIN.items():
            setattr(fa, name, plain)
        yield
    finally:
        for name, wrapper in kept.items():
            setattr(fa, name, wrapper)


def _through_plain(step):
    @functools.wraps(step)
    def run(*args, **kwargs):
        with plain_attention():
            return step(*args, **kwargs)
    return run


def build_step(B: int, name: str = MODEL, plain: bool = False,
               wrap: bool = False, dtype: str = "bfloat16", **overrides):
    """The MOFO pretrain step of model `name` (ViT-B by default) on CUDA at
    batch B in compute dtype `dtype`; `overrides` go to create_model (the
    checks cut the depth). With `plain` the step's attention runs the plain
    versions on the card (plain_attention); with `wrap` the step trains the
    model through parallel.ddp.wrap_model (a process group must be up).
    Returns (model, state, step_fn, generator, batch)."""
    cfg = PretrainConfig(model=name, batch_size=B, masking=MaskingConfig(
        mask_type="tube_bb"), motion_loss_weight=True, dtype=dtype)
    model = create_model(name, dtype=getattr(torch, dtype), seed=1,
                         **overrides)
    lr = schedules.cosine_schedule(1.5e-4, 1e-5, 800, 100, 40)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(ddp.wrap_model(model) if wrap else model, tx,
                              cfg, lr)
    if plain:
        step = _through_plain(step)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return model, state, step, gen, synthetic_batch(B, gen, "cuda")


def synthetic_finetune_batch(B: int, generator: torch.Generator,
                             device: str, num_classes: int = 174) -> dict:
    """synthetic_batch's clips and boxes plus labels in [0, num_classes)."""
    batch = synthetic_batch(B, generator, device)
    batch["label"] = torch.randint(0, num_classes, (B,),
                                   generator=generator, device=device)
    return batch


def finetune_model(cfg: FinetuneConfig, device="cuda", seed: int = 2,
                   **overrides):
    """The BB-focused classifier of `cfg` (its fusing mode, classes,
    dropout, drop path and head init scale), compute dtype cfg.dtype."""
    kw = dict(img_size=cfg.input_size, all_frames=cfg.num_frames,
              num_classes=cfg.nb_classes, drop_rate=cfg.drop,
              attn_drop_rate=cfg.attn_drop_rate,
              drop_path_rate=cfg.drop_path,
              init_scale=cfg.init_scale, fusing_method=cfg.fusing_mode,
              use_mean_pooling=cfg.use_mean_pooling)
    kw.update(overrides)
    return create_model(FINETUNE_MODEL, device=device,
                        dtype=getattr(torch, cfg.dtype), seed=seed, **kw)


def synthetic_clips_u8(B: int, generator: torch.Generator, device: str,
                       num_classes: int = 174, hw=(256, 320)) -> dict:
    """What the finetune runner's loader hands its step: uint8 clips (B, 16,
    H, W, 3) decoded at `hw`, per-frame pixel boxes (B, 16, 4) and labels."""
    H, W = hw
    clip = torch.randint(0, 256, (B, 16, H, W, 3), dtype=torch.uint8,
                         generator=generator, device=device)
    size = torch.tensor([W, H], dtype=torch.float32, device=device)
    xy1 = torch.rand((B, 16, 2), generator=generator, device=device) * (
        size / 2)
    wh = (0.2 + 0.3 * torch.rand((B, 16, 2), generator=generator,
                                 device=device)) * size
    label = torch.randint(0, num_classes, (B,), generator=generator,
                          device=device)
    return {"clip": clip, "boxes": torch.cat([xy1, xy1 + wh], dim=-1),
            "label": label}


class MemoryReader:
    """An in-memory stand-in for data.video_reader.VideoReader, which the
    datasets take through their `reader` field where no video can be
    decoded: the video of a path has 40-60 frames, and its frame i is a
    bright square moving over a gradient, both textured, at the asked size
    (256 x 320 by default). Length, gradient and square follow the path's
    basename alone, so that the boxes of
    `memory_box_json` (keyed by basename, as MotionBoxIndex keys them) hold
    in every split. Pixel (0, 0) carries (i % 256, i // 256, key), so the
    frame ids can be read back from a clip (`frame_ids`)."""

    def __init__(self, path: str, width: int = 0, height: int = 0):
        self.key = zlib.crc32(os.path.basename(path).encode()) % 251
        self.n = 40 + self.key % 21
        self.h, self.w = height or 256, width or 320

    def __len__(self) -> int:
        return self.n

    def box(self, i: int) -> list:
        """[x1, y1, x2, y2] of frame i's square, in pixels."""
        side = max(min(self.h, self.w) // 4, 1)
        x1 = (self.key + 9 * i) % max(self.w - side, 1)
        y1 = (self.key + 5 * i) % max(self.h - side, 1)
        return [x1, y1, x1 + side, y1 + side]

    def get_batch(self, indices) -> np.ndarray:
        ids = np.asarray(indices, dtype=np.int64)
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n):
            raise RuntimeError(f"frame ids outside [0, {self.n})")
        y = np.arange(self.h)[:, None, None]
        x = np.arange(self.w)[None, :, None]
        # a fixed texture on the gradient and on the square, so that no patch
        # of a resized crop is near-flat: the pretrain loss normalizes each
        # patch by its spread, which bf16 loses on a near-flat patch
        # (ROADMAP Queue 3)
        texture = np.random.RandomState(self.key).randint(
            0, 64, (self.h, self.w, 3))
        out = np.empty((len(ids), self.h, self.w, 3), np.uint8)
        out[...] = ((x * 200 // self.w + y * 55 // self.h + self.key
                     + texture) % 256).astype(np.uint8)
        for j, i in enumerate(ids):
            x1, y1, x2, y2 = self.box(int(i))
            out[j, y1:y2, x1:x2] = 255 - texture[y1:y2, x1:x2]
            out[j, 0, 0] = (i % 256, i // 256, self.key)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


def frame_ids(clips: np.ndarray) -> np.ndarray:
    """The frame ids that MemoryReader wrote into (..., T, H, W, 3) clips."""
    first = clips[..., 0, 0, :2].astype(np.int64)
    return first[..., 0] + 256 * first[..., 1]


def memory_box_json(paths, hw=(256, 320)) -> dict:
    """An Unsupervised_BB_*.json body for MemoryReader's videos: per frame
    one box around the moving square, in the pixel space of `hw`."""
    out = {}
    for path in paths:
        video = MemoryReader(path, width=hw[1], height=hw[0])
        out[os.path.splitext(os.path.basename(path))[0]] = [
            {"labels": [{"box2d": dict(zip(("x1", "y1", "x2", "y2"),
                                           map(float, video.box(i)))),
                         "gt_annotation": "motion"}]}
            for i in range(len(video))]
    return out


def build_finetune_step(B: int, plain: bool = False, depth: int = 12,
                        augment: bool = False, dtype: str = "bfloat16",
                        **cfg_fields):
    """The ViT-B BB-focused MCA finetune step on CUDA at batch B, its
    backbone `depth` Blocks deep (the checks cut it). With `plain` the
    step's attention runs the plain versions on the card (plain_attention);
    with `augment` the batch is synthetic_clips_u8's and the step augments
    it as the finetune CLI does (RandAugment, crop, flip, erasing); in
    dtype "float16" the state carries the dynamic loss scale; `cfg_fields`
    set more FinetuneConfig fields (drop, attn_drop_rate). Returns (model,
    state, step_fn, generator, batch, cfg)."""
    cfg = FinetuneConfig(batch_size=B, model=FINETUNE_MODEL, dtype=dtype,
                         **cfg_fields)
    model = finetune_model(cfg, depth=depth)
    pretrain = create_model(MODEL, dtype=torch.bfloat16, seed=1,
                            encoder_depth=depth)
    finetune_init_from_pretrain(model, pretrain.state_dict())
    del pretrain
    oc = cfg.optimizer
    lr = schedules.cosine_schedule(
        schedules.scaled_lr(oc.lr, B), oc.min_lr, cfg.epochs, 100,
        oc.warmup_epochs, start_warmup_value=oc.warmup_lr)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=lr, betas=oc.opt_betas,
                                weight_decay=oc.weight_decay,
                                eps=oc.opt_eps, layer_decay=oc.layer_decay)
    state = TrainState.create(
        model, tx, loss_scale=(DynamicLossScale.create()
                               if dtype == "float16" else None))
    step = make_finetune_step(
        model, tx, cfg, lr, bb_focused=True,
        augment_fn=make_train_augment(cfg, flip=True) if augment else None)
    if plain:
        step = _through_plain(step)
    gen = torch.Generator(device="cuda").manual_seed(0)
    make_batch = synthetic_clips_u8 if augment else synthetic_finetune_batch
    batch = make_batch(B, gen, "cuda", cfg.nb_classes)
    return model, state, step, gen, batch, cfg


def rank_batch(batch: dict, rank: int, world: int, k: int = 1) -> dict:
    """Rank `rank`'s local rows of a global batch G' of `world` ranks whose
    local batches split into k microbatches (parallel.ddp.global_rows)."""
    n = next(iter(batch.values())).shape[0] // world
    rows = torch.from_numpy(ddp.global_rows(rank, world, n, k))
    return {name: v.index_select(0, rows.to(v.device))
            for name, v in batch.items()}


def global_batch(parts: list, k: int = 1) -> dict:
    """G' from the ranks' local batches, in rank order: its microbatch i is
    the ranks' microbatches i side by side (the inverse of rank_batch)."""
    m = next(iter(parts[0].values())).shape[0] // k
    return {name: torch.cat([p[name][i * m:(i + 1) * m]
                             for i in range(k) for p in parts])
            for name in parts[0]}


def _timed(dev):
    """A clock that waits for the device first (CUDA)."""
    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()
    return now


def _final(model) -> dict:
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def pretrain_steps(model, cfg: PretrainConfig, batch: dict, steps: int, *,
                   wrap: bool = False, masks=None,
                   augment: bool = False) -> dict:
    """`steps` pretrain steps of `model` (through parallel.ddp.wrap_model
    with `wrap`) on `batch`, AdamW at STEPS_LR, loss weight 0.5;
    step s draws from a generator on the model's device seeded s. `masks[s]` replaces
    step s's mask draw; with `augment` the batch holds uint8 clips that
    pretrain_augment crops inside the step. Returns the losses, gradient
    norms, host times (ms) of each step and the final parameters (f32, on
    the CPU)."""
    dev = device_of(model)
    lrs = np.full(steps, STEPS_LR, np.float32)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=lrs, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)

    def augment_fn(generator, b):
        clips, boxes = A.pretrain_augment(generator, b["clip"],
                                          out_size=cfg.input_size,
                                          boxes=b["boxes"])
        return {"clip": clips, "boxes": boxes}

    step = make_pretrain_step(ddp.wrap_model(model) if wrap else model, tx,
                              cfg, lrs, device=dev,
                              augment_fn=augment_fn if augment else None)
    gen, now = torch.Generator(device=dev), _timed(dev)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for s in range(steps):
        gen.manual_seed(s)
        t0 = now()
        state, m = step(state, batch, gen, 0.5,
                        mask=None if masks is None else masks[s])
        out["ms"].append((now() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _final(model)
    return out


def finetune_steps(model, cfg: FinetuneConfig, batch: dict, steps: int, *,
                   wrap: bool = False, augment: bool = False,
                   eval_batch: dict = None) -> dict:
    """`steps` finetune steps of `model` (a BB-focused one when cfg.model
    is; through parallel.ddp.wrap_model with `wrap`) on `batch`, AdamW at
    STEPS_LR with cfg's layer decay; step s draws from a generator
    seeded s and mixup from cfg.seed and the step. With `augment`
    the batch holds uint8 clips that the finetune CLI's train augmentation
    takes inside the step. Then, given `eval_batch` (normalized clips,
    boxes, labels, `valid` and the views' video_idx, chunk_nb, split_nb),
    one eval call (the ranks' sums with `wrap`) and the multi-view merge of
    its valid rows across the processes. Returns the losses, gradient
    norms, host times (ms), the final parameters (f32, on the CPU) and the
    eval's metrics, logits and Acc@1 / Acc@5."""
    dev = device_of(model)
    bb = "BB_focused" in cfg.model
    lrs = np.full(steps, STEPS_LR, np.float32)
    oc = cfg.optimizer
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=lrs, betas=oc.opt_betas,
                                weight_decay=oc.weight_decay, eps=oc.opt_eps,
                                layer_decay=oc.layer_decay)
    state = TrainState.create(model, tx)
    net = ddp.wrap_model(model) if wrap else model
    step = make_finetune_step(
        net, tx, cfg, lrs, bb_focused=bb, device=dev,
        augment_fn=make_train_augment(cfg, flip=True) if augment else None)
    gen, now = torch.Generator(device=dev), _timed(dev)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for s in range(steps):
        gen.manual_seed(s)
        t0 = now()
        state, m = step(state, batch, gen)
        out["ms"].append((now() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _final(model)
    if eval_batch is not None:
        ev = make_eval_step(net, cfg, bb_focused=bb, device=dev)(
            {n: eval_batch[n] for n in ("clip", "boxes", "label", "valid")
             if n in eval_batch})
        out["eval"] = {n: float(ev[n]) for n in ("loss", "acc1", "acc5",
                                                  "n_valid")}
        out["logits"] = ev["logits"].cpu()
        keep = eval_batch["valid"].cpu().numpy()
        host = {n: eval_batch[n].cpu().numpy()[keep] for n in (
            "video_idx", "chunk_nb", "split_nb", "label")}
        agg = MultiViewAggregator()
        agg.add(host["video_idx"], host["chunk_nb"], host["split_nb"],
                out["logits"].numpy()[keep], host["label"])
        top1, top5, _ = gather_across_processes(agg).finalize()
        out["multiview"] = {"acc1": top1, "acc5": top5}
    return out


def _parts(out, lse, dqkv) -> dict:
    A = out.shape[-1]
    return {"out": out, "lse": lse, "dq": dqkv[..., :A],
            "dk": dqkv[..., A:2 * A], "dv": dqkv[..., 2 * A:]}


def attention_against_plain(qkv: torch.Tensor, heads: int, scale: float):
    """(got, want): out, lse, dq, dk, dv of the kernels (their plain
    versions, on a CPU tensor) and of the plain versions, on the same
    inputs. The backward takes the kernels' out and lse and dout = 2 out,
    the gradient of sum(out^2)."""
    out, lse = fa.qkv_attn_fwd(qkv, scale, heads)
    p_out, p_lse = fa.attention_qkv_fwd_plain(qkv, scale, heads)
    dout = (2 * out.float()).to(qkv.dtype)
    dqkv = fa.qkv_attn_bwd(qkv, out, lse, dout, scale, heads)
    p_dqkv = fa.attention_qkv_bwd_plain(qkv, out, lse, dout, scale, heads)
    return _parts(out, lse, dqkv), _parts(p_out, p_lse, p_dqkv)


def mh_inputs(B: int, N: int, H: int, D: int, dtype: torch.dtype,
              seed: int, device, bias: bool = True):
    """q (B, N, A), k and v (column views of one (B, N, 2A) kv, as
    CrossAttention hands them over) and a kv bias row (B, N) f32 of 0 /
    -1e30 from a random mask (about 60% valid) in which sample 0 keeps a
    single valid column; None without `bias`."""
    g = torch.Generator().manual_seed(seed)
    A = H * D
    q = torch.randn(B, N, A, generator=g).to(dtype).to(device)
    kv = torch.randn(B, N, 2 * A, generator=g).to(dtype).to(device)
    kv_bias = None
    if bias:
        valid = torch.rand(B, N, generator=g) < 0.6
        valid[0] = False
        valid[0, N // 2] = True
        kv_bias = torch.where(valid, 0.0, -1e30).to(device)
    return q, kv[..., :A], kv[..., A:], kv_bias


def mh_attention_against_plain(q, k, v, kv_bias, heads: int, scale: float):
    """(got, want) of the K3 kernels (their plain versions on CPU tensors)
    and the plain versions on the same inputs; the backward takes the
    kernels' out and lse and dout = 2 out."""
    out, lse = fa.mh_attn_fwd(q, k, v, kv_bias, scale, heads)
    p_out, p_lse = fa.attention_mh_fwd_plain(q, k, v, kv_bias, scale, heads)
    dout = (2 * out.float()).to(q.dtype)
    dq, dk, dv = fa.mh_attn_bwd(q, k, v, kv_bias, out, lse, dout, scale,
                                heads)
    p_dq, p_dk, p_dv = fa.attention_mh_bwd_plain(q, k, v, kv_bias, out, lse,
                                                 dout, scale, heads)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    want = {"out": p_out, "lse": p_lse, "dq": p_dq, "dk": p_dk, "dv": p_dv}
    return got, want


def hm_inputs(BH: int, N: int, dtype: torch.dtype, seed: int, device,
              D: int = 64):
    """q, k, v (B*H, N, D) contiguous, standard normal, for K4."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(BH, N, D, generator=g).to(dtype)
                 .to(device) for _ in range(3))


def hm_attention_against_plain(q, k, v, scale: float):
    """(got, want) of the K4 kernels (their plain versions on CPU tensors)
    and the plain versions on the same inputs; the backward takes the
    kernels' out and lse and dout = 2 out."""
    out, lse = fa.hm_attn_fwd(q, k, v, scale)
    p_out, p_lse = fa.attention_hm_fwd_plain(q, k, v, scale)
    dout = (2 * out.float()).to(q.dtype)
    dq, dk, dv = fa.hm_attn_bwd(q, k, v, out, lse, dout, scale)
    p_dq, p_dk, p_dv = fa.attention_hm_bwd_plain(q, k, v, out, lse, dout,
                                                 scale)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    want = {"out": p_out, "lse": p_lse, "dq": p_dq, "dk": p_dk, "dv": p_dv}
    return got, want


def masked_kv_grad(got: dict, kv_bias) -> float:
    """Largest |dK|, |dV| on kv rows the bias masks (must be exactly 0)."""
    if kv_bias is None:
        return 0.0
    masked = kv_bias != 0
    return max(_max_abs(got[k][masked]) if masked.any() else 0.0
               for k in ("dk", "dv"))


def _max_abs(t: torch.Tensor) -> float:
    return t.float().abs().max().item()


def compare_with_plain(got: dict, want: dict) -> dict:
    """Holds each output of `got` against `want` (dicts of OUTPUTS) to the
    bounds above. Returns the max abs errors, each output's max|plain|, in
    bf16 sum(out^2)'s relative difference, and under "beyond_bounds" the
    checks that failed."""
    err = {k: _max_abs(got[k].float() - want[k].float()) for k in OUTPUTS}
    res = {"max_abs_err": err,
           "max_abs_plain": {k: _max_abs(want[k]) for k in OUTPUTS}}
    if got["out"].dtype == torch.float32:
        bad = [k for k in OUTPUTS if not err[k] <= F32_ATOL[k]]
    else:
        bad = [k for k in OUTPUTS if k != "lse"
               and not err[k] <= BF16_REL * res["max_abs_plain"][k]]
        if not err["lse"] <= BF16_LSE_ATOL:
            bad.append("lse")
        val = (got["out"].float() ** 2).sum().item()
        p_val = (want["out"].float() ** 2).sum().item()
        res["value_rel"] = abs(val - p_val) / abs(p_val)
        if not res["value_rel"] <= 5e-3:
            bad.append("value_rel")
        bad += [f"{k} allclose 3e-2" for k in ("dq", "dk", "dv")
                if not torch.allclose(got[k].float(), want[k].float(),
                                      atol=3e-2, rtol=3e-2)]
    res["beyond_bounds"] = bad
    return res


def check_against_plain(got: dict, want: dict) -> dict:
    """compare_with_plain, raising AssertionError beyond the bounds."""
    res = compare_with_plain(got, want)
    if res["beyond_bounds"]:
        raise AssertionError(f"kernel vs plain beyond the bounds: {res}")
    return res


def planted_faults(got: dict, bias_ignored: dict = None) -> dict:
    """Wrong kernels' outputs that compare_with_plain must reject: dQ
    zeroed, dK without its 1/log2(e) fix (bf16; in f32, dK times log2(e))
    and, for K3, `bias_ignored`: the kernels' outputs on the same q, k, v
    run without the bias."""
    dk = (got["dk"].float() * fa.LOG2E).to(got["dk"].dtype)
    faults = {"dq_zero": dict(got, dq=torch.zeros_like(got["dq"])),
              "dk_without_fix": dict(got, dk=dk)}
    if bias_ignored is not None:
        faults["bias_ignored"] = bias_ignored
    return faults


def hm_planted_faults(got: dict) -> dict:
    """Wrong K4 outputs that compare_with_plain must reject: dQ zeroed, and
    the LSE in log2 units (K4 works in base e in every dtype)."""
    return {"dq_zero": dict(got, dq=torch.zeros_like(got["dq"])),
            "lse_log2": dict(got, lse=got["lse"] * fa.LOG2E)}


def _prep_against_plain(got, want, absum) -> dict:
    """Holds a prep pass's (delta, qs, ks) against its plain version's;
    `absum` is each row's sum of |dO * O|, shaped like delta."""
    (delta, qs, ks), (p_delta, p_qs, p_ks) = got, want
    err = (delta - p_delta).abs()
    res = {"max_abs_err": err.max().item(),
           "bound_share": (err / (PREP_DELTA_RTOL * absum + 1e-30)).max()
           .item(),
           "qs_equal": torch.equal(qs, p_qs),
           "ks": None if ks is None else torch.equal(ks, p_ks)}
    if (ks is None) != (p_ks is None) or not res["qs_equal"] or \
            res["ks"] is False or not res["bound_share"] <= 1.0:
        raise AssertionError(f"prep pass vs plain beyond the bounds: {res}")
    return res


def check_prep(qkv, out, dout, heads: int, scale: float) -> dict:
    """qkv_attn_bwd_prep (the kernel on a CUDA tensor) against its plain
    version on the same inputs; raises AssertionError beyond the bounds
    above. Returns delta's max abs error and the bound's worst share."""
    B, N, A = out.shape
    absum = (dout.float().abs() * out.float().abs()).reshape(
        B, N, heads, A // heads).sum(-1).transpose(1, 2)
    return _prep_against_plain(
        fa.qkv_attn_bwd_prep(qkv, out, dout, scale, heads),
        fa.attention_qkv_bwd_prep_plain(qkv, out, dout, scale, heads), absum)


def check_mh_prep(q, k, out, dout, heads: int, scale: float) -> dict:
    """check_prep for mh_attn_bwd_prep on (B, N, A) q and k with their own
    row strides."""
    B, N, A = out.shape
    absum = (dout.float().abs() * out.float().abs()).reshape(
        B, N, heads, A // heads).sum(-1).transpose(1, 2)
    return _prep_against_plain(
        fa.mh_attn_bwd_prep(q, k, out, dout, scale, heads),
        fa.attention_mh_bwd_prep_plain(q, k, out, dout, scale, heads), absum)


def check_hm_prep(q, k, out, dout, scale: float) -> dict:
    """check_prep for hm_attn_bwd_prep on (B*H, N, D) tensors."""
    return _prep_against_plain(
        fa.hm_attn_bwd_prep(q, k, out, dout, scale),
        fa.attention_hm_bwd_prep_plain(q, k, out, dout, scale),
        (dout.float().abs() * out.float().abs()).sum(-1))


def forced_draws(B: int, hw, out_size: int = 224,
                 seed: int = 21) -> A.FinetuneDraws:
    """finetune_augment's draws (default config, 4 layers) for B >= 8
    clips of 16 frames at `hw` cropped to out_size, on the CPU, with every
    RandAugment layer applied and the ops dealt round the B * 4 slots in
    turn: every op appears, each geometric op once per interpolation."""
    draws = A.sample_finetune_draws(torch.Generator().manual_seed(seed),
                                    (B, 16, *hw, 3), out_size)
    ra = draws.rand_augment
    n_ops = len(RA.TRANSFORMS)
    slots = torch.arange(ra.op.numel()).reshape(ra.op.shape)
    ra = ra._replace(op=slots % n_ops, interp=(slots // n_ops) % 2,
                     apply=torch.ones_like(ra.apply))
    seen = {(int(o), int(i) if int(o) in RA.GEOMETRIC else 0)
            for o, i in zip(ra.op.flatten(), ra.interp.flatten())}
    want = {(o, i) for o in range(n_ops)
            for i in ((0, 1) if o in RA.GEOMETRIC else (0,))}
    if seen != want:
        raise ValueError(f"{B} clips are too few to draw every op: "
                         f"{sorted(want - seen)} missing")
    return draws._replace(rand_augment=ra)


def moved_draws(draws, device):
    """A NamedTuple of draws (nested, None allowed) on `device`."""
    if draws is None or isinstance(draws, torch.Tensor):
        return None if draws is None else draws.to(device)
    return type(draws)(*(moved_draws(d, device) for d in draws))


def augment_against_cpu(card, cpu) -> dict:
    """An augmentation's (clips, boxes) on the card against the CPU's: max
    |card - CPU| of each, and the share of clip values within AUG_ATOL
    (the bound: at least AUG_SHARE)."""
    diff = (card[0].cpu() - cpu[0]).abs()
    res = {"max_abs_err": diff.max().item(),
           "share_within": (diff <= AUG_ATOL).float().mean().item()}
    if card[1] is not None:
        res["boxes_max_abs_err"] = (card[1].cpu() - cpu[1]).abs().max().item()
    return res
