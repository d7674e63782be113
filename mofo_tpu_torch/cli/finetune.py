"""Classification finetuning runner (plain and MOFO BB-focused), on one
device or data-parallel over W processes.

Counterpart of mofo_tpu/cli/finetune.py: the flags and defaults of
run_class_finetuning.py:31-214 / run_class_finetuning_BB.py, plus --device
(default cuda). mofo_tpu_torch.cli.finetune_mofo presets the BB-focused
model. Each step takes a batch of uint8 clips from the prefetching loader,
augments it on the device (RandAugment, random resized crop, flip,
RandomErasing; boxes through the rotate and the crop), mixes it (mixup /
cutmix) and trains with the optimizer --opt names (every name of
mofo_tpu's zoo; AdamW by default) and layer-wise LR decay (in fp16 under
the dynamic loss scale); a second-order --opt (adahessian) builds the model
with the plain attention route (attn_impl="xla") and trains with the
Hutchinson probe. Every epoch validates (resize, centre crop; and the
EMA weights with --model_ema), appends a line to <output_dir>/log.txt,
writes checkpoint-<epoch>.pth every save_ckpt_freq epochs and
checkpoint-best.pth on a new best acc1, and stops early after
--early_stop_patience epochs without a lower validation loss; a rerun
resumes after the latest checkpoint. Last, checkpoint-best's weights run
the multi-view test on the test set's views, softmax-averaged per video
("Final test: Acc@1 ... Acc@5 ..."; with EK100 and --classtype action also
the verb and noun accuracies of the marginalized action scores).

Data (mofo_tpu/cli/finetune.py:236-322): --data_path / --val_path /
--test_path setting files ("path [duration] label"; validation falls back
to the train list, test to validation), decoded through data.video_reader
(native/decoder's FFmpeg library, else cv2), the dense sampler for
Kinetics-400, UCF101 and HMDB51 and the uniform one otherwise, with
--bb_json's motion boxes (a BB-focused model needs them); --data_set EK100
reads the EPIC_100 CSVs (--data_path, --val_path) and the pre-cut videos
under --data_root, labelled by --classtype; or --synthetic N random clips,
tested one view each as mofo_tpu does.

Usage (the warm-up epochs must fit in --epochs: the default is 5):
  python -m mofo_tpu_torch.cli.finetune_mofo --data_set SSV2 \\
      --data_path train.csv --val_path val.csv --test_path test.csv \\
      --bb_json Unsupervised_BB_SSV2_train.json --epochs 2 \\
      --warmup_epochs 1 --finetune pretrain/checkpoint-799.pth \\
      --output_dir ft/

On W GPUs, one process each: torchrun --nproc_per_node W -m
mofo_tpu_torch.cli.finetune_mofo ... (as cli/pretrain.py). The ranks train
on their shards of the train set as one process on the global batch
(parallel/ddp.py); validation, the EMA validation and the final multi-view
test run on every rank over its shard and merge (the sums of the eval step,
the views through gather_across_processes); every rank acts on rank 0's
validation numbers (best checkpoint, early stop). Rank 0 prints, writes
log.txt and the checkpoints.

--mesh_fsdp and --mesh_model shard the run over a (data, fsdp, model)
mesh as in cli/pretrain.py: each batch coordinate loads batch_size *
model rows of the train, validation and test sets and its model peers the
same; the validation sums, the meters and the multi-view merge run over
the batch coordinates (parallel/mesh.py's batch axis), and the multi-view
test reads the fsdp-sharded weights from one gather (the coordinates may
make different numbers of calls there).

With WANDB_PROJECT (and WANDB_GROUP, WANDB_NAME) set, rank 0 also logs
every epoch's line to wandb when the package is installed
(train/wandb_compat.py).

A mesh mofo_tpu refuses at the world size raises ValueError; every --opt
name runs on a mesh with an fsdp or model axis, as in cli/pretrain.py.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from mofo_tpu_torch.cli.pretrain import (
    build_run_mesh,
    resolve_mesh,
    step_seed,
)
from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MeshSpec,
    OptimizerConfig,
)
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.data.epic import EpicClipDataset
from mofo_tpu_torch.data.filelist import (
    MotionBoxIndex,
    epic_action_space,
    read_epic_csv,
    read_setting_file,
)
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.eval.multiview import (
    MultiViewAggregator,
    gather_across_processes,
    get_marginal_indexes,
    marginalize,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.parallel import mesh as mesh_lib
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import metrics as M
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.finetune_step import (
    make_eval_step,
    make_finetune_step,
)
from mofo_tpu_torch.train.loss_scale import DynamicLossScale
from mofo_tpu_torch.train.train_state import TrainState
from mofo_tpu_torch.train.wandb_compat import WandbLogger

# what --only_finetune_last trains (mofo_tpu/cli/finetune.py:382-397)
HEAD_MODULES = ("head", "fc_norm", "soft_att_local", "soft_att_global")


def get_args(argv=None, bb_defaults: bool = False):
    p = argparse.ArgumentParser("MOFO finetuning (PyTorch)", add_help=True)
    p.add_argument("--batch_size", default=10, type=int)
    p.add_argument("--num_workers", default=1, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--update_freq", default=1, type=int)
    p.add_argument("--save_ckpt_freq", default=10, type=int)
    # model
    p.add_argument("--model", type=str, default=(
        "vit_base_patch16_224_BB_focused" if bb_defaults
        else "vit_base_patch16_224"))
    p.add_argument("--fusing_mode", default="MCA", type=str,
                   choices=["MCA", "soft_attn", "weighted_mean", "org"])
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--sampling_rate", default=4, type=int)
    p.add_argument("--tubelet_size", default=2, type=int)
    p.add_argument("--drop", default=0.0, type=float)
    p.add_argument("--attn_drop_rate", default=0.0, type=float)
    p.add_argument("--drop_path", default=0.1, type=float)
    p.add_argument("--init_scale", default=0.001, type=float)
    p.add_argument("--use_mean_pooling", default=True, type=bool)
    p.add_argument("--nb_classes", default=174, type=int)
    p.add_argument("--model_ema", action="store_true", default=False)
    p.add_argument("--model_ema_decay", default=0.9999, type=float)
    # optimizer
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=[0.9, 0.999], type=float,
                   nargs="+")
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--weight_decay_end", default=None, type=float)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--layer_decay", default=0.75, type=float)
    p.add_argument("--warmup_lr", default=1e-6, type=float)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--warmup_epochs", default=5, type=int)
    p.add_argument("--warmup_steps", default=-1, type=int)
    # augmentation
    p.add_argument("--color_jitter", default=0.4, type=float)
    p.add_argument("--aa", default="rand-m7-n4-mstd0.5-inc1", type=str)
    p.add_argument("--smoothing", default=0.1, type=float)
    p.add_argument("--reprob", default=0.25, type=float)
    p.add_argument("--mixup", default=0.8, type=float)
    p.add_argument("--cutmix", default=1.0, type=float)
    p.add_argument("--mixup_prob", default=1.0, type=float)
    p.add_argument("--mixup_switch_prob", default=0.5, type=float)
    p.add_argument("--mixup_mode", default="batch", type=str)
    p.add_argument("--no_flip", action="store_true",
                   help="disable hflip (SSV2/EK convention)")
    # eval
    p.add_argument("--test_num_segment", default=2, type=int)
    p.add_argument("--test_num_crop", default=3, type=int)
    p.add_argument("--dist_eval", action="store_true", default=True)
    p.add_argument("--eval", action="store_true", help="evaluation only")
    p.add_argument("--early_stop_patience", default=-1, type=int,
                   help="stop after N epochs without val-loss improvement")
    p.add_argument("--only_finetune_last", action="store_true",
                   help="freeze the backbone, train fusing/head only")
    p.add_argument("--num_sample", default=1, type=int,
                   help="repeated augmentation copies per clip")
    # checkpoints
    p.add_argument("--finetune", default="",
                   help="pretrain checkpoint (torch .pth)")
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--start_epoch", default=0, type=int)
    # data
    p.add_argument("--data_path", default=None, type=str)
    p.add_argument("--val_path", default=None, type=str)
    p.add_argument("--test_path", default=None, type=str)
    p.add_argument("--bb_json", default=None, type=str)
    p.add_argument("--data_set", default="SSV2", type=str,
                   choices=["SSV2", "Kinetics-400", "UCF101", "HMDB51",
                            "EK100"])
    p.add_argument("--classtype", default="action", type=str,
                   choices=["verb", "noun", "action"],
                   help="EK100 label space")
    p.add_argument("--data_root", default=None, type=str,
                   help="EK100 video root (train/ validation/ subdirs)")
    p.add_argument("--synthetic", default=0, type=int)
    p.add_argument("--decode_height", default=256, type=int)
    p.add_argument("--decode_width", default=320, type=int)
    # misc
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"],
                   help="compute dtype; float16 enables dynamic loss "
                        "scaling (DeepSpeed fp16 parity)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain PyTorch versions")
    p.add_argument("--mesh_data", default=-1, type=int)
    p.add_argument("--mesh_fsdp", default=1, type=int)
    p.add_argument("--mesh_model", default=1, type=int)
    return p.parse_args(argv)


def build_config(args, world: int = 1) -> FinetuneConfig:
    """The run's FinetuneConfig at `world` processes; raises on flags the
    port does not run: a mesh mofo_tpu refuses at that many devices
    (cli/pretrain.py's resolve_mesh)."""
    resolve_mesh(args, world)
    return FinetuneConfig(
        model=args.model,
        nb_classes=args.nb_classes,
        input_size=args.input_size,
        num_frames=args.num_frames,
        tubelet_size=args.tubelet_size,
        drop=args.drop,
        attn_drop_rate=args.attn_drop_rate,
        drop_path=args.drop_path,
        init_scale=args.init_scale,
        use_mean_pooling=args.use_mean_pooling,
        batch_size=args.batch_size,
        epochs=args.epochs,
        update_freq=args.update_freq,
        save_ckpt_freq=args.save_ckpt_freq,
        seed=args.seed,
        dtype=args.dtype,
        model_ema=args.model_ema,
        model_ema_decay=args.model_ema_decay,
        aa=args.aa,
        smoothing=args.smoothing,
        reprob=args.reprob,
        mixup=args.mixup,
        cutmix=args.cutmix,
        mixup_prob=args.mixup_prob,
        mixup_switch_prob=args.mixup_switch_prob,
        mixup_mode=args.mixup_mode,
        test_num_segment=args.test_num_segment,
        test_num_crop=args.test_num_crop,
        fusing_mode=args.fusing_mode,
        optimizer=OptimizerConfig(
            opt=args.opt,
            lr=args.lr,
            min_lr=args.min_lr,
            warmup_lr=args.warmup_lr,
            warmup_epochs=args.warmup_epochs,
            warmup_steps=args.warmup_steps,
            weight_decay=args.weight_decay,
            weight_decay_end=args.weight_decay_end,
            opt_betas=tuple(args.opt_betas),
            opt_eps=args.opt_eps,
            clip_grad=args.clip_grad,
            layer_decay=args.layer_decay,
        ),
        mesh=MeshSpec(args.mesh_data, args.mesh_fsdp, args.mesh_model),
    )


def build_datasets(args, cfg: FinetuneConfig, bb_focused: bool, log,
                   reader=VideoReader):
    """(train, validation, test datasets, cfg, action_to_vn) of the run, as
    mofo_tpu/cli/finetune.py:236-322 builds them. With EK100 and
    --classtype action, cfg's nb_classes becomes the size of the action
    space and action_to_vn holds each action's (verb, noun); else it is
    None. `reader` replaces VideoReader (an in-memory reader in the checks;
    no CLI flag reaches it)."""
    sampler_kind = "dense" if args.data_set in (
        "Kinetics-400", "UCF101", "HMDB51") else "uniform"
    decode_size = (args.decode_height, args.decode_width)
    boxes = MotionBoxIndex.from_file(args.bb_json) if args.bb_json else None
    if bb_focused and boxes is None and not args.synthetic:
        raise SystemExit("BB-focused model requires --bb_json")
    action_to_vn = None
    if args.synthetic:
        # the test set too is the plain clips: one view each, through
        # window 0 (mofo_tpu/cli/finetune.py:257-260)
        train_ds, val_ds, test_ds = (P.SyntheticClipDataset(
            n=args.synthetic, num_frames=cfg.num_frames,
            decode_size=decode_size, num_classes=cfg.nb_classes,
            with_boxes=bb_focused) for _ in range(3))
    elif args.data_set == "EK100":
        vn_list, mapping, action_to_vn = epic_action_space(
            [args.data_path, args.val_path])
        if args.classtype == "action" and cfg.nb_classes != len(vn_list):
            log(f"nb_classes -> {len(vn_list)} (EK action space)")
            cfg = dataclasses.replace(cfg, nb_classes=len(vn_list))

        def epic(csv_path, split, mode):
            return EpicClipDataset(
                entries=read_epic_csv(csv_path), video_root=args.data_root,
                split=split, mode=mode, classtype=args.classtype,
                action_mapping=mapping, num_frames=cfg.num_frames,
                decode_size=decode_size,
                test_num_segment=cfg.test_num_segment,
                test_num_crop=cfg.test_num_crop, boxes=boxes, reader=reader)

        train_ds = epic(args.data_path, "train", "train")
        val_ds = epic(args.val_path, "validation", "validation")
        test_ds = epic(args.val_path, "validation", "test")
    else:
        def clips(path, mode):
            return P.FinetuneClipDataset(
                entries=read_setting_file(path), mode=mode,
                sampler=sampler_kind, num_frames=cfg.num_frames,
                frame_sample_rate=args.sampling_rate,
                decode_size=decode_size,
                test_num_segment=cfg.test_num_segment,
                test_num_crop=cfg.test_num_crop, boxes=boxes, reader=reader)

        train_ds = clips(args.data_path, "train")
        val_ds = clips(args.val_path or args.data_path, "validation")
        test_ds = clips(args.test_path or args.val_path or args.data_path,
                        "test")
    return train_ds, val_ds, test_ds, cfg, action_to_vn


def head_only(name: str, param: torch.Tensor) -> bool:
    """--only_finetune_last: the head, fc_norm and fusing modules train,
    the backbone stays as it is (the reference declared the flag without
    the freeze, run_class_finetuning_BB.py:141)."""
    return any(part in HEAD_MODULES
               or part.startswith(("local_MCA", "global_MCA"))
               for part in name.split("."))


def make_train_augment(cfg: FinetuneConfig, flip: bool,
                       num_sample: int = 1):
    """The train step's augment_fn(generator, batch) -> batch: uint8 clips
    (and boxes) through finetune_augment with cfg's RandAugment, erasing
    and input size; with num_sample > 1 each clip first repeats that often
    (repeated augmentation, multiple_samples_collate, utils.py:530-552:
    each copy draws its own augmentation, then mixup acts on the whole
    batch)."""

    def train_augment(generator, batch):
        clips, labels = batch["clip"], batch["label"]
        boxes = batch.get("boxes")
        if num_sample > 1:
            clips = clips.repeat_interleave(num_sample, dim=0)
            labels = labels.repeat_interleave(num_sample, dim=0)
            if boxes is not None:
                boxes = boxes.repeat_interleave(num_sample, dim=0)
        clips, boxes = A.finetune_augment(
            generator, clips, out_size=cfg.input_size, aa=cfg.aa, flip=flip,
            reprob=cfg.reprob, boxes=boxes)
        out = {"clip": clips, "label": labels}
        if boxes is not None:
            out["boxes"] = boxes
        return out

    return train_augment


@contextlib.contextmanager
def _weights(model: torch.nn.Module, params):
    """Inside, the model's parameters hold `params` (the EMA weights); the
    model's own are back afterwards. params=None changes nothing."""
    if params is None:
        yield
        return
    named = dict(model.named_parameters())
    kept = {n: p.detach().clone() for n, p in named.items()}
    try:
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(params[n])
        yield
    finally:
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(kept[n])


def main(args=None, reader=VideoReader):
    """Runs the finetuning and the final test; returns the final TrainState
    (checkpoint-best's when an output dir holds one), or the validation
    stats with --eval. `reader` opens the datasets' videos (see
    build_datasets)."""
    if args is None:
        args = get_args()
    joined = distributed.init_distributed_mode(device=args.device)
    try:
        return _train(args, reader)
    finally:
        if joined:
            distributed.destroy()


def _train(args, reader):
    log = distributed.setup_printing()
    rank, world = distributed.process_index(), distributed.process_count()
    cfg = build_config(args, world)
    bb_focused = "BB_focused" in cfg.model
    log(f"config: {cfg}")
    device = resolve_device(distributed.run_device(args.device))
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))

    mesh = build_run_mesh(args, world, log)
    group = None if mesh is None else mesh.batch

    # ----- data: one shard per batch coordinate (its model peers alike) ---
    train_ds, val_ds, test_ds, cfg, action_to_vn = build_datasets(
        args, cfg, bb_focused, log, reader)
    b_rank, b_world, rows = ((rank, world, cfg.batch_size) if mesh is None
                             else (group.index, group.size,
                                   cfg.batch_size * mesh.shape[2]))
    train_sampler = P.ShardedSampler(len(train_ds), b_rank, b_world,
                                     seed=cfg.seed)
    train_loader = P.PrefetchLoader(train_ds, rows, train_sampler,
                                    device=device,
                                    num_workers=args.num_workers)
    val_loader = P.PrefetchLoader(
        val_ds, rows,
        P.ShardedSampler(len(val_ds), b_rank, b_world, shuffle=False),
        device=device, drop_last=False, num_workers=args.num_workers)
    steps_per_epoch = max(len(train_loader), 1)

    # ----- model -----
    model_kwargs = dict(
        img_size=cfg.input_size, all_frames=cfg.num_frames,
        tubelet_size=cfg.tubelet_size, num_classes=cfg.nb_classes,
        drop_rate=cfg.drop, attn_drop_rate=cfg.attn_drop_rate,
        drop_path_rate=cfg.drop_path, init_scale=cfg.init_scale,
        use_mean_pooling=cfg.use_mean_pooling)
    if bb_focused:
        model_kwargs["fusing_method"] = cfg.fusing_mode
    second_order = optim.is_second_order(args.opt)
    if second_order:
        # the Hutchinson probe differentiates the backward pass; the
        # kernels' backwards are first-order only
        model_kwargs["attn_impl"] = "xla"
        log("second-order optimizer: attention routed through XLA")
    model = create_model(cfg.model, device=device,
                         dtype=getattr(torch, cfg.dtype), seed=cfg.seed,
                         **model_kwargs)
    named = dict(model.named_parameters())
    log(f"params: {sum(p.numel() for p in named.values()) / 1e6:.2f}M")
    if args.finetune:
        copied = ckpt.finetune_init_from_pretrain(
            model, ckpt.load_pretrain_encoder(args.finetune, device))
        log(f"initialized the backbone from {args.finetune} "
            f"({len(copied)} tensors)")

    # ----- optimizer -----
    oc = cfg.optimizer
    lr = schedules.scaled_lr(oc.lr, cfg.batch_size * world)
    lr_sched = schedules.cosine_schedule(
        lr, oc.min_lr, cfg.epochs, steps_per_epoch, oc.warmup_epochs,
        oc.warmup_lr, oc.warmup_steps)
    wd_sched = None
    if oc.weight_decay_end is not None:
        wd_sched = schedules.cosine_schedule(
            oc.weight_decay, oc.weight_decay_end, cfg.epochs,
            steps_per_epoch)
    sharding = None if mesh is None else mesh_lib.shard_model(model, mesh)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(
        named, opt=oc.opt, lr_schedule=lr_sched, wd_schedule=wd_sched,
        weight_decay=oc.weight_decay, betas=oc.opt_betas, eps=oc.opt_eps,
        clip_grad=oc.clip_grad, layer_decay=oc.layer_decay,
        trainable=head_only if args.only_finetune_last else None,
        sharding=sharding)
    # DeepSpeed's fp16 defaults: initial scale 2^7, window 128
    loss_scale = (DynamicLossScale.create() if cfg.dtype == "float16"
                  else None)
    state = TrainState.create(model, tx, use_ema=cfg.model_ema,
                              loss_scale=loss_scale)

    start_epoch = args.start_epoch
    if args.auto_resume and args.output_dir:
        resumed = ckpt.auto_resume(args.output_dir, model, state)
        if resumed is not None:
            start_epoch = resumed + 1
            log(f"auto-resumed at epoch {start_epoch}")

    # ----- the augmentations and steps -----
    flip = not (args.no_flip or args.data_set in ("SSV2", "EK100"))

    def val_augment(batch):
        clips, boxes = A.eval_augment(
            batch["clip"], out_size=cfg.input_size,
            short_side=cfg.input_size, boxes=batch.get("boxes"))
        out = {"clip": clips, "label": batch["label"]}
        if boxes is not None:
            out["boxes"] = boxes
        if "valid" in batch:
            out["valid"] = batch["valid"]
        return out

    # the steps see the DDP wrapper; saves, loads and EMA the module
    train_model = (ddp.wrap_model(model) if world > 1 and mesh is None
                   else model)
    step_fn = make_finetune_step(
        train_model, tx, cfg, lr_sched, bb_focused=bb_focused,
        augment_fn=make_train_augment(cfg, flip, args.num_sample),
        second_order=second_order, device=device)
    eval_fn = make_eval_step(train_model, cfg, bb_focused=bb_focused,
                             device=device)
    jsonl = M.JsonlLogger(args.output_dir, distributed.is_main_process())
    wandb = WandbLogger(project=os.environ.get("WANDB_PROJECT"),
                        group=os.environ.get("WANDB_GROUP"),
                        name=os.environ.get("WANDB_NAME"),
                        config=vars(args),
                        enabled=distributed.is_main_process())
    generator = torch.Generator(device=device)

    def run_validation(params=None):
        """Validation of the model's weights, or of `params` (EMA)."""
        logger = M.MetricLogger(print_fn=log)
        with _weights(model, params):
            for batch in val_loader:
                out = eval_fn(val_augment(batch))
                logger.update_weighted(int(out["n_valid"]),
                                       loss=float(out["loss"]),
                                       acc1=float(out["acc1"]),
                                       acc5=float(out["acc5"]))
        stats = logger.epoch_stats(sync=True, group=group)
        if world > 1:  # every rank decides on rank 0's numbers
            stats = ddp.broadcast_object(stats)
        log(f"* Acc@1 {stats.get('acc1', 0):.3f} "
            f"Acc@5 {stats.get('acc5', 0):.3f} "
            f"loss {stats.get('loss', 0):.3f}")
        return stats

    if args.eval:
        return run_validation()

    # ----- the train loop (run_class_finetuning.py:529-608) -----
    best_acc1, best_val_loss, stall = -1.0, float("inf"), 0
    t_start = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        train_sampler.set_epoch(epoch)
        logger = M.MetricLogger(print_fn=log)
        for batch in logger.log_every(train_loader, 10, f"Epoch: [{epoch}]",
                                      total=steps_per_epoch):
            # the step's draws follow (seed, step): a resumed run draws
            # what an uninterrupted one draws
            generator.manual_seed(step_seed(cfg.seed, state.step))
            state, m = step_fn(state, batch, generator)
            loss = float(m["loss"])
            logger.update(loss=loss, grad_norm=float(m["grad_norm"]),
                          lr=float(m.get("lr", 0.0)))
            if state.loss_scale is not None:
                logger.update(loss_scale=float(m["loss_scale"]),
                              skipped=float(m["skipped"]))
            if not np.isfinite(loss):
                log(f"Loss is {loss}, stopping training")
                sys.exit(2)
        stats = {f"train_{k}": v for k, v in
                 logger.epoch_stats(sync=True, group=group).items()}
        # seconds per step: waiting on the loader, and the rest of the step
        stats.update(data_wait_s=logger.data_time.global_avg,
                     step_s=logger.iter_time.global_avg
                     - logger.data_time.global_avg)
        t0 = time.time()
        val_stats = run_validation()
        stats["val_s"] = time.time() - t0
        stats.update({f"val_{k}": v for k, v in val_stats.items()})
        if state.ema_params is not None:
            stats.update({f"val_ema_{k}": v for k, v in
                          run_validation(state.ema_params).items()})
        saves = {}
        if args.output_dir:
            names = []
            if (epoch + 1) % cfg.save_ckpt_freq == 0 or \
                    epoch + 1 == cfg.epochs:
                names.append(None)
            if val_stats.get("acc1", 0.0) > best_acc1:
                best_acc1 = val_stats["acc1"]
                names.append("checkpoint-best")
                log(f"new best acc1 {best_acc1:.3f}")
            for name in names:
                t0 = time.time()
                path = ckpt.save_checkpoint(args.output_dir, model, state,
                                            epoch, args, name=name)
                saves[os.path.basename(path)] = time.time() - t0
        stats.update(epoch=epoch, step=state.step, save_s=saves)
        jsonl.write(stats)
        wandb.log(stats, step=epoch)
        # early stopping on the validation loss (run_class_finetuning.py:
        # 582-598)
        if args.early_stop_patience > 0:
            if val_stats.get("loss", 0.0) < best_val_loss - 1e-6:
                best_val_loss, stall = val_stats["loss"], 0
            else:
                stall += 1
                if stall >= args.early_stop_patience:
                    log(f"early stopping at epoch {epoch}")
                    break
    log(f"Training time {time.time() - t_start:.0f}s; best acc1 "
        f"{best_acc1:.3f}")

    # ----- the final multi-view test (engine_for_finetuning.py:227-348)
    if args.output_dir:
        best = os.path.join(args.output_dir, "checkpoint-best.pth")
        if os.path.exists(best):
            ckpt.load_checkpoint(best, model, state)
            log("loaded checkpoint-best for the final test")
    final_test(model, test_ds, cfg, bb_focused, log, device,
               args.num_workers,
               action_to_vn if args.classtype == "action" else None)
    return state


def final_test(model, test_ds, cfg: FinetuneConfig, bb_focused: bool, log,
               device, num_workers: int = 1, action_to_vn=None):
    """The multi-view test of `model` on test_ds's views
    (engine_for_finetuning.py:227-348): each batch grouped by its views'
    spatial window (split_nb) through test_view_augment (boxes too), the
    padded rows dropped, softmax-mean per video. With action_to_vn (EK-100
    actions) also the verb and noun accuracies of the marginalized scores
    (utils.py:584-606). Prints and returns (top1, top5). Each process tests
    its shard of the views; the rows are merged across processes before
    the scores (gather_across_processes). A model sharded on a mesh tests
    one shard per batch coordinate (its model peers make the same calls),
    reads its fsdp-sharded weights from one gather and merges over the
    batch coordinates."""
    t0 = time.time()
    rank, world = distributed.process_index(), distributed.process_count()
    sharding, group, rows = mesh_lib.sharding_of(model), None, cfg.batch_size
    if sharding is not None:
        group = sharding.mesh.batch
        rank, world = group.index, group.size
        rows *= sharding.mesh.shape[2]
    loader = P.PrefetchLoader(
        test_ds, rows,
        P.ShardedSampler(len(test_ds), rank, world, shuffle=False),
        device=device, drop_last=False, num_workers=num_workers)
    # per-process logits: the ranks may make different numbers of calls
    eval_fn = make_eval_step(ddp.unwrap(model), cfg, bb_focused=bb_focused,
                             device=device, reduce=False)
    agg = MultiViewAggregator()
    with (contextlib.nullcontext() if sharding is None
          else sharding.gathered(model)):
        _test_views(loader, eval_fn, agg, cfg, bb_focused)
    agg = (gather_across_processes(agg) if group is None
           else gather_across_processes(agg, group))
    top1, top5, _ = agg.finalize()
    log(f"Final test: Acc@1 {top1:.2f} Acc@5 {top5:.2f} "
        f"({time.time() - t0:.3f} s)")
    if action_to_vn is not None:
        feats, labels = agg.merge_feats()
        vids = list(feats)
        probs = np.stack([feats[v] for v in vids])
        lab = np.array([labels[v] for v in vids])
        acc = {}
        for col, mode in enumerate(("verb", "noun")):
            marg = marginalize(probs, get_marginal_indexes(action_to_vn,
                                                           mode))
            true = np.array([action_to_vn[a][col] for a in lab])
            acc[mode] = float(np.mean(np.argmax(marg, axis=1) == true)) * 100
        log(f"Final test (EK marginalized): verb {acc['verb']:.2f} "
            f"noun {acc['noun']:.2f}")
    return top1, top5


def _test_views(loader, eval_fn, agg: MultiViewAggregator,
                cfg: FinetuneConfig, bb_focused: bool) -> None:
    """Each batch's valid views, grouped by their spatial window, through
    test_view_augment and eval_fn into `agg`."""
    for batch in loader:
        split = batch["split_nb"].cpu().numpy()
        valid = (batch["valid"].cpu().numpy() if "valid" in batch
                 else np.ones(split.shape[0], bool))
        for s in range(cfg.test_num_crop):
            sel = np.nonzero((split == s) & valid)[0]
            if len(sel) == 0:
                continue
            sub = {k: v.index_select(0, torch.from_numpy(sel).to(v.device))
                   for k, v in batch.items()}
            clips, boxes = A.test_view_augment(
                sub["clip"], s, out_size=cfg.input_size,
                short_side=cfg.input_size, num_crops=cfg.test_num_crop,
                boxes=sub["boxes"] if bb_focused else None)
            eb = {"clip": clips, "label": sub["label"]}
            if bb_focused:
                eb["boxes"] = boxes
            out = eval_fn(eb)
            agg.add(sub["video_idx"].tolist(), sub["chunk_nb"].tolist(),
                    sub["split_nb"].tolist(), out["logits"].cpu().numpy(),
                    sub["label"].tolist())


if __name__ == "__main__":
    main()
