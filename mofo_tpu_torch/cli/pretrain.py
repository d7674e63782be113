"""MAE pretraining runner (plain VideoMAE and MOFO motion-aware), on one
device or data-parallel over W processes.

Counterpart of mofo_tpu/cli/pretrain.py: the flags and defaults of
run_mae_pretraining.py:22-132 plus the BB flags of
run_mae_pretraining_BB.py (--mask_type tube_bb, --mask_ratio_BB, the
gradual loss weight np.linspace(1, 0, epochs)), and --device (default
cuda). mofo_tpu_torch.cli.pretrain_mofo presets the MOFO flags. Each step
takes a batch of uint8 clips from the prefetching loader, augments it on
the device (GroupMultiScaleCrop, boxes mapped through the crop) and trains;
every epoch appends a line to <output_dir>/log.txt, every save_ckpt_freq
epochs writes checkpoint-<epoch>.pth, and a rerun resumes after the latest
one.

Data: --data_path, a "path [duration] label" setting file, decoded
through data.video_reader (native/decoder's FFmpeg library, else cv2) at
--decode_height x --decode_width, TSN ids at --sampling_rate, with
--bb_json's motion boxes (needed by --mask_type tube_bb); or --synthetic N
random clips.

Usage (the warm-up epochs must fit in --epochs: the default is 40):
  python -m mofo_tpu_torch.cli.pretrain_mofo --data_path train.csv \\
      --bb_json Unsupervised_BB_SSV2_train.json --epochs 2 \\
      --warmup_epochs 1 --output_dir out/

On W GPUs, one process each (torchrun, SLURM or OpenMPI set the ranks;
core/distributed.py):
  torchrun --nproc_per_node W -m mofo_tpu_torch.cli.pretrain_mofo ...
--batch_size stays per process and the LR is scaled by the global batch;
the W ranks compute what one process computes on their global batch
(parallel/ddp.py). Rank 0 prints, writes log.txt and the checkpoints.
--device cpu runs the ranks over gloo. A caller that has joined the
process group itself (init_distributed_mode with its own init_method)
may call main() in each process.

--mesh_fsdp F and --mesh_model M lay the W ranks out on the mesh (data,
F, M) of parallel/mesh.py (--mesh_data -1 takes what is left); the run
accepts exactly the meshes mofo_tpu accepts at W devices and raises
ValueError for the others. With F or M above 1 the parameters, their
moments and the EMA are sharded over fsdp and the attention heads and MLP
units split over model; each batch coordinate (d, f) loads batch_size * M
rows (the global batch stays batch_size * W) and its M model peers load
and draw the same rows. The checkpoints hold the full tensors under the
reference's names, so a run resumes on any mesh. On one GPU the ranks of
a mesh share it over gloo (NCCL refuses two ranks on one device); on a
multi-GPU host torchrun's ranks use NCCL.

--opt takes every name of mofo_tpu's zoo (train/optim.py); an unknown one
raises ValueError("Unknown optimizer: ..."). A second-order one
(adahessian, lookahead_adahessian) builds the model with the plain
attention route, attn_impl="xla" (the kernels' backwards are first-order
only), and trains with the Hutchinson probe. With WANDB_PROJECT (and
WANDB_GROUP, WANDB_NAME) set, rank 0 also logs every epoch's line to
wandb when the package is installed (train/wandb_compat.py).

Every --opt name also runs on a mesh with an fsdp or model axis: the
layout-reading ones (adafactor, adamp, sgdp, adahessian and their
lookahead_ forms) take each parameter whole over its shards
(train/optim.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.config import (
    MaskingConfig,
    MeshSpec,
    OptimizerConfig,
    PretrainConfig,
)
from mofo_tpu_torch.core.device import resolve_device
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.data.filelist import MotionBoxIndex, read_setting_file
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.parallel import ddp
from mofo_tpu_torch.parallel import mesh as mesh_lib
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import metrics as M
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState
from mofo_tpu_torch.train.wandb_compat import WandbLogger


def get_args(argv=None, mofo_defaults: bool = False):
    p = argparse.ArgumentParser("MOFO pre-training (PyTorch)", add_help=True)
    p.add_argument("--batch_size", default=12, type=int,
                   help="per-device batch size")
    p.add_argument("--epochs", default=800, type=int)
    p.add_argument("--save_ckpt_freq", default=50, type=int)
    p.add_argument("--update_freq", default=1, type=int)
    # model
    p.add_argument("--model",
                   default="pretrain_videomae_base_patch16_224", type=str)
    p.add_argument("--decoder_depth", default=4, type=int)
    p.add_argument("--mask_type", default="tube_bb" if mofo_defaults
                   else "tube", choices=["tube", "tube_bb"], type=str)
    p.add_argument("--mask_ratio", default=0.9, type=float)
    p.add_argument("--mask_ratio_BB", default=0.75, type=float)
    p.add_argument("--bug_compat", action="store_true",
                   help="reproduce reference masking quirks")
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--sampling_rate", default=2, type=int)
    p.add_argument("--tubelet_size", default=2, type=int)
    p.add_argument("--drop_path", default=0.0, type=float)
    p.add_argument("--normlize_target", default=True, type=bool,
                   help="(reference spelling) normalized pixel targets")
    # optimizer
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=[0.9, 0.95], type=float,
                   nargs="+")
    p.add_argument("--clip_grad", default=None, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--weight_decay_end", default=None, type=float)
    p.add_argument("--lr", default=1.5e-4, type=float)
    p.add_argument("--warmup_lr", default=1e-6, type=float)
    p.add_argument("--min_lr", default=1e-5, type=float)
    p.add_argument("--warmup_epochs", default=40, type=int)
    p.add_argument("--warmup_steps", default=-1, type=int)
    # data
    p.add_argument("--data_path", default=None, type=str,
                   help="train list csv ('path label' lines)")
    p.add_argument("--bb_json", default=None, type=str,
                   help="Unsupervised_BB_*.json motion boxes")
    p.add_argument("--synthetic", default=0, type=int,
                   help="use N synthetic clips instead of --data_path")
    p.add_argument("--decode_height", default=256, type=int)
    p.add_argument("--decode_width", default=320, type=int)
    p.add_argument("--num_workers", default=1, type=int)
    # misc
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", action="store_false",
                   dest="auto_resume")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain PyTorch versions")
    # mesh
    p.add_argument("--mesh_data", default=-1, type=int)
    p.add_argument("--mesh_fsdp", default=1, type=int)
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--steps_per_epoch", default=None, type=int,
                   help="override (for synthetic data)")
    return p.parse_args(argv)


def resolve_mesh(args, world: int):
    """The run's (data, fsdp, model) at `world` processes (shared with
    cli/finetune.py): parallel.mesh.MeshConfig.resolve of the --mesh_*
    flags, which raises ValueError with mofo_tpu's condition for a mesh
    mofo_tpu refuses."""
    try:
        return mesh_lib.MeshConfig(args.mesh_data, args.mesh_fsdp,
                                   args.mesh_model).resolve(world)
    except ValueError as e:
        raise ValueError(
            f"--mesh_data {args.mesh_data} with {world} process(es), "
            f"--mesh_fsdp {args.mesh_fsdp} --mesh_model {args.mesh_model}: "
            f"{e}") from None


def build_run_mesh(args, world: int, log):
    """The mesh of the --mesh_* flags when it shards parameters (fsdp or
    model above 1), else None: the data axis alone runs through DDP
    (parallel/ddp.py)."""
    shape = resolve_mesh(args, world)
    if shape[1] == 1 and shape[2] == 1:
        return None
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(*shape))
    log(f"mesh (data, fsdp, model) = {shape}")
    return mesh


def build_config(args, world: int = 1) -> PretrainConfig:
    """The run's PretrainConfig at `world` processes; raises ValueError on
    a mesh mofo_tpu refuses at that many devices (resolve_mesh)."""
    resolve_mesh(args, world)
    return PretrainConfig(
        model=args.model,
        decoder_depth=args.decoder_depth,
        input_size=args.input_size,
        num_frames=args.num_frames,
        tubelet_size=args.tubelet_size,
        drop_path=args.drop_path,
        normalize_target=args.normlize_target,
        batch_size=args.batch_size,
        epochs=args.epochs,
        save_ckpt_freq=args.save_ckpt_freq,
        update_freq=args.update_freq,
        seed=args.seed,
        dtype=args.dtype,
        masking=MaskingConfig(
            mask_type=args.mask_type,
            mask_ratio=args.mask_ratio,
            mask_ratio_bb=args.mask_ratio_BB,
            bug_compat=args.bug_compat,
        ),
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
        ),
        mesh=MeshSpec(args.mesh_data, args.mesh_fsdp, args.mesh_model),
        motion_loss_weight=args.mask_type == "tube_bb",
    )


def build_dataset(args, cfg: PretrainConfig, reader=VideoReader):
    """The run's clips: --synthetic N random ones, or --data_path's setting
    file through PretrainClipDataset (mofo_tpu/cli/pretrain.py:165-190).
    tube_bb masks need --bb_json's boxes. `reader` replaces VideoReader
    (an in-memory reader in the checks; no CLI flag reaches it)."""
    with_boxes = cfg.masking.mask_type == "tube_bb"
    decode_size = (args.decode_height, args.decode_width)
    if args.synthetic:
        return P.SyntheticClipDataset(n=args.synthetic,
                                      num_frames=cfg.num_frames,
                                      decode_size=decode_size,
                                      with_boxes=with_boxes)
    entries = read_setting_file(args.data_path)
    boxes = MotionBoxIndex.from_file(args.bb_json) if args.bb_json else None
    if with_boxes and boxes is None:
        raise SystemExit("--mask_type tube_bb requires --bb_json")
    return P.PretrainClipDataset(
        entries=entries, num_frames=cfg.num_frames,
        sampling_rate=args.sampling_rate, decode_size=decode_size,
        boxes=boxes, reader=reader)


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's draws (crop, masks). The JAX runner folds its
    run key with the step counter (pretrain_step.py:157); deriving the seed
    from (seed, step) likewise makes a resumed run draw what an
    uninterrupted one draws."""
    return ((seed + 1) << 32) + step


def main(args=None, reader=VideoReader):
    """Runs the pretraining; returns the final TrainState. `reader` opens
    --data_path's videos (see build_dataset)."""
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
    world = distributed.process_count()
    cfg = build_config(args, world)
    log(f"config: {cfg}")
    device = resolve_device(distributed.run_device(args.device))
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))

    mesh = build_run_mesh(args, world, log)

    # ----- data: one shard per batch coordinate (its model peers alike) ---
    dataset = build_dataset(args, cfg, reader)
    sampler = P.ShardedSampler(
        len(dataset), seed=cfg.seed,
        rank=distributed.process_index() if mesh is None else
        mesh.batch.index,
        world=world if mesh is None else mesh.batch.size)
    loader = P.PrefetchLoader(
        dataset, batch_size=cfg.batch_size * (1 if mesh is None
                                              else mesh.shape[2]),
        sampler=sampler, device=device, num_workers=args.num_workers)
    steps_per_epoch = args.steps_per_epoch or max(len(loader), 1)

    # ----- model & optimizer -----
    second_order = optim.is_second_order(args.opt)
    model_kwargs = {}
    if second_order:
        # the Hutchinson probe differentiates the backward pass; the
        # kernels' backwards are first-order only
        model_kwargs["attn_impl"] = "xla"
        log("second-order optimizer: attention routed through XLA")
    model = create_model(
        cfg.model, device=device, seed=cfg.seed,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        decoder_depth=cfg.decoder_depth,
        drop_path_rate=cfg.drop_path,
        num_frames=cfg.num_frames,
        tubelet_size=cfg.tubelet_size,
        img_size=cfg.input_size,
        **model_kwargs,
    )
    oc = cfg.optimizer
    lr = schedules.scaled_lr(oc.lr, cfg.batch_size * world)
    log(f"base lr: {oc.lr:.2e}  scaled lr: {lr:.2e}")
    lr_sched = schedules.cosine_schedule(
        lr, oc.min_lr, cfg.epochs, steps_per_epoch, oc.warmup_epochs,
        oc.warmup_lr, oc.warmup_steps)
    wd_sched = None
    if oc.weight_decay_end is not None:
        wd_sched = schedules.cosine_schedule(
            oc.weight_decay, oc.weight_decay_end, cfg.epochs,
            steps_per_epoch)
    log(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    sharding = None if mesh is None else mesh_lib.shard_model(model, mesh)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(
        named, opt=oc.opt, lr_schedule=lr_sched, wd_schedule=wd_sched,
        weight_decay=oc.weight_decay, betas=oc.opt_betas, eps=oc.opt_eps,
        clip_grad=oc.clip_grad, sharding=sharding)
    state = TrainState.create(model, tx)

    start_epoch = args.start_epoch
    if args.auto_resume and args.output_dir:
        resumed = ckpt.auto_resume(args.output_dir, model, state)
        if resumed is not None:
            start_epoch = resumed + 1
            log(f"auto-resumed at epoch {start_epoch}")

    # gradual MOFO loss weighting (run_mae_pretraining_BB.py:262)
    loss_weights = np.linspace(1, 0, cfg.epochs)
    out_size = cfg.input_size

    def augment_batch(generator, batch):
        clips, boxes = A.pretrain_augment(generator, batch["clip"],
                                          out_size=out_size,
                                          boxes=batch.get("boxes"))
        out = {"clip": clips}
        if boxes is not None:
            out["boxes"] = boxes
        return out

    step_fn = make_pretrain_step(
        ddp.wrap_model(model) if world > 1 and mesh is None else model, tx,
        cfg, lr_sched,
        device=device, augment_fn=augment_batch, second_order=second_order)
    is_main = distributed.is_main_process()
    jsonl = M.JsonlLogger(args.output_dir, is_main)
    wandb = WandbLogger(project=os.environ.get("WANDB_PROJECT"),
                        group=os.environ.get("WANDB_GROUP"),
                        name=os.environ.get("WANDB_NAME"),
                        config=vars(args), enabled=is_main)
    tb = M.TensorboardLogger(args.log_dir if is_main else None)
    generator = torch.Generator(device=device)

    log(f"Start training for {cfg.epochs} epochs "
        f"({steps_per_epoch} steps/epoch)")
    t_start = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        sampler.set_epoch(epoch)
        logger = M.MetricLogger(print_fn=log)
        lw = float(loss_weights[epoch]) if cfg.motion_loss_weight else 0.0
        for batch in logger.log_every(loader, 10, f"Epoch: [{epoch}]",
                                      total=steps_per_epoch):
            generator.manual_seed(step_seed(cfg.seed, state.step))
            state, m = step_fn(state, batch, generator, lw)
            loss = float(m["loss"])
            logger.update(loss=loss, grad_norm=float(m["grad_norm"]),
                          lr=float(m.get("lr", 0.0)))
            tb.update(head="loss", step=state.step, loss=loss)
            if not np.isfinite(loss):
                log(f"Loss is {loss}, stopping training")
                sys.exit(1)
        stats = {f"train_{k}": v for k, v in logger.epoch_stats(
            sync=True, group=None if mesh is None else mesh.batch).items()}
        # seconds per step: waiting on the loader, and the rest of the
        # step (augmentation, forward, backward, update, the loss read)
        stats.update(epoch=epoch, data_wait_s=logger.data_time.global_avg,
                     step_s=logger.iter_time.global_avg
                     - logger.data_time.global_avg)
        jsonl.write(stats)
        wandb.log(stats, step=epoch)
        if args.output_dir and ((epoch + 1) % cfg.save_ckpt_freq == 0
                                or epoch + 1 == cfg.epochs):
            ckpt.save_checkpoint(args.output_dir, model, state, epoch, args)
            log(f"saved checkpoint-{epoch}")
    log(f"Training time {time.time() - t_start:.0f}s")
    return state


if __name__ == "__main__":
    main()
