#!/usr/bin/env python3
"""Drives the PyTorch / CUDA port (mofo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - refuses to run without CUDA; the card's name and power limit
               (nvidia-smi); TF32 off for the f32 phases.
  2. build   - compiles the CUDA kernels from mofo_tpu_torch/csrc (one
               nvcc per source, all started together, sm_90a), or reuses the
               build of this checkout; ptxas's registers and spills.
  3. kernels - each fused-qkv kernel (K1/K2, in bf16 with the backward's
               prep pass) against its plain PyTorch version at the pretrain
               step's encoder and decoder shapes (B=16), the finetune
               backbone's (B=10, N=1568, H=12), a ragged one, the long
               sequences the TPU kernels are gated at (N=3136 with 6 and 12
               heads, N=4608) and ViT-L's 16 heads, bf16 and f32, with the
               bounds of mofo_tpu_torch/tools/main_path.py (which must also
               reject two planted faults), the ragged one again at scale
               0.1 (dQ's scaled-K copy); then, on the same bf16 qkv at the
               steps' shapes, kernel, plain, library
               (F.scaled_dot_product_attention, a yardstick the port never
               calls) and bound times, the forward over the library's
               (k1_fwd_vs_library) and K2 (prep + dK/dV + dQ) over the
               library's backward (k2_vs_library). Every time is the median
               of 5 runs of back-to-back calls between two CUDA events.
  4. mh_kernels - the same for the masked multihead kernels (K3): the MCA
               (B=10, N=1568, 3 x 256), 12 x 64 at N=1568 and N=3136 and
               ragged N=100 at 1 x 256 and 2 x 64, bf16 and f32, bias
               present and absent, in bf16 with the backward's prep pass;
               planted faults (the bias ignored, dQ zeroed, dK without its
               1/log2 e fix) must be rejected and masked kv rows must get
               zero dK/dV; the ragged ones again at scale 0.1 (the scaled-K
               copy at head dim 64, the in-place fold at 256); then the
               times at the MCA shape (k3_fwd_vs_library: the forward over
               the library's; k3_bwd_vs_library: prep + dK/dV + dQ over the
               library's backward).
  5. step    - the ViT-B MOFO pretrain step at full width (tube_bb masks,
               motion-weighted loss, AdamW): 1 warm-up + 5 timed steps, the
               launch counts of every kernel checked.
  6. parity  - a ViT-B-width model cut to 2+1 blocks, f32, B=1: loss and
               gradient norm on the card (kernels) against the CPU (plain
               versions), same weights and masks. f32 runs the FMA kernels,
               so this phase does not cover the bf16 (tensor-core) kernels
               of the step: phase 3 holds those.
  7. finetune_step - the ViT-B BB-focused MCA finetune step at the
               FinetuneConfig defaults (bf16, B=10, mixup, cutmix, label
               smoothing, drop path 0.1, AdamW with layer decay), backbone
               from the pretrain model: 1 warm-up + 5 timed steps and one
               eval call, every kernel's launches checked (one of each of
               the four K3 kernels per train step, one K3 forward in the
               eval call).
  8. finetune_parity - the BB-focused model at ViT-B width cut to 2
               Blocks, f32, B=2, same weights and mixup draws: loss and
               gradient norm on the card against the CPU; one sample has no
               in-box token, the other a box over the whole frame.
  9. hm_kernels - the head-major kernels (K4) against their plain versions
               at the ViT-S runner's decoder (B=32, H=3, N=1568), the TPU's
               own gated geometry (B=2, H=6, N=1568), ragged N=100 and the
               32-frame N=3136, bf16 and f32, D=64, in bf16 with the
               backward's prep pass; planted faults (dQ zeroed, the LSE in
               log2 units) must be rejected; the ragged one again at scale
               0.1 (dQ's scaled-K copy); then the times at the runner's
               decoder shape (with the forward over the library's, and
               k4_bwd_vs_library: prep + dK/dV + dQ over the library's
               backward), and (k1_vs_k4) how far
               K1's numerics, which the ViT-S decoder ran before it took
               the head-major route, lie from K4's on the same inputs.
     hm_head_dims - K4's four entry points at head dims 16 and 32 (the
               tiny presets'), bf16 and f32, at (B*H, N) = (4, 1568) and
               the ragged (4, 200), against their plain versions with the
               same bounds and planted faults; then kernel, plain, library
               and bound times at (4, 1568) for D = 16, 32 and 64.
 10. bf16_step_vs_plain - the bf16 steps through the kernels against the
               same steps through the plain bf16 versions on the same CUDA
               tensors (main_path's plain=True, a switch of the checks
               only): ViT-B and ViT-S pretrain cut to 2+1 Blocks and the
               ViT-B BB-focused MCA finetune step cut to 2 Blocks, full
               width, B=2, two steps each from the same weights, masks,
               mixup and drop-path draws; loss and gradient norm within
               BF16_STEP_RTOL, the kernels' launches counted (none in the
               plain run).
 11. vits_step - the ViT-S MOFO pretrain step at full width (bf16, B=32):
               1 warm-up + 5 timed steps, 12 K1/K2 launches (encoder) and 4
               K4 launches (decoder) of each kernel, the prep passes
               included, per step, exactly.
 12. vits_parity - ViT-S width cut to 2+1 blocks, f32, B=1: card against
               CPU as in phase 6; covers the f32 K4 kernels.
 13. runner  - the ViT-S MOFO pretrain runner
               (mofo_tpu_torch.cli.pretrain_mofo.main, in this process) on
               64 synthetic uint8 clips at B=32 for 2 epochs into a
               temporary output dir, then again with --epochs 3, which must
               resume at epoch 2; log.txt, checkpoint-{0,1,2}.pth, finite
               losses and the launches per step are checked, and the step
               time and the loader wait printed apart.
 14. finetune_augment - the finetune runner's augmentations at its shapes
               (B=10 uint8 clips of 16 x 256 x 320, boxes, out 224):
               finetune_augment (RandAugment rand-m7-n4-mstd0.5-inc1, flip,
               erasing 0.25), eval_augment and test_view_augment (splits 0,
               1, 2), each on the card and on the CPU with the same draws,
               which force all 15 RandAugment ops, the geometric ones in
               both interpolations: max |card - CPU| and the share of pixels
               within 1e-3 (at least AUG_SHARE), which an equalize LUT off
               by one bin must fail; and each pipeline's time at B=10 beside
               the finetune step's.
 15. fp16_finetune_step - three ViT-B BB-focused MCA finetune steps in fp16
               under the dynamic loss scale (the kernels through their fp16
               boundary, on bf16 operands) against the same steps in f32 on
               the same inputs: losses within 1%, the scale 128, nothing
               skipped; then a step with one clip scaled to inf must be
               skipped, halve the scale and leave the parameters, the AdamW
               moments and count as they were, bit for bit.
 16. finetune_runner - the main path of this slice: the ViT-B BB-focused
               MCA finetune runner (mofo_tpu_torch.cli.finetune_mofo's main,
               in this process, bf16) on 40 synthetic clips at B=10 from a
               ViT-B pretrain checkpoint (seed 1) for 2 epochs, then again
               with --epochs 3, which must resume; log.txt (epochs, losses,
               val_acc1), checkpoint-1, -2 and -best, one "Final test" line
               per call and the kernels' launches (per train step and per
               eval call) are checked; the step time, the loader wait and
               the seconds of validation, the final test and each
               checkpoint save are printed. The synthetic test set is the
               clips themselves, one view each, as mofo_tpu's.
 17. real_data_runner - the main path of the real-data slice: SSV2-style
               setting files over 64 mp4 files that cv2 writes (40-60
               frames of main_path.MemoryReader's frames each), an
               Unsupervised_BB_SSV2_train.json with one box per frame and
               EPIC_100-shaped CSVs over 1 KB placeholders, in a temporary
               dir; 8 of the mp4 files decoded through the port's
               VideoReader (frame counts and shapes checked). Then, in this
               process: the ViT-S MOFO pretrain runner with --data_path
               --bb_json (B=32, 2 epochs of 2 steps, --num_workers 4) in
               bf16 and in f32, the bf16 losses within PRETRAIN_F32_RTOL of
               the f32 ones; the ViT-B BB-focused MCA finetune runner on
               the SSV2 lists (--val_path, --test_path; B=10, 1 epoch, the
               final test over 2 x 3 entry-major views), decoding the mp4
               files through VideoReader, and on EK-100 (--classtype
               action, its marginalized line); and feature_extract from the
               SSV2 run's checkpoint-best (8 videos through VideoReader,
               B=4: (8, 768) finite features). The pretrain and EK-100 runs
               read MemoryReader's frames through the datasets' `reader`
               field (the EK-100 files are placeholders). Steps, log.txt,
               losses, the Final test lines and every kernel's launches
               (eval calls from the test views' entry-major order) are
               checked, and the in-memory datasets through the loader onto
               the card must equal the same datasets on the CPU after the
               same np.random.seed, each box the square of its frame.
 18. loader_modes - the ViT-S runner's dataset through PrefetchLoader at
               B=32 with one thread and with four: the first batch and the
               mean wait of the next three (a line, no gate).
 19. ddp_step - data parallelism over NCCL at world 1 (a process group on
               localhost, a free port): the ViT-B MOFO pretrain step of
               phase `step` (B=16, bf16) through DistributedDataParallel
               (main_path.build_step's wrap=True) against the same step
               without it from the same weights and tensors: 1 warm-up + 5
               timed steps each, losses and gradient norms within
               DDP_STEP_RTOL (bit-equality expected), both step times
               printed, the DDP run's launches checked exactly.
 20. ddp_two_ranks - two processes on cuda:0 over gloo (NCCL refuses two
               ranks on one device; mofo_tpu_torch.tools.ddp_ranks check),
               each on its rows of the global batch G', against one
               process at G' on the same card (tools.ddp_ranks.
               two_rank_runs): the ViT-B MOFO pretrain step at full width
               and depth (B=8 a rank, update_freq 2, motion weights, masks
               drawn in the step), 3 steps in f32 and in bf16; the ViT-B
               BB-focused MCA finetune step (f32, 10 classes, B=5 a rank,
               RandAugment, crop, flip, erasing, mixup elem with cutmix,
               drop path 0.1), 2 steps, then one validation pass (its sums
               over the ranks) and the multi-view merge across them. f32:
               losses and gradient norms within DDP_F32_RTOL, parameters
               within DDP_F32_ATOL; bf16: BF16_STEP_RTOL; validation Acc@1
               / Acc@5 and the merged ones equal, per-view logits within
               DDP_F32_ATOL. K1/K2 and K3 run under DDP's hooks in the
               ranks; their launches are counted there.
 21. ddp_runner - the runners through the launcher: `python -m
               torch.distributed.run --standalone --nproc_per_node 1 -m
               mofo_tpu_torch.tools.ddp_ranks cli ...` (which calls the
               runner's main and writes the process's launch counts) runs
               cli.pretrain_mofo (ViT-S, 64 synthetic clips at B=32, one
               epoch of 2 steps, then auto-resumed for a second) and
               cli.finetune_mofo (ViT-B BB-focused MCA, 20 clips at B=10,
               one epoch with validation and the final test); log.txt, the
               checkpoints (no `module.` names), the resume, the Final
               test line and every kernel's launches are checked (K4 in
               the ViT-S decoder).
 22. factory - the offline motion-box factory (mofo_tpu_torch.cli.
               motion_factory's main, in this process, its defaults: TV-L1
               with 4 scales, 8 warps and 100 iterations on the card, window
               8, --max_frames 64) on 8 of write_real_data's SSV2-style mp4
               files (256 x 320, 40-60 frames, cv2 writes them here): every
               video in the JSON with a box per frame, no SKIP line; two
               frame pairs of the shortest video through tvl1_flow on the
               card against the CPU (FLOW_CPU_MAX, FLOW_CPU_P99; with the
               count of results of each elementwise op that round
               differently on the two devices, op_roundings); four pairs
               batched against one call a pair on the card (BATCHED_ATOL),
               both timed; that video's JSON from --device cpu against the
               card's (at most FACTORY_BOX_PX per coordinate). Printed, not
               gated: seconds per video by stage (decode, flow, maps, boxes,
               write), flow ms per pair and per video, peak memory, and the
               mean IoU of the per-frame boxes (--no_clip_union) against
               MemoryReader's square. Then the loop closed: the ViT-S MOFO
               pretrain runner, one epoch on the 8 videos at B=4 (decoded by
               VideoReader) with the factory's JSON as --bb_json, its K1/K2
               and K4 launches checked.
 23. vis     - mofo_tpu_torch.cli.vis (pretrain_videomae_base_patch16_224,
               16 frames at 224, mask 0.9, f32, weights from seed 0) on one
               such video: 48 frames written, 16 launches of qkv_attn_fwd
               (its 12 encoder and 4 decoder Blocks on K1's f32 route), the
               reconstruction within VIS_ATOL of the same call on the CPU
               (the plain versions, the same mask).
 24. tiny_debug_step - pretrain_videomae_tiny_debug at 224^2 and 16 frames
               (every Block on K4: the encoder's 2 x 32 heads on 160
               visible tokens, the decoder's 2 x 16 on 1568), B=8, two steps
               in f32 and two in bf16 through the kernels against the same
               steps through the plain versions on the card (F32_STEP_RTOL,
               BF16_STEP_RTOL), K4's launches checked exactly.
 25. dropout_step - the ViT-B BB-focused MCA finetune step at --drop 0.1:
               two runs of 2 steps from one seed, bit-equal, each launching
               K1/K2/K3 as finetune_step does, the loss off the same step
               without dropout; at --attn_drop_rate 0.1 (B=2) the plain
               head-major route, no K1/K2/K3 launch, finite losses.
 26. attention_vis - mofo_tpu_torch.cli.attention_vis on ViT-B (224^2, 16
               frames, f32, a seeded .pth) for grad, rollout, gradcam and
               gradcam++ on the card: 16 files each, the map's max 1, the
               launches (K1's f32 forward in 12 Blocks and K2 in the Blocks
               the gradient needs; none for rollout), the seconds; gradcam++
               and rollout again on the CPU, within VIS_ATOL.
 27. factory_chunks - motion_factory.video_flows on a cv2-written 1920 x
               1080, 16-frame video of a square moving rigidly, under a byte
               budget of CHUNK_PAIRS pairs (3 calls) and in one call: flows
               and per-frame boxes equal, each run's peak memory and seconds,
               the boxes' mean IoU with the square.
Then the card's nvidia-smi line, the kernels line and, last, the ok line.
Any failed check raises, and the script exits non-zero without the ok line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mofo_tpu_torch.cli import attention_vis, feature_extract, finetune_mofo
from mofo_tpu_torch.cli import motion_factory, pretrain_mofo, vis
from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.data.epic import EpicClipDataset
from mofo_tpu_torch.data.filelist import (
    MotionBoxIndex,
    epic_action_space,
    read_epic_csv,
    read_setting_file,
)
from mofo_tpu_torch.data.video_reader import VideoReader, native_available
from mofo_tpu_torch.factory import flow
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import _build
from mofo_tpu_torch.ops import augment as A
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import attention, masking
from mofo_tpu_torch.ops import rand_augment as RA
from mofo_tpu_torch.tools import ddp_ranks
from mofo_tpu_torch.tools.main_path import (
    AUG_ATOL,
    AUG_SHARE,
    FINETUNE_MODEL,
    MODEL,
    VITS_MODEL,
    MemoryReader,
    attention_against_plain,
    augment_against_cpu,
    build_finetune_step,
    build_step,
    check_against_plain,
    check_hm_prep,
    check_mh_prep,
    check_prep,
    compare_with_plain,
    finetune_model,
    forced_draws,
    frame_ids,
    hm_attention_against_plain,
    hm_inputs,
    hm_planted_faults,
    masked_kv_grad,
    memory_box_json,
    mh_attention_against_plain,
    mh_inputs,
    moved_draws,
    planted_faults,
    synthetic_batch,
    synthetic_clips_u8,
    synthetic_finetune_batch,
)
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.finetune_step import (
    make_eval_step,
    make_finetune_step,
    mixup_for,
)
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

SOURCES = {n: "mofo_tpu_torch/csrc/qkv_flash_attention.cu"
           for n in fa.QKV_KERNELS}
SOURCES.update({n: "mofo_tpu_torch/csrc/mh_flash_attention.cu"
                for n in fa.MH_KERNELS})
SOURCES.update({n: "mofo_tpu_torch/csrc/hm_flash_attention.cu"
                for n in fa.HM_KERNELS})
TPU_FILE = "mofo_tpu/ops/flash_attention.py"
REPLACES = {  # the pallas_call sites of the TPU kernels
    "qkv_attn_fwd": f"{TPU_FILE}:1160",  # _qkv_fwd_impl -> _mh_fwd_kernel
    # _qkv_bwd_impl's in-kernel delta (:1016-1023) and the scale fold
    "qkv_attn_bwd_prep": f"{TPU_FILE}:1224",
    "qkv_attn_bwd_dkv": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dK, dV)
    "qkv_attn_bwd_dq": f"{TPU_FILE}:1224",  # _qkv_bwd_impl (dQ)
    # _mh_fwd_impl -> _mh_fwd_kernel with has_bias
    "mh_attn_fwd": f"{TPU_FILE}:678",
    # _mh_bwd_impl's delta in XLA (:751-758) and the kernels' scale folds
    "mh_attn_bwd_prep": f"{TPU_FILE}:751",
    "mh_attn_bwd_dkv": f"{TPU_FILE}:783",  # _mh_bwd_impl (dK, dV)
    "mh_attn_bwd_dq": f"{TPU_FILE}:783",  # _mh_bwd_impl (dQ)
    "hm_attn_fwd": f"{TPU_FILE}:275",  # _fwd_impl -> _fwd_kernel
    # _bwd_impl's delta in XLA (:313-315) and the kernels' scale folds
    "hm_attn_bwd_prep": f"{TPU_FILE}:313",
    "hm_attn_bwd_dkv": f"{TPU_FILE}:359",  # _bwd_impl -> _dkv_kernel
    "hm_attn_bwd_dq": f"{TPU_FILE}:332",  # _bwd_impl -> _dq_kernel
}
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
HBM = 3.35e12  # H100 SXM bytes/s
STEP_BATCH = 16
# (B, N, H) of the main path's attention at STEP_BATCH; the checks add a
# ragged geometry, the long sequences the TPU kernels are gated at
# (tests/test_tpu_kernels.py:302-321: 32 frames at 224^2 with 6 and 12
# heads, 16 frames at 384^2) and ViT-L's 16 heads
MAIN = {"encoder": (STEP_BATCH, 160, 12), "decoder": (STEP_BATCH, 1568, 6),
        "backbone": (10, 1568, 12)}  # the finetune backbone's Blocks
CHECKS = {**MAIN, "ragged": (8, 100, 2), "frames32_h6": (2, 3136, 6),
          "frames32_h12": (2, 3136, 12), "res384_h12": (1, 4608, 12),
          "vitl_h16": (2, 1568, 16)}
FT_BATCH = 10
# K3: (B, N, H, D); the MCA is the finetune step's own
MH_CHECKS = {"mca": (FT_BATCH, 1568, 3, 256), "h12": (FT_BATCH, 1568, 12, 64),
             "ragged_d256": (4, 100, 1, 256), "ragged_d64": (4, 100, 2, 64),
             "frames32_h12": (2, 3136, 12, 64)}
VITS_BATCH = 32  # B*H = 96 in the ViT-S decoder, as ViT-B's at B=16
# K4: (B, H, N); the runner's decoder is the main path's own
HM_CHECKS = {"runner_decoder": (VITS_BATCH, 3, 1568),
             "tpu_gated": (2, 6, 1568), "ragged": (4, 3, 100),
             "frames32": (2, 6, 3136)}
# K4 at the tiny presets' head dims (32 in the encoders, 16 in the
# decoder): (B*H, N), a long and a ragged one; times at the first, D = 64
# beside them
HM_HEAD_DIMS = (16, 32)
HM_HEAD_DIM_CHECKS = {"long": (4, 1568), "ragged": (4, 200)}
# the geometries at which tiny_debug_step runs K4, (B*H, N, D): B = 8 x 2
# heads, the encoder's 160 visible tokens of 32-dim heads and the decoder's
# 1568 tokens of 16-dim heads
HM_TINY_CHECKS = {"tiny_encoder": (16, 160, 32),
                  "tiny_decoder": (16, 1568, 16)}
# launches of each kernel per step: ViT-B runs K1/K2 in all 16 Blocks; the
# ViT-S decoder's 3 x 64 heads (A = 192) take K4 (its prep pass too) in its
# 4 Blocks
STEP_LAUNCHES = {
    MODEL: {**dict.fromkeys(fa.KERNELS, 0),
            **dict.fromkeys(fa.QKV_KERNELS, 16)},
    VITS_MODEL: {**dict.fromkeys(fa.KERNELS, 0),
                 **dict.fromkeys(fa.QKV_KERNELS, 12),
                 **dict.fromkeys(fa.HM_KERNELS, 4)},
    # the 12 backbone Blocks and the one MCA block
    FINETUNE_MODEL: {**dict.fromkeys(fa.KERNELS, 0),
                     **dict.fromkeys(fa.QKV_KERNELS, 12),
                     **dict.fromkeys(fa.MH_KERNELS, 1)},
}
# an eval call (validation or a test view) runs the forwards only
EVAL_LAUNCHES = {FINETUNE_MODEL: {**dict.fromkeys(fa.KERNELS, 0),
                                  "qkv_attn_fwd": 12, "mh_attn_fwd": 1}}
# the runner's flags; --warmup_epochs 1 because the default 40 warm-up
# epochs do not fit a 2-epoch cosine schedule
RUNNER_ARGS = ["--model", VITS_MODEL, "--synthetic", "64", "--batch_size",
               str(VITS_BATCH), "--steps_per_epoch", "2", "--save_ckpt_freq",
               "1", "--warmup_epochs", "1"]
# the finetune runner's flags: 40 clips at B=10, 4 steps an epoch; the
# reference's --save_ckpt_freq (10), --test_num_segment (2) and
# --test_num_crop (3) defaults
FT_RUNNER_CLIPS = 40
FT_RUNNER_ARGS = ["--synthetic", str(FT_RUNNER_CLIPS), "--batch_size",
                  str(FT_BATCH), "--warmup_epochs", "1"]
DECODE_HW = (256, 320)  # the runners' decoded frames
REAL_CLIPS = 64  # the SSV2-style videos of phase real_data_runner
# the real-data ViT-S pretrain runner's bf16 losses against its f32 run's, on
# frames without a near-flat patch (a bf16 fault there reads 1e3-1e7 x)
PRETRAIN_F32_RTOL = 0.05
FINAL_TEST = re.compile(r"Final test: Acc@1 ([\d.]+) Acc@5 ([\d.]+) "
                        r"\(([\d.]+) s\)")
D = fa.HEAD_DIM
SCALE = D ** -0.5
# a bf16 step through the kernels against the same step through the plain
# bf16 versions: loss and gradient norm, relative. The plain versions repeat
# the kernels' roundings, so the two differ by the order of their f32 sums:
# at most 8.4e-5 (a gradient norm) when the bound was set, far below the 1%
# by which a bf16 loss sits off the f32 one
BF16_STEP_RTOL = 1e-3
# DDP at world 1 against the same step without it: the same kernels on the
# same tensors, gradients divided by a world of 1, so bits are expected
DDP_STEP_RTOL = 1e-6
# two ranks against one process at G' in f32: losses and gradient norms
# (the ranks' sums taken in another order), parameters and per-view logits
DDP_F32_RTOL = 1e-5
DDP_F32_ATOL = 1e-5
# ViT-S runner through the launcher: one epoch of 2 steps, then a second;
# the BB-focused finetune runner: 20 clips at B=10, one epoch
DDP_RUNNER_ARGS = ["--model", VITS_MODEL, "--synthetic", "64",
                   "--batch_size", str(VITS_BATCH), "--save_ckpt_freq", "1",
                   "--warmup_epochs", "0"]
DDP_FT_CLIPS = 20
DDP_FT_ARGS = ["--synthetic", str(DDP_FT_CLIPS), "--batch_size",
               str(FT_BATCH), "--epochs", "1", "--warmup_epochs", "0"]
# the factory: 8 videos, TV-L1 on the card against the CPU on two pairs (the
# same elementwise ops in the same order on both devices, each rounding
# alike, op_roundings shows it: bits are expected, the bounds are the ones
# the slice was specified with), batched against one call a pair (the same
# ops on the same values), the boxes of --device cuda against --device cpu
# (a uint8 map level may flip)
FACTORY_VIDEOS = 8
FACTORY_BATCH = 4
FLOW_CPU_MAX = 1e-3
FLOW_CPU_P99 = 1e-4
BATCHED_ATOL = 1e-5
FACTORY_BOX_PX = 2
# vis in f32: the card's reconstruction against the CPU's, pixels in [0, 1]
# (attention_vis: its maps, scaled to a max of 1)
VIS_ATOL = 1e-4
# the tiny preset at 224^2 and 16 frames: every Block takes K4, the
# encoder's 2 on 160 visible tokens with 2 x 32 heads, the decoder's 4 on
# 1568 tokens with 2 x 16 heads
TINY_MODEL = "pretrain_videomae_tiny_debug"
TINY_BATCH = 8
TINY_BLOCKS = 6
# the f32 steps' bound, card against the plain versions (phase parity's)
F32_STEP_RTOL = 1e-4
DROP = 0.1
# attention dropout takes the plain head-major math, whose f32
# probabilities (B, 12, 1568, 1568) every Block keeps for its backward
ATTN_DROP_BATCH = 2
# how far a dropout run's kept share may lie from 1 - DROP
KEEP_SHARE_ATOL = 1e-3
VIS_MODEL = "vit_base_patch16_224"
VIS_METHODS = ("grad", "rollout", "gradcam", "gradcam++")
VIS_LAYER = 5  # attention_vis's default Grad-CAM target Block
# the factory on a 1080p video whose square moves rigidly: 15 pairs, at
# most CHUNK_PAIRS a call under the forced budget (3 calls)
CHUNK_HW = (1080, 1920)
CHUNK_FRAMES = 16
CHUNK_PAIRS = 5
SQUARE = 360
SQUARE_STEP = (6, 4)  # px a frame, (x, y)
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")
    return smi


def phase_build() -> None:
    """Builds the sources (one nvcc per source, in parallel); reports each
    kernel instance's registers and spills (ptxas -v)."""
    info = _build.build()
    _build.load()
    ptxas, name = {}, None
    for line in info["report"].splitlines():
        if "(C7517)" in line:  # names its function; precedes the entries
            ptxas.setdefault(line.split("'")[1], []).append(
                line.split(" in function")[0].strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.strip())
    emit("build", seconds=info["seconds"], cached=info["cached"],
         library=info["path"], sources=list(_build.SOURCES), ptxas=ptxas)


def _qkv(B, N, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * H * D, generator=g).to(dtype).cuda()


def check_kernels(x, H, scale: float = SCALE) -> dict:
    """Each kernel against its plain version on qkv x (main_path's bounds;
    raises beyond them), in bf16 the backward's prep pass too. The same
    bounds must reject two planted faults, dQ zeroed and dK without its
    1/log2(e) fix."""
    got, want = attention_against_plain(x, H, scale)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    if x.dtype == torch.bfloat16:
        res["prep"] = check_prep(x, got["out"], (2 * got["out"].float()).to(
            x.dtype), H, scale)
    res["planted"] = {}
    for fault, outputs in planted_faults(got).items():
        caught = compare_with_plain(outputs, want)
        if not caught["beyond_bounds"]:
            raise AssertionError(f"the bounds let a planted fault pass: "
                                 f"{fault}")
        res["planted"][fault] = {
            "beyond_bounds": caught["beyond_bounds"],
            "max_abs_err": {k: caught["max_abs_err"][k] for k in ("dq", "dk")},
        }
    return res


def time_ms(fn, runs: int = 5, warmup: int = 3, run_ms: float = 20.0,
            max_reps: int = 200) -> float:
    """Milliseconds per call: after `warmup` calls, `runs` runs of R
    back-to-back calls, each run between two CUDA events, divided by R; the
    median of the runs. R fills about `run_ms` per run (one synchronized call
    sizes it), so the host's launch time overlaps the device's work as it
    does in a step."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    reps = max(1, min(max_reps, int(run_ms / max(once, 1e-3))))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def least_times(work: dict) -> dict:
    """name -> (least ms, what bounds it) for name -> (FLOPs, bytes)."""
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def bounds(B, N, H) -> dict:
    """Least time (ms) for each kernel's work on an H100 SXM: the larger of
    its FLOPs over the bf16 tensor peak and its bytes (each input read once,
    each output written once) over HBM bandwidth."""
    e, A = 2, H * D
    mm = 2 * B * H * N * N * D  # one (N x N x D) product
    qkv, row = B * N * 3 * A * e, B * N * A * e
    stat = B * H * N * 4
    work = {
        "qkv_attn_fwd": (2 * mm, qkv + row + stat),  # S, P.V -> out, lse
        # q, out, dout -> q * scale, delta
        "qkv_attn_bwd_prep": (2 * B * N * A + B * N * A, 3 * row + row + stat),
        # k, v, q * scale, dout, lse, delta -> dk, dv
        "qkv_attn_bwd_dkv": (4 * mm, 4 * row + 2 * stat + 2 * row),
        "qkv_attn_bwd_dq": (3 * mm, 4 * row + 2 * stat + row),  # -> dq
    }
    return least_times(work)


def time_kernels(x, H) -> dict:
    """kernel, plain, library and bound times (ms) on bf16 qkv x."""
    dtype = x.dtype
    B, N, _ = x.shape
    out, lse = fa.qkv_attn_fwd(x, SCALE, H)
    dout = (2 * out.float()).to(dtype)
    dqkv = torch.empty_like(x)
    q, k, v = (t.contiguous().requires_grad_(True)
               for t in fa.split_heads(x, H))
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)
    g_lib = dout.reshape(B, N, H, D).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_qkv_bwd_plain(
        x, out, lse, dout, SCALE, H), runs=10)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (q, k, v), g_lib, retain_graph=True))
    prep = fa.qkv_attn_bwd_prep(x, out, dout, SCALE, H)
    res = {
        "qkv_attn_fwd": {
            "ms": time_ms(lambda: fa.qkv_attn_fwd(x, SCALE, H)),
            "plain_ms": time_ms(
                lambda: fa.attention_qkv_fwd_plain(x, SCALE, H), runs=10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q.detach(), k.detach(), v.detach(), scale=SCALE)),
        },
        # no one library call computes delta and the scaled q alone
        "qkv_attn_bwd_prep": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_prep(
                x, out, dout, SCALE, H)),
            "plain_ms": time_ms(lambda: fa.attention_qkv_bwd_prep_plain(
                x, out, dout, SCALE, H)),
            "library_ms": None,
        },
        "qkv_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dkv(
                x, out, lse, dout, dqkv, SCALE, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "qkv_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dq(
                x, out, lse, dout, dqkv, SCALE, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds(B, N, H).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def phase_kernels():
    """Checks every fused-qkv kernel at the steps' shapes (and a ragged
    one) in bf16 and f32, and times them, in bf16, on the very qkv that was
    checked."""
    errors, timings = {}, {}
    for i, (geo, (B, N, H)) in enumerate(CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = _qkv(B, N, H, dtype, seed=i)
            res = check_kernels(x, H)
            emit("kernels_vs_plain", geometry=geo, B=B, N=N, H=H,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if dtype == torch.bfloat16 and geo in MAIN:
                err = res["max_abs_err"]
                errors[geo] = {"qkv_attn_fwd": err["out"],
                               "qkv_attn_bwd_prep": res["prep"]["max_abs_err"],
                               "qkv_attn_bwd_dkv": max(err["dk"], err["dv"]),
                               "qkv_attn_bwd_dq": err["dq"]}
                timings[geo] = time_kernels(x, H)
                emit("kernel_times", geometry=geo, B=B, N=N, H=H,
                     dtype="bfloat16", times=timings[geo])
            del x
    # a scale that is not a power of two: dQ reads its own scaled K copy
    B, N, H = CHECKS["ragged"]
    for dtype in (torch.bfloat16, torch.float32):
        emit("kernels_vs_plain", geometry="ragged", B=B, N=N, H=H, scale=0.1,
             dtype=str(dtype).replace("torch.", ""),
             **check_kernels(_qkv(B, N, H, dtype, seed=7), H, 0.1))
    emit("k1_fwd_vs_library", **{
        geo: t["qkv_attn_fwd"]["ms"] / t["qkv_attn_fwd"]["library_ms"]
        for geo, t in timings.items()})
    emit("k2_vs_library", **{
        geo: (t["qkv_attn_bwd_prep"]["ms"] + t["qkv_attn_bwd_dkv"]["ms"]
              + t["qkv_attn_bwd_dq"]["ms"]) / t["qkv_attn_bwd_dq"]
        ["library_ms"] for geo, t in timings.items()})
    return errors, timings


def bounds_mh(B, N, H, D) -> dict:
    """bounds() for the K3 kernels: separate q, k, v (each read once), the
    bias row, and the backward's delta; the work at its least (the dK/dV
    kernel's recomputed products not counted)."""
    e, A = 2, H * D
    mm = 2 * B * H * N * N * D
    row, stat = B * N * A * e, B * H * N * 4
    inputs = 3 * row + B * N * 4  # q, k, v, bias
    work = {
        "mh_attn_fwd": (2 * mm, inputs + row + stat),  # -> out, lse
        # q, out, dout -> q * scale, delta
        "mh_attn_bwd_prep": (3 * B * N * A, 3 * row + row + stat),
        # + dout, lse, delta -> dk, dv
        "mh_attn_bwd_dkv": (4 * mm, inputs + row + 2 * stat + 2 * row),
        "mh_attn_bwd_dq": (3 * mm, inputs + row + 2 * stat + row),
    }
    return least_times(work)


def time_mh_kernels(q, k, v, b, H, D) -> dict:
    """kernel, plain, library and bound times (ms) of K3 on bf16 inputs."""
    scale = D ** -0.5
    B, N, _ = q.shape
    out, lse = fa.mh_attn_fwd(q, k, v, b, scale, H)
    dout = (2 * out.float()).to(q.dtype)
    prep = fa.mh_attn_bwd_prep(q, k, out, dout, scale, H)
    dkv = torch.empty(B, N, 2 * H * D, dtype=q.dtype, device=q.device)
    dq = torch.empty_like(q)
    heads = [t.reshape(B, N, H, D).transpose(1, 2).contiguous()
             .requires_grad_(True) for t in (q, k, v)]
    mask = b[:, None, None, :].to(q.dtype)
    o_lib = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                           scale=scale)
    g_lib = dout.reshape(B, N, H, D).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_mh_bwd_plain(
        q, k, v, b, out, lse, dout, scale, H), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "mh_attn_fwd": {
            "ms": time_ms(lambda: fa.mh_attn_fwd(q, k, v, b, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_mh_fwd_plain(
                q, k, v, b, scale, H), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), attn_mask=mask, scale=scale)),
        },
        # no one library call computes delta and the scaled q alone
        "mh_attn_bwd_prep": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_prep(
                q, k, out, dout, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_mh_bwd_prep_plain(
                q, k, out, dout, scale, H)),
            "library_ms": None,
        },
        "mh_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dkv(
                q, k, v, b, out, lse, dout, dkv[..., :H * D],
                dkv[..., H * D:], scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "mh_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dq(
                q, k, v, b, out, lse, dout, dq, scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds_mh(B, N, H, D).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def check_mh_kernels(q, k, v, b, H, scale: float) -> dict:
    """check_kernels for K3 on q, k, v and the bias row b (or None): the
    bounds, in bf16 the backward's prep pass too, the planted faults (with a
    bias also the kernels' outputs without it) rejected, and masked kv rows
    with exactly zero dK/dV."""
    got, want = mh_attention_against_plain(q, k, v, b, H, scale)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    if q.dtype == torch.bfloat16:
        res["prep"] = check_mh_prep(q, k, got["out"], (
            2 * got["out"].float()).to(q.dtype), H, scale)
    ignored = None
    if b is not None:
        ignored, _ = mh_attention_against_plain(q, k, v, None, H, scale)
    res["planted"] = {}
    for fault, outputs in planted_faults(got, ignored).items():
        caught = compare_with_plain(outputs, want)
        if not caught["beyond_bounds"]:
            raise AssertionError(f"the bounds let a planted fault pass: "
                                 f"{fault}")
        res["planted"][fault] = caught["beyond_bounds"]
    res["masked_kv_grad"] = masked_kv_grad(got, b)
    if res["masked_kv_grad"] != 0.0:
        raise AssertionError(f"masked kv rows got dK/dV: {res}")
    return res


def phase_mh_kernels():
    """K3 against its plain version at every MH_CHECKS geometry, bf16 and
    f32, bias present and absent (check_mh_kernels); the ragged ones again
    at scale 0.1. Times at the MCA."""
    errors, timings = {}, {}
    for i, (geo, (B, N, H, D)) in enumerate(MH_CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            for bias in (True, False):
                q, k, v, b = mh_inputs(B, N, H, D, dtype, i, "cuda", bias)
                res = check_mh_kernels(q, k, v, b, H, D ** -0.5)
                emit("mh_kernels_vs_plain", geometry=geo, B=B, N=N, H=H, D=D,
                     dtype=str(dtype).replace("torch.", ""), bias=bias,
                     **res)
                if geo == "mca" and dtype == torch.bfloat16 and bias:
                    err = res["max_abs_err"]
                    errors = {"mh_attn_fwd": err["out"],
                              "mh_attn_bwd_prep": res["prep"]["max_abs_err"],
                              "mh_attn_bwd_dkv": max(err["dk"], err["dv"]),
                              "mh_attn_bwd_dq": err["dq"]}
                    timings = time_mh_kernels(q, k, v, b, H, D)
                    emit("mh_kernel_times", geometry=geo, B=B, N=N, H=H,
                         D=D, dtype="bfloat16", bias=True, times=timings)
                    emit("k3_fwd_vs_library", **{
                        geo: timings["mh_attn_fwd"]["ms"]
                        / timings["mh_attn_fwd"]["library_ms"]})
                    emit("k3_bwd_vs_library", **{geo: sum(
                        timings[n]["ms"] for n in fa.MH_KERNELS[1:])
                        / timings["mh_attn_bwd_dq"]["library_ms"]})
                del q, k, v, b
    # a scale that is not a power of two: at head dim 64 dQ reads the prep
    # pass's scaled K copy, at 256 it folds the scale into its K strip
    for geo in ("ragged_d64", "ragged_d256"):
        B, N, H, D = MH_CHECKS[geo]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, b = mh_inputs(B, N, H, D, dtype, 7, "cuda")
            res = check_mh_kernels(q, k, v, b, H, 0.1)
            if dtype == torch.bfloat16 and res["prep"]["ks"] is not (
                    True if D == fa.HEAD_DIM else None):
                raise AssertionError(f"the scaled K copy at D={D}: {res}")
            emit("mh_kernels_vs_plain", geometry=geo, B=B, N=N, H=H, D=D,
                 scale=0.1, dtype=str(dtype).replace("torch.", ""),
                 bias=True, **res)
    return errors, timings


def phase_step(smi: str, phase: str = "step", model_name: str = MODEL,
               B: int = STEP_BATCH) -> dict:
    """A full-width MOFO pretrain step on the card (ViT-B by default): 1
    warm-up + 5 timed steps, every kernel's launches checked exactly
    against STEP_LAUNCHES."""
    model, state, step, gen, batch = build_step(B, model_name)
    named = dict(model.named_parameters())
    watched = ["encoder.blocks.0.attn.qkv.weight",
               "decoder.blocks.3.mlp.fc2.weight", "mask_token"]
    before = {n: named[n].detach().clone() for n in watched}
    blocks = len(model.encoder.blocks) + len(model.decoder.blocks)
    per_step = STEP_LAUNCHES[model_name]

    n_steps = 6  # 1 warm-up + 5 timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0.5)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.launch_counts)

    expected = {k: n_steps * v for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss/grad_norm {losses} {norms}")
    unchanged = [n for n in watched if torch.equal(before[n], named[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    step_ms = statistics.median(times[1:])
    emit(phase, model=model_name, dtype="bfloat16", batch=B, blocks=blocks,
         steps=n_steps, step_ms=step_ms, step_ms_all=times,
         clips_per_s=B / step_ms * 1e3, loss=losses, grad_norm=norms,
         launches=launches, launches_per_step=per_step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return launches


def phase_parity(phase: str = "parity", model_name: str = MODEL,
                 kernels=fa.QKV_F32_KERNELS) -> None:
    """Card (kernels) against CPU (plain versions) at full width, cut to
    2+1 blocks, f32, B=1; each of `kernels` must have run on the card."""
    cfg = PretrainConfig(model=model_name, batch_size=1, dtype="float32",
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True)
    gen = torch.Generator().manual_seed(7)
    batch = synthetic_batch(1, gen, "cpu")
    mask = masking.motion_tube_mask(batch["boxes"], generator=gen)
    lr = np.full(4, 1e-4, np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        model = create_model(model_name, device=dev, seed=5, encoder_depth=2,
                             decoder_depth=1)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr,
                                    betas=(0.9, 0.95), weight_decay=0.05)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, metrics = step(TrainState.create(model, tx),
                          {k: v.to(dev) for k, v in batch.items()}, None,
                          0.5, mask=mask.to(dev))
        results[dev] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        results[dev]["launches"] = dict(fa.launch_counts)
    if min(results["cuda"]["launches"][k] for k in kernels) < 1:
        raise AssertionError(f"the card run skipped a kernel: {results}")
    rel = {k: abs(results["cuda"][k] - results["cpu"][k])
           / abs(results["cpu"][k]) for k in ("loss", "grad_norm")}
    emit(phase, model=model_name, depth="2+1", dtype="float32", batch=1,
         results=results, rel_diff=rel, bound=1e-4)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU beyond rtol 1e-4: {rel}")


def phase_finetune_step(smi: str):
    """The full-width ViT-B BB-focused MCA finetune step on the card, then
    one eval call. Returns the launches, the median step time (ms) and the
    first step's loss."""
    B = FT_BATCH
    model, state, step, gen, batch, cfg = build_finetune_step(B)
    named = dict(model.named_parameters())
    watched = ["backbone.blocks.0.attn.qkv.weight",
               "local_MCA.0.attn.q.weight", "head.weight"]
    before = {n: named[n].detach().clone() for n in watched}
    blocks = len(model.backbone.blocks)
    mca = len(model.local_MCA)

    n_steps = 6  # 1 warm-up + 5 timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times, losses, norms = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.launch_counts)
    expected = {k: n_steps * v
                for k, v in STEP_LAUNCHES[FINETUNE_MODEL].items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss/grad_norm {losses} {norms}")
    unchanged = [n for n in watched if torch.equal(before[n], named[n])]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    fa.reset_launch_counts()
    ev = make_eval_step(model, cfg, bb_focused=True)(batch)
    torch.cuda.synchronize()
    eval_launches = dict(fa.launch_counts)
    want_eval = EVAL_LAUNCHES[FINETUNE_MODEL]
    if eval_launches != want_eval:
        raise AssertionError(f"eval launches {eval_launches}, expected "
                             f"{want_eval}")
    if ev["logits"].shape != (B, cfg.nb_classes) or not all(
            np.isfinite(float(ev[k])) for k in ("loss", "acc1", "acc5")):
        raise AssertionError(f"bad eval output: {ev}")
    step_ms = statistics.median(times[1:])
    emit("finetune_step", model=FINETUNE_MODEL, fusing="MCA",
         dtype="bfloat16", batch=B, blocks=blocks, mca_blocks=mca,
         mixup=cfg.mixup, cutmix=cfg.cutmix, smoothing=cfg.smoothing,
         drop_path=cfg.drop_path, layer_decay=cfg.optimizer.layer_decay,
         steps=n_steps, step_ms=step_ms, step_ms_all=times,
         clips_per_s=B / step_ms * 1e3, loss=losses, grad_norm=norms,
         launches=launches, launches_per_step={
             k: v / n_steps for k, v in launches.items()},
         eval_launches=eval_launches,
         eval={k: float(ev[k]) for k in ("loss", "acc1", "acc5")},
         peak_mem_gib=peak, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return launches, step_ms, losses[0]


def phase_finetune_parity() -> None:
    """BB-focused MCA at ViT-B width, 2 Blocks, f32, B=2: card (kernels)
    against CPU (plain versions), same weights and mixup draws."""
    cfg = FinetuneConfig(batch_size=2, dtype="float32", drop_path=0.0,
                         model=FINETUNE_MODEL)
    gen = torch.Generator().manual_seed(9)
    batch = synthetic_finetune_batch(2, gen, "cpu", cfg.nb_classes)
    batch["boxes"][0] = torch.tensor([300.0, 300.0, 330.0, 330.0])  # no in
    batch["boxes"][1] = torch.tensor([0.0, 0.0, 224.0, 224.0])  # no out
    mix = mixup_for(cfg)
    draws = mix.sample(np.random.default_rng(1), mix.count(2), 224, 224)
    lr = np.full(4, 1e-4, np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        model = finetune_model(cfg, device=dev, seed=5, depth=2)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr,
                                    weight_decay=0.05, layer_decay=0.75)
        step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                                  device=dev)
        fa.reset_launch_counts()
        _, metrics = step(TrainState.create(model, tx),
                          {k: v.to(dev) for k, v in batch.items()}, None,
                          draws)
        results[dev] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        results[dev]["launches"] = dict(fa.launch_counts)
    if min(results["cuda"]["launches"][k]
           for k in fa.QKV_F32_KERNELS + fa.MH_F32_KERNELS) < 1:
        raise AssertionError(f"the card run skipped a kernel: {results}")
    rel = {k: abs(results["cuda"][k] - results["cpu"][k])
           / abs(results["cpu"][k]) for k in ("loss", "grad_norm")}
    emit("finetune_parity", model=FINETUNE_MODEL, fusing="MCA", depth=2,
         dtype="float32", batch=2, results=results, rel_diff=rel,
         bound=1e-4)
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU beyond rtol 1e-4: {rel}")


def phase_bf16_steps() -> None:
    """The bf16 steps on the card through the kernels against the same
    steps through the plain bf16 versions on the same CUDA tensors: ViT-B
    and ViT-S pretrain (2+1 Blocks) and the ViT-B BB-focused MCA finetune
    step (2 Blocks + the MCA), full width, B=2, two steps each from the
    same weights, masks, mixup and drop-path draws. The second step's loss
    also holds the first step's gradients."""
    n_steps, B = 2, 2
    for which in ("pretrain", "vits_pretrain", "finetune"):
        runs = {}
        for route in ("kernels", "plain"):
            plain = route == "plain"
            if which == "finetune":
                _, state, step, gen, batch, _ = build_finetune_step(
                    B, plain=plain, depth=2)
                extra = ()
                per_step = {**dict.fromkeys(fa.QKV_KERNELS, 2),
                            **dict.fromkeys(fa.MH_KERNELS, 1)}
            else:
                vits = which == "vits_pretrain"
                _, state, step, gen, batch = build_step(
                    B, VITS_MODEL if vits else MODEL, plain=plain,
                    encoder_depth=2, decoder_depth=1)
                extra = (0.5,)
                per_step = {**dict.fromkeys(fa.QKV_KERNELS, 2 if vits else 3),
                            **dict.fromkeys(fa.HM_KERNELS, int(vits))}
            fa.reset_launch_counts()
            metrics = []
            for _ in range(n_steps):
                state, m = step(state, batch, gen, *extra)
                metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            torch.cuda.synchronize()
            want = {**dict.fromkeys(fa.KERNELS, 0),
                    **({} if plain else {k: n_steps * v
                                         for k, v in per_step.items()})}
            if fa.launch_counts != want:
                raise AssertionError(f"{which} through the {route}: launches "
                                     f"{fa.launch_counts}, expected {want}")
            runs[route] = metrics
            del state, step, batch
        rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
               for a, b in zip(runs["kernels"], runs["plain"])]
        emit("bf16_step_vs_plain", step=which, dtype="bfloat16", batch=B,
             steps=n_steps, **runs, rel_diff=rel, bound=BF16_STEP_RTOL)
        if not max(max(r.values()) for r in rel) <= BF16_STEP_RTOL:
            raise AssertionError(f"{which}: kernels vs plain versions beyond "
                                 f"rtol {BF16_STEP_RTOL}: {rel}")


def bounds_hm(BH, N, D) -> dict:
    """bounds() for the K4 kernels on (BH, N, D) q, k, v (each read once),
    the LSE and the backward's delta; the work at its least (the forward's
    second score product and the dK/dV kernel's recomputed ones not
    counted)."""
    mm = 2 * BH * N * N * D
    row, stat = BH * N * D * 2, BH * N * 4
    return least_times({
        "hm_attn_fwd": (2 * mm, 3 * row + row + stat),  # -> out, lse
        # q, out, dout -> q * scale, delta
        "hm_attn_bwd_prep": (3 * BH * N * D, 3 * row + row + stat),
        # k, v, q * scale, dout, lse, delta -> dk, dv
        "hm_attn_bwd_dkv": (4 * mm, 4 * row + 2 * stat + 2 * row),
        "hm_attn_bwd_dq": (3 * mm, 4 * row + 2 * stat + row),  # -> dq
    })


def time_hm_kernels(q, k, v, B, H) -> dict:
    """kernel, plain, library and bound times (ms) of K4 on bf16 (B*H, N,
    D) inputs."""
    BH, N, D = q.shape
    scale = D ** -0.5
    out, lse = fa.hm_attn_fwd(q, k, v, scale)
    dout = (2 * out.float()).to(q.dtype)
    prep = fa.hm_attn_bwd_prep(q, k, out, dout, scale)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    heads = [t.reshape(B, H, N, D).clone().requires_grad_(True)
             for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*heads, scale=scale)
    g_lib = dout.reshape(B, H, N, D)
    plain_bwd = time_ms(lambda: fa.attention_hm_bwd_plain(
        q, k, v, out, lse, dout, scale), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "hm_attn_fwd": {
            "ms": time_ms(lambda: fa.hm_attn_fwd(q, k, v, scale)),
            "plain_ms": time_ms(lambda: fa.attention_hm_fwd_plain(
                q, k, v, scale), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), scale=scale)),
        },
        # no one library call computes delta and the scaled q alone
        "hm_attn_bwd_prep": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_prep(q, k, out, dout,
                                                      scale)),
            "plain_ms": time_ms(lambda: fa.attention_hm_bwd_prep_plain(
                q, k, out, dout, scale)),
            "library_ms": None,
        },
        "hm_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dkv(
                q, k, v, out, lse, dout, dk, dv, scale, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "hm_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dq(
                q, k, v, out, lse, dout, dq, scale, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    for name, (bound, by) in bounds_hm(BH, N, D).items():
        res[name].update(bound_ms=bound, bound_by=by)
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def k1_vs_k4(B, H, N, dtype) -> dict:
    """The K1/K2 kernels and the K4 kernels on the same q, k, v (and the
    same dout): how far the two numerics lie apart (max |K1 - K4| of out,
    dq, dk, dv, each beside its max |K4|)."""
    x = _qkv(B, N, H, dtype, seed=11)
    out1, lse1 = fa.qkv_attn_fwd(x, SCALE, H)
    dout = torch.randn(out1.shape, generator=torch.Generator().manual_seed(
        12)).to(dtype).cuda()
    dqkv = fa.qkv_attn_bwd(x, out1, lse1, dout, SCALE, H)
    q, k, v = (t.reshape(B * H, N, D).contiguous()
               for t in fa.split_heads(x, H))
    to_hm = lambda t: t.reshape(B, N, H, D).transpose(1, 2).reshape(  # noqa
        B * H, N, D).contiguous()
    out4, lse4 = fa.hm_attn_fwd(q, k, v, SCALE)
    grads4 = fa.hm_attn_bwd(q, k, v, out4, lse4, to_hm(dout), SCALE)
    A = H * D
    k1 = {"out": out1, "dq": dqkv[..., :A], "dk": dqkv[..., A:2 * A],
          "dv": dqkv[..., 2 * A:]}
    back = lambda t: t.reshape(B, H, N, D).transpose(1, 2).reshape(  # noqa
        B, N, A)
    k4 = {"out": back(out4), **{n: back(g) for n, g in
                                zip(("dq", "dk", "dv"), grads4)}}
    torch.cuda.synchronize()
    return {n: {"max_abs_diff": (k1[n].float() - k4[n].float()).abs().max()
                .item(),
                "max_abs_k4": k4[n].float().abs().max().item(),
                "share_differing": (k1[n] != k4[n]).float().mean().item()}
            for n in k1}


def check_hm_kernels(q, k, v, scale: float = SCALE) -> dict:
    """check_kernels for K4 on (B*H, N, D) q, k, v: the planted faults are
    dQ zeroed and the LSE in log2 units."""
    got, want = hm_attention_against_plain(q, k, v, scale)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    if q.dtype == torch.bfloat16:
        res["prep"] = check_hm_prep(q, k, got["out"], (
            2 * got["out"].float()).to(q.dtype), scale)
    res["planted"] = {}
    for fault, outputs in hm_planted_faults(got).items():
        caught = compare_with_plain(outputs, want)
        if not caught["beyond_bounds"]:
            raise AssertionError(f"the bounds let a planted fault pass: "
                                 f"{fault}")
        res["planted"][fault] = caught["beyond_bounds"]
    return res


def phase_hm_kernels():
    """K4 against its plain version at every HM_CHECKS geometry, bf16 and
    f32 (in bf16 the prep pass too): main_path's bounds, the planted faults
    rejected; the ragged one again at scale 0.1. Times at the runner's
    decoder shape, and K1's numerics against K4's there."""
    errors, timings = {}, {}
    for i, (geo, (B, H, N)) in enumerate(HM_CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = hm_inputs(B * H, N, dtype, i, "cuda")
            res = check_hm_kernels(q, k, v)
            emit("hm_kernels_vs_plain", geometry=geo, B=B, H=H, N=N, D=D,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if geo == "runner_decoder" and dtype == torch.bfloat16:
                err = res["max_abs_err"]
                errors = {"hm_attn_fwd": err["out"],
                          "hm_attn_bwd_prep": res["prep"]["max_abs_err"],
                          "hm_attn_bwd_dkv": max(err["dk"], err["dv"]),
                          "hm_attn_bwd_dq": err["dq"]}
                timings = time_hm_kernels(q, k, v, B, H)
                emit("hm_kernel_times", geometry=geo, B=B, H=H, N=N, D=D,
                     dtype="bfloat16", times=timings,
                     fwd_vs_library=timings["hm_attn_fwd"]["ms"]
                     / timings["hm_attn_fwd"]["library_ms"])
                emit("k4_bwd_vs_library", **{geo: sum(
                    timings[n]["ms"] for n in fa.HM_KERNELS[1:])
                    / timings["hm_attn_bwd_dq"]["library_ms"]})
            del q, k, v
    # a scale that is not a power of two: dQ reads its own scaled K copy
    B, H, N = HM_CHECKS["ragged"]
    for dtype in (torch.bfloat16, torch.float32):
        emit("hm_kernels_vs_plain", geometry="ragged", B=B, H=H, N=N, D=D,
             scale=0.1, dtype=str(dtype).replace("torch.", ""),
             **check_hm_kernels(*hm_inputs(B * H, N, dtype, 7, "cuda"), 0.1))
    B, H, N = HM_CHECKS["runner_decoder"]
    emit("k1_vs_k4", B=B, H=H, N=N, D=D,
         **{str(dt).replace("torch.", ""): k1_vs_k4(B, H, N, dt)
            for dt in (torch.bfloat16, torch.float32)})
    return errors, timings


def phase_hm_head_dims(smi: str) -> dict:
    """K4's four entry points at head dims 16 and 32 against their plain
    versions (check_hm_kernels' bounds and planted faults; the scale
    D^-0.5, which at 32 is no power of two: dQ's scaled-K copy) at
    HM_HEAD_DIM_CHECKS and at tiny_debug_step's own HM_TINY_CHECKS, bf16
    and f32; then kernel, plain, library and
    bound times at the long geometry in bf16 for D = 16, 32 and 64.
    Returns {D: (max errors, times)} for D = 16 and 32."""
    out = {}
    for hd in HM_HEAD_DIMS:
        errors = {}
        for i, (geo, (BH, N)) in enumerate(HM_HEAD_DIM_CHECKS.items()):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = hm_inputs(BH, N, dtype, hd + i, "cuda", D=hd)
                res = check_hm_kernels(q, k, v, hd ** -0.5)
                emit("hm_head_dims_vs_plain", D=hd, geometry=geo, BH=BH,
                     N=N, dtype=str(dtype).replace("torch.", ""), **res)
                if geo == "long" and dtype == torch.bfloat16:
                    err = res["max_abs_err"]
                    errors = {"hm_attn_fwd": err["out"],
                              "hm_attn_bwd_prep": res["prep"]["max_abs_err"],
                              "hm_attn_bwd_dkv": max(err["dk"], err["dv"]),
                              "hm_attn_bwd_dq": err["dq"]}
        out[hd] = errors
    for i, (geo, (BH, N, hd)) in enumerate(HM_TINY_CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = hm_inputs(BH, N, dtype, 40 + i, "cuda", D=hd)
            emit("hm_head_dims_vs_plain", D=hd, geometry=geo, BH=BH, N=N,
                 dtype=str(dtype).replace("torch.", ""),
                 **check_hm_kernels(q, k, v, hd ** -0.5))
    BH, N = HM_HEAD_DIM_CHECKS["long"]
    for hd in HM_HEAD_DIMS + (64,):
        q, k, v = hm_inputs(BH, N, torch.bfloat16, 5, "cuda", D=hd)
        times = time_hm_kernels(q, k, v, 1, BH)
        emit("hm_head_dim_times", D=hd, BH=BH, N=N, dtype="bfloat16",
             times=times, nvidia_smi=smi)
        if hd in out:
            out[hd] = (out[hd], times)
    return out


def _runner_log(out: str) -> list:
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _quiet_main(main_fn, args, reader=MemoryReader):
    """Runs an entry point with its stdout kept; printed on a failure."""
    text = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            result = main_fn(args, reader=reader)
        torch.cuda.synchronize()
    except BaseException:
        print(text.getvalue()[-4000:], flush=True)
        raise
    return result, text.getvalue(), time.perf_counter() - t0


def phase_runner(smi: str) -> dict:
    """The main path of this slice: the ViT-S MOFO pretrain runner, 2
    epochs, then resumed for a third."""
    calls = []
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for epochs in (2, 3):
            args = pretrain_mofo.get_args(
                RUNNER_ARGS + ["--epochs", str(epochs), "--output_dir", out],
                mofo_defaults=True)
            t0 = time.perf_counter()
            state = pretrain_mofo.main(args)
            torch.cuda.synchronize()
            calls.append({"epochs": epochs, "steps_after": state.step,
                          "seconds": time.perf_counter() - t0})
        launches = dict(fa.launch_counts)
        log = _runner_log(out)
        ckpts = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
    steps = calls[-1]["steps_after"]
    per_step = {k: v / steps for k, v in launches.items()}
    want = STEP_LAUNCHES[VITS_MODEL]
    if [c["steps_after"] for c in calls] != [4, 6]:
        raise AssertionError(f"the runner took other steps: {calls}")
    if [line["epoch"] for line in log] != [0, 1, 2]:
        raise AssertionError(f"log.txt holds other epochs: {log}")
    if ckpts != [f"checkpoint-{e}.pth" for e in range(3)]:
        raise AssertionError(f"checkpoints {ckpts}")
    if not all(np.isfinite(line["train_loss"]) for line in log):
        raise AssertionError(f"non-finite losses: {log}")
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected {want}")
    emit("runner", model=VITS_MODEL, dtype="bfloat16", batch=VITS_BATCH,
         args=RUNNER_ARGS, calls=calls, launches=launches,
         launches_per_step=per_step,
         epochs=[{k: line[k] for k in ("epoch", "train_loss", "step_s",
                                       "data_wait_s")} for line in log],
         step_ms=[line["step_s"] * 1e3 for line in log],
         loader_wait_ms=[line["data_wait_s"] * 1e3 for line in log],
         checkpoints=ckpts, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return launches


def _equalize_lut_off_by_one(hist, n):
    lut, step = EQUALIZE_LUT(hist, n)
    return torch.cat([lut[..., :1], lut[..., :-1]], dim=-1), step


EQUALIZE_LUT = RA.equalize_lut


def phase_finetune_augment(smi: str, step_ms: float) -> dict:
    """The finetune runner's augmentations on the card against the CPU with
    the same draws (forced_draws), a planted equalize fault, and each
    pipeline's time at B=10."""
    B = FT_BATCH
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = synthetic_clips_u8(B, gen, "cuda", hw=DECODE_HW)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    draws = forced_draws(B, DECODE_HW)

    def pipelines(b, d, g=None):
        return {
            "finetune_augment": lambda: A.finetune_augment(
                g, b["clip"], 224, flip=True, reprob=0.25, boxes=b["boxes"],
                draws=d),
            "eval_augment": lambda: A.eval_augment(b["clip"],
                                                   boxes=b["boxes"]),
            **{f"test_view_augment_{s}": (
                lambda s=s: A.test_view_augment(b["clip"], s,
                                                boxes=b["boxes"]))
               for s in range(3)},
        }

    card = pipelines(batch, moved_draws(draws, "cuda"))
    cpu = {name: fn() for name, fn in pipelines(cpu_batch, draws).items()}
    res = {}
    for name in card:
        got = card[name]()
        torch.cuda.synchronize()
        res[name] = augment_against_cpu(got, cpu[name])
        if not res[name]["share_within"] >= AUG_SHARE:
            raise AssertionError(f"{name}: card vs CPU beyond the bound "
                                 f"({AUG_SHARE} within {AUG_ATOL}): "
                                 f"{res[name]}")
    RA.equalize_lut = _equalize_lut_off_by_one  # on the card only
    try:
        planted = augment_against_cpu(card["finetune_augment"](),
                                      cpu["finetune_augment"])
    finally:
        RA.equalize_lut = EQUALIZE_LUT
    if planted["share_within"] >= AUG_SHARE:
        raise AssertionError(f"the bound let the equalize fault pass: "
                             f"{planted}")
    # times with the draws the runner makes (from the generator)
    timed = pipelines(batch, None, torch.Generator(device="cuda"))
    for name, fn in timed.items():
        res[name]["ms"] = time_ms(fn)
        res[name]["share_of_finetune_step"] = res[name]["ms"] / step_ms
    emit("finetune_augment", batch=B, clips=list(batch["clip"].shape),
         out=224, aa="rand-m7-n4-mstd0.5-inc1", bound={
             "atol": AUG_ATOL, "share": AUG_SHARE},
         pipelines=res, planted_equalize_lut_off_by_one=planted,
         finetune_step_ms=step_ms, nvidia_smi=smi)
    return res


def phase_fp16_finetune_step() -> None:
    """Three fp16 BB-focused MCA finetune steps under the loss scale
    against the same steps in f32, then a step with a non-finite
    gradient."""
    B, n_steps = FT_BATCH, 3
    runs = {}
    for dtype in ("float32", "float16"):
        model, state, step, gen, batch, cfg = build_finetune_step(
            B, dtype=dtype)
        fa.reset_launch_counts()
        metrics = []
        for _ in range(n_steps):
            state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        runs[dtype] = {"metrics": metrics, "launches": dict(fa.launch_counts)}
        if dtype == "float32":
            del model, state, step
    per_step = STEP_LAUNCHES[FINETUNE_MODEL]
    want = {"float16": {k: n_steps * v for k, v in per_step.items()},
            "float32": {k: (n_steps * v if k in fa.QKV_F32_KERNELS
                            + fa.MH_F32_KERNELS else 0)
                        for k, v in per_step.items()}}
    for dtype, run in runs.items():
        if run["launches"] != want[dtype]:
            raise AssertionError(f"{dtype}: launches {run['launches']}, "
                                 f"expected {want[dtype]}")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(runs["float16"]["metrics"],
                           runs["float32"]["metrics"])]
    if not max(rel) <= 0.01:
        raise AssertionError(f"fp16 losses beyond 1% of f32: {rel}")
    if any(m["loss_scale"] != 128.0 or m["skipped"] != 0.0
           for m in runs["float16"]["metrics"]):
        raise AssertionError(f"fp16 steps: {runs['float16']['metrics']}")

    # a non-finite gradient: one clip scaled to inf
    bad = dict(batch, clip=batch["clip"].clone())
    bad["clip"][0] *= float("inf")
    opt = state.opt_state
    before = {"params": {n: p.detach().clone()
                         for n, p in state.params.items()},
              "mu": {n: t.clone() for n, t in opt.mu.items()},
              "nu": {n: t.clone() for n, t in opt.nu.items()}}
    count, step_before = opt.count, state.step
    state, m = step(state, bad, gen)
    skip = {k: float(v) for k, v in m.items()}
    changed = [f"{part}:{n}" for part, now in (
        ("params", state.params), ("mu", opt.mu), ("nu", opt.nu))
        for n, t in now.items() if not torch.equal(t.detach(),
                                                   before[part][n])]
    emit("fp16_finetune_step", model=FINETUNE_MODEL, batch=B, steps=n_steps,
         float16=runs["float16"]["metrics"],
         float32=runs["float32"]["metrics"], loss_rel_diff=rel, bound=0.01,
         launches={k: r["launches"] for k, r in runs.items()},
         skipped_step=skip, changed_by_skipped_step=changed,
         count=[count, opt.count], step=[step_before, state.step])
    if skip["skipped"] != 1.0 or skip["loss_scale"] != 64.0 or \
            state.loss_scale.scale != 64.0:
        raise AssertionError(f"the non-finite step was not skipped: {skip}")
    if changed or opt.count != count or state.step != step_before + 1:
        raise AssertionError(f"the skipped step changed the state: "
                             f"{changed[:5]}, count {count} -> {opt.count}")


def eval_calls(splits: list, B: int, n_val: int, epochs_run: int) -> int:
    """The eval calls of one finetune runner call: ceil(n_val / B)
    validation batches an epoch, and for the final test one call per
    spatial window present in each batch of B test samples (the padded rows
    of the last batch dropped)."""
    test = sum(len(set(splits[b:b + B])) for b in range(0, len(splits), B))
    return epochs_run * -(-n_val // B) + test


def phase_finetune_runner(smi: str) -> dict:
    """The main path of this slice: the ViT-B BB-focused MCA finetune
    runner from a pretrain checkpoint, 2 epochs, then resumed for a
    third."""
    calls = []
    with tempfile.TemporaryDirectory() as tmp:
        pretrain = os.path.join(tmp, "pretrain.pth")
        sd = create_model(MODEL, dtype=torch.bfloat16, seed=1).state_dict()
        torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, pretrain)
        del sd
        out = os.path.join(tmp, "ft")
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for epochs in (2, 3):
            args = finetune_mofo.get_args(
                FT_RUNNER_ARGS + ["--epochs", str(epochs), "--finetune",
                                  pretrain, "--output_dir", out],
                bb_defaults=True)
            _, text, seconds = _quiet_main(finetune_mofo.main, args)
            calls.append({"epochs": epochs,
                          "final_tests": FINAL_TEST.findall(text),
                          "seconds": seconds})
        launches = dict(fa.launch_counts)
        log = _runner_log(out)
        ckpts = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
    steps_after = [[line["step"] for line in log if line["epoch"] < e][-1]
                   for e in (2, 3)]
    steps = steps_after[-1]
    splits = [0] * FT_RUNNER_CLIPS  # the synthetic clips: one view each
    n_eval = (eval_calls(splits, FT_BATCH, FT_RUNNER_CLIPS, 2)
              + eval_calls(splits, FT_BATCH, FT_RUNNER_CLIPS, 1))
    want = {k: steps * STEP_LAUNCHES[FINETUNE_MODEL][k]
            + n_eval * EVAL_LAUNCHES[FINETUNE_MODEL][k] for k in fa.KERNELS}
    if steps_after != [8, 12]:
        raise AssertionError(f"the runner took other steps: {steps_after}")
    if [line["epoch"] for line in log] != [0, 1, 2]:
        raise AssertionError(f"log.txt holds other epochs: {log}")
    if not all(np.isfinite(line["train_loss"]) and "val_acc1" in line
               for line in log):
        raise AssertionError(f"non-finite losses or no val_acc1: {log}")
    if ckpts != ["checkpoint-1.pth", "checkpoint-2.pth",
                 "checkpoint-best.pth"]:
        raise AssertionError(f"checkpoints {ckpts}")
    if [len(c["final_tests"]) for c in calls] != [1, 1]:
        raise AssertionError(f"Final test lines per call: {calls}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({steps} steps, {n_eval} eval calls)")
    emit("finetune_runner", model=FINETUNE_MODEL, fusing="MCA",
         dtype="bfloat16", batch=FT_BATCH, args=FT_RUNNER_ARGS, calls=calls,
         steps_after=steps_after, eval_calls=n_eval, launches=launches,
         launches_per_step=STEP_LAUNCHES[FINETUNE_MODEL],
         launches_per_eval_call=EVAL_LAUNCHES[FINETUNE_MODEL],
         epochs=[{k: line[k] for k in ("epoch", "train_loss", "val_acc1",
                                       "val_loss")} for line in log],
         step_ms=[line["step_s"] * 1e3 for line in log],
         loader_wait_ms=[line["data_wait_s"] * 1e3 for line in log],
         validation_s=[line["val_s"] for line in log],
         final_test_s=[float(c["final_tests"][0][2]) for c in calls],
         checkpoint_save_s=[line["save_s"] for line in log],
         checkpoints=ckpts, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return launches


def write_memory_video(path: str, hw=DECODE_HW) -> None:
    """An mp4 (cv2, mp4v, 10 fps) of MemoryReader's frames for `path`, at
    `hw`: a video that the port's own VideoReader decodes."""
    import cv2  # only for the files of phase real_data_runner

    frames = MemoryReader(path, width=hw[1], height=hw[0])
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (hw[1], hw[0]))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    for frame in frames.get_batch(range(len(frames))):
        writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
    writer.release()


def write_real_data(root: str) -> dict:
    """Into `root`: SSV2-style setting files over 64 videos (pretrain: all;
    finetune: 40 train, 20 validation, 10 test; feature extraction: 8), an
    Unsupervised_BB_SSV2_train.json with one box per frame, and
    EPIC_100-shaped train (20) and validation (10) CSVs with their
    video_<i>.mp4 under epic/<split>/. The SSV2 videos are mp4 files of
    MemoryReader's frames (write_memory_video); each EPIC video is a 1 KB
    placeholder, so that the datasets' loadability guard runs on files that
    MemoryReader serves."""
    def touch(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"\0" * 1024)
        return path

    os.makedirs(os.path.join(root, "ssv2"))
    videos = [os.path.join(root, "ssv2", f"v{i}.mp4")
              for i in range(REAL_CLIPS)]
    for path in videos:
        write_memory_video(path)
    lists = {"pretrain": range(64), "train": range(40),
             "val": range(40, 60), "test": range(54, 64),
             "features": range(40, 48)}
    paths = {}
    for name, ids in lists.items():
        paths[name] = os.path.join(root, f"{name}.csv")
        with open(paths[name], "w") as f:
            f.writelines(f"{videos[i]} {i % 174}\n" for i in ids)
    epic = {"train": [(i % 4, (3 * i) % 5) for i in range(20)],
            "validation": [((i + 1) % 4, (3 * i) % 5) for i in range(10)]}
    header = ("narration_id,participant_id,video_id,narration_timestamp,"
              "start_timestamp,stop_timestamp,start_frame,stop_frame,"
              "narration,verb,verb_class,noun,noun_class,all_nouns,"
              "all_noun_classes\n")
    for split, pairs in epic.items():
        paths[f"epic_{split}"] = os.path.join(root, f"EPIC_100_{split}.csv")
        with open(paths[f"epic_{split}"], "w") as f:
            f.write(header)
            for i, (verb, noun) in enumerate(pairs):
                videos.append(touch(os.path.join(root, "epic", split,
                                                 f"video_{i}.mp4")))
                f.write(f"P01_{i},P01,P01_1{i:02d},00:00:01.00,00:00:01.00,"
                        f"00:00:03.00,1,60,cut it,cut,{verb},it,{noun},"
                        f"\"['it']\",[{noun}]\n")
    paths["bb_json"] = os.path.join(root, "Unsupervised_BB_SSV2_train.json")
    with open(paths["bb_json"], "w") as f:
        json.dump(memory_box_json(videos, DECODE_HW), f)
    paths["epic_root"] = os.path.join(root, "epic")
    return paths


def decoded_against_memory(paths) -> dict:
    """The SSV2 mp4 files through the port's VideoReader (the backend that
    opens them on this machine) against the frames they were written from:
    the same frame count and shape, and the mean absolute difference that
    mp4v's lossy coding leaves. Also whether native/decoder's library
    loads here, and cv2's version and FFmpeg libraries."""
    import cv2

    video_io = [" ".join(line.split()) for line in cv2.getBuildInformation(
    ).split("\n") if line.strip().startswith(("FFMPEG:", "avcodec:",
                                               "avformat:", "swscale:"))]
    res = {"native_library_loads": native_available(), "cv2": cv2.__version__,
           "cv2_video_io": video_io, "backends": set(), "mean_abs_diff": []}
    for path in paths:
        with VideoReader(path, width=DECODE_HW[1], height=DECODE_HW[0]) as vr:
            want = MemoryReader(path, DECODE_HW[1], DECODE_HW[0])
            if len(vr) != len(want):
                raise AssertionError(f"{path}: {len(vr)} frames decoded, "
                                     f"{len(want)} written")
            ids = np.arange(0, len(want), 7)
            got = vr.get_batch(ids)
            res["backends"].add(vr.backend)
        if got.shape != (len(ids), *DECODE_HW, 3):
            raise AssertionError(f"{path}: decoded {got.shape}")
        res["mean_abs_diff"].append(float(np.abs(
            got.astype(np.int16) - want.get_batch(ids)).mean()))
    res["backends"] = sorted(res["backends"])
    return res


def datasets_card_vs_cpu(data: dict) -> dict:
    """The in-memory datasets of the phase through the loader onto the card
    and on the CPU after the same np.random.seed: equal frames (so equal
    frame ids), labels, tags and boxes; and each box the square of its
    frame."""
    boxes = MotionBoxIndex.from_file(data["bb_json"])
    entries = read_setting_file(data["pretrain"])[:20]
    mapping = epic_action_space([data["epic_train"],
                                 data["epic_validation"]])[1]

    def epic_ds(split, mode):
        return EpicClipDataset(
            read_epic_csv(data[f"epic_{split}"]), data["epic_root"], split,
            mode=mode, action_mapping=mapping, decode_size=DECODE_HW,
            boxes=boxes, reader=MemoryReader)

    sets = {
        "pretrain": P.PretrainClipDataset(entries, decode_size=DECODE_HW,
                                          boxes=boxes, reader=MemoryReader),
        "ssv2_train": P.FinetuneClipDataset(entries, decode_size=DECODE_HW,
                                            boxes=boxes, reader=MemoryReader),
        "ssv2_test": P.FinetuneClipDataset(entries[:3], mode="test",
                                           decode_size=DECODE_HW,
                                           boxes=boxes, reader=MemoryReader),
        "ek100_train": epic_ds("train", "train"),
        "ek100_test": epic_ds("validation", "test"),
    }
    res = {}
    for name, ds in sets.items():
        got = {}
        for device in ("cuda", "cpu"):
            np.random.seed(7)
            batches = [{k: v.cpu().numpy() for k, v in b.items()}
                       for b in P.PrefetchLoader(ds, FT_BATCH, device=device,
                                                 drop_last=False)]
            got[device] = {k: np.concatenate([b[k] for b in batches])
                           for k in batches[0]}
        card, cpu = got["cuda"], got["cpu"]
        differ = [k for k in cpu if not np.array_equal(card[k], cpu[k])]
        ids = frame_ids(card["clip"])
        # the box of (sample, t) is the square of the frame decoded there
        paths = [ds.entries[int(v)].path if name.startswith(
            ("pretrain", "ssv2")) else f"video_{int(v)}.mp4"
            for v in card.get("video_idx", range(len(ids)))]
        want_boxes = np.array([
            [MemoryReader(p, DECODE_HW[1], DECODE_HW[0]).box(int(i))
             for i in row] for p, row in zip(paths, ids)], np.float32)
        if differ or set(card) != set(cpu) or not np.array_equal(
                card["boxes"], want_boxes):
            raise AssertionError(f"{name}: card vs CPU differ in {differ}, "
                                 "or the boxes are not the frames' squares")
        res[name] = {"samples": len(ids), "keys": sorted(card),
                     "frame_ids_0": ids[0].tolist()}
    return res


def loader_modes(data: dict) -> dict:
    """The wait per batch of the ViT-S runner's dataset (B=32, 16 frames at
    256 x 320, boxes, frames from MemoryReader) with one thread and with
    four: the first batch and the mean of the next three, each batch pinned
    and copied to the card."""
    ds = P.PretrainClipDataset(
        read_setting_file(data["pretrain"]) * 2, decode_size=DECODE_HW,
        boxes=MotionBoxIndex.from_file(data["bb_json"]), reader=MemoryReader)
    res = {}
    for workers in (1, 4):
        waits = []
        t = time.perf_counter()
        for batch in P.PrefetchLoader(ds, VITS_BATCH, num_workers=workers):
            torch.cuda.synchronize()
            now = time.perf_counter()
            waits.append(now - t)
            t = now
        res[f"threadx{workers}"] = {
            "first_batch_ms": waits[0] * 1e3,
            "wait_ms_per_batch": statistics.mean(waits[1:]) * 1e3,
            "batches": len(waits)}
    return res


def phase_real_data_runner(smi: str) -> dict:
    """The runners on file lists, motion boxes and EPIC_100 CSVs: the ViT-S
    pretrain runner (bf16, then f32 as its reference), the ViT-B BB-focused
    MCA finetune runner on SSV2 (mp4 files through the port's VideoReader)
    and on EK-100 actions, and feature_extract from the SSV2 run's
    checkpoint-best (VideoReader). The pretrain and EK-100 runs read
    MemoryReader's frames."""
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_real_data(tmp)
        written_s = time.perf_counter() - t0
        decoded = decoded_against_memory(
            [e.path for e in read_setting_file(data["pretrain"])[:8]])
        common = ["--bb_json", data["bb_json"], "--num_workers", "4"]

        def run(name, main_fn, args, reader=MemoryReader):
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            result, text, seconds = _quiet_main(main_fn, args, reader)
            launches[name] = dict(fa.launch_counts)
            runs[name] = {"seconds": seconds}
            return result, text

        # 1. ViT-S MOFO pretraining: 64 clips, B=32, 2 epochs of 2 steps, in
        # bf16 and, as its reference, in f32 (the f32 kernels)
        losses = {}
        for name, dtype in (("pretrain", "bfloat16"),
                            ("pretrain_f32", "float32")):
            pt_out = os.path.join(tmp, name)
            state, _ = run(name, pretrain_mofo.main, pretrain_mofo.get_args(
                ["--model", VITS_MODEL, "--data_path", data["pretrain"],
                 "--batch_size", str(VITS_BATCH), "--epochs", "2",
                 "--warmup_epochs", "1", "--dtype", dtype,
                 "--output_dir", pt_out] + common, mofo_defaults=True))
            log = _runner_log(pt_out)
            kernels = fa.KERNELS if dtype == "bfloat16" else (
                fa.QKV_F32_KERNELS + fa.HM_F32_KERNELS)
            want = {k: (state.step * v if k in kernels else 0)
                    for k, v in STEP_LAUNCHES[VITS_MODEL].items()}
            if state.step != 2 * (REAL_CLIPS // VITS_BATCH) or \
                    [x["epoch"] for x in log] != [0, 1] or \
                    not all(np.isfinite(x["train_loss"]) for x in log) or \
                    launches[name] != want:
                raise AssertionError(
                    f"{name}: step {state.step}, log {log}, launches "
                    f"{launches[name]} != {want}")
            losses[name] = [x["train_loss"] for x in log]
            runs[name].update(
                steps=state.step, losses=losses[name],
                step_ms=[x["step_s"] * 1e3 for x in log],
                loader_wait_ms=[x["data_wait_s"] * 1e3 for x in log])
            del state
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["pretrain"],
                                                   losses["pretrain_f32"])]
        runs["pretrain"].update(loss_rel_to_f32=rel,
                                bound=PRETRAIN_F32_RTOL)
        if not max(rel) <= PRETRAIN_F32_RTOL:
            raise AssertionError(f"bf16 pretrain losses {losses['pretrain']} "
                                 f"beyond {PRETRAIN_F32_RTOL} of f32's "
                                 f"{losses['pretrain_f32']}")

        # 2-3. the ViT-B BB-focused MCA finetune runner, SSV2 and EK-100
        pretrain = os.path.join(tmp, "pretrain.pth")
        sd = create_model(MODEL, dtype=torch.bfloat16, seed=1).state_dict()
        torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, pretrain)
        del sd
        ft_sets = {
            "ssv2": (["--data_set", "SSV2", "--data_path", data["train"],
                      "--val_path", data["val"], "--test_path", data["test"]],
                     [len(read_setting_file(data[k]))
                      for k in ("train", "val", "test")], VideoReader),
            "ek100": (["--data_set", "EK100", "--classtype", "action",
                       "--data_path", data["epic_train"], "--val_path",
                       data["epic_validation"], "--data_root",
                       data["epic_root"]],
                      [len(read_epic_csv(data[k])) for k in (
                          "epic_train", "epic_validation", "epic_validation")],
                      MemoryReader),
        }
        for name, (flags, (n_train, n_val, n_test), reader) in \
                ft_sets.items():
            out = os.path.join(tmp, name)
            args = finetune_mofo.get_args(
                flags + common + ["--batch_size", str(FT_BATCH), "--epochs",
                                  "1", "--warmup_epochs", "0", "--finetune",
                                  pretrain, "--output_dir", out],
                bb_defaults=True)
            _, text = run(name, finetune_mofo.main, args, reader)
            log = _runner_log(out)
            steps = log[-1]["step"]
            splits = [split for _, _, split in P.expand_views(
                n_test, args.test_num_segment, args.test_num_crop)]
            n_eval = eval_calls(splits, FT_BATCH, n_val, 1)
            want = {k: steps * STEP_LAUNCHES[FINETUNE_MODEL][k]
                    + n_eval * EVAL_LAUNCHES[FINETUNE_MODEL][k]
                    for k in fa.KERNELS}
            final = FINAL_TEST.findall(text)
            marg = re.findall(r"Final test \(EK marginalized\): verb "
                              r"([\d.]+) noun ([\d.]+)", text)
            if steps != n_train // FT_BATCH or len(final) != 1 or \
                    [x["epoch"] for x in log] != [0] or \
                    not np.isfinite(log[0]["train_loss"]) or \
                    len(marg) != (name == "ek100") or \
                    launches[name] != want:
                raise AssertionError(
                    f"{name}: steps {steps}, log {log}, final {final}, "
                    f"marginalized {marg}, launches {launches[name]} != "
                    f"{want} ({n_eval} eval calls)")
            runs[name].update(
                reader=reader.__name__, steps=steps, eval_calls=n_eval,
                test_views=len(splits), loss=log[0]["train_loss"],
                val_acc1=log[0]["val_acc1"], step_ms=log[0]["step_s"] * 1e3,
                loader_wait_ms=log[0]["data_wait_s"] * 1e3,
                validation_s=log[0]["val_s"], final_test_s=float(final[0][2]),
                final_test={"acc1": float(final[0][0]),
                            "acc5": float(final[0][1])},
                checkpoint_save_s=log[0]["save_s"])
            if marg:
                runs[name]["marginalized"] = {"verb": float(marg[0][0]),
                                              "noun": float(marg[0][1])}
                runs[name]["nb_classes"] = len(epic_action_space(
                    [data["epic_train"], data["epic_validation"]])[0])

        # 4. feature_extract from the SSV2 run's checkpoint-best, 8 videos
        feats, _ = run("feature_extract", feature_extract.main,
                       feature_extract.get_args([
                           "--data_path", data["features"], "--model_path",
                           os.path.join(tmp, "ssv2", "checkpoint-best.pth"),
                           "--batch_size", "4", "--output",
                           os.path.join(tmp, "features.npy")]), VideoReader)
        want = {**dict.fromkeys(fa.KERNELS, 0), "qkv_attn_fwd": 2 * 12}
        if feats.shape != (8, 768) or not np.isfinite(feats).all() or \
                launches["feature_extract"] != want:
            raise AssertionError(f"feature_extract: {feats.shape}, launches "
                                 f"{launches['feature_extract']} != {want}")
        runs["feature_extract"].update(reader="VideoReader",
                                       shape=list(feats.shape),
                                       mean_abs=float(np.abs(feats).mean()))
        datasets = datasets_card_vs_cpu(data)
        modes = loader_modes(data)
    total = {k: sum(run[k] for run in launches.values()) for k in fa.KERNELS}
    emit("real_data_runner", runs=runs, launches=launches,
         mp4_written_s=written_s, decoded_against_memory=decoded,
         datasets_card_vs_cpu=datasets, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    emit("loader_modes", dataset="PretrainClipDataset (MemoryReader)",
         batch=VITS_BATCH, frames=16, decode=list(DECODE_HW), modes=modes,
         nvidia_smi=smi)
    return total


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _steps(step, state, batch, gen, n_steps: int) -> dict:
    """n_steps pretrain steps, each timed on the host after a sync; the
    launches counted from 0 over them."""
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    out = {"ms": [], "loss": [], "grad_norm": []}
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0.5)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["launches"] = dict(fa.launch_counts)
    out["step_ms"] = statistics.median(out["ms"][1:])
    return out


def phase_ddp_step(smi: str) -> dict:
    """The ViT-B MOFO pretrain step through DDP over NCCL at world 1
    against the same step without DDP. Returns the DDP run's launches."""
    n_steps = 6  # 1 warm-up + 5 timed
    runs = {}
    for wrap in (False, True):
        if wrap:
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
        try:
            _, state, step, gen, batch = build_step(STEP_BATCH, wrap=wrap)
            runs["ddp" if wrap else "plain"] = _steps(step, state, batch,
                                                      gen, n_steps)
            if wrap:
                backend = dist.get_backend()
        finally:
            if wrap:
                dist.destroy_process_group()
        del state, step, batch
        torch.cuda.empty_cache()
    plain, wrapped = runs["plain"], runs["ddp"]
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(wrapped[k], plain[k]))
           for k in ("loss", "grad_norm")}
    want = {k: n_steps * v for k, v in STEP_LAUNCHES[MODEL].items()}
    emit("ddp_step", model=MODEL, dtype="bfloat16", batch=STEP_BATCH,
         backend=backend, world=1, steps=n_steps,
         step_ms=wrapped["step_ms"], plain_step_ms=plain["step_ms"],
         step_ms_all=wrapped["ms"], plain_step_ms_all=plain["ms"],
         loss=wrapped["loss"], grad_norm=wrapped["grad_norm"],
         rel_diff=rel, bound=DDP_STEP_RTOL,
         bit_equal=wrapped["loss"] == plain["loss"]
         and wrapped["grad_norm"] == plain["grad_norm"],
         launches=wrapped["launches"], nvidia_smi=smi)
    if wrapped["launches"] != want:
        raise AssertionError(f"DDP launches {wrapped['launches']}, "
                             f"expected {want}")
    if not max(rel.values()) <= DDP_STEP_RTOL:
        raise AssertionError(f"DDP vs plain beyond {DDP_STEP_RTOL}: {rel}")
    return wrapped["launches"]


def _run_module(args: list) -> str:
    """`python -m <args>` from the checkout's root; its output is printed
    and AssertionError raised when it fails."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print((proc.stdout + proc.stderr)[-6000:], flush=True)
        raise AssertionError(f"{args[:4]} exited {proc.returncode}")
    return proc.stdout


def phase_ddp_two_ranks(smi: str) -> dict:
    """Two ranks on cuda:0 over gloo against one process at G' on the same
    card. Returns the ranks' launches, summed."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = ddp_ranks.two_rank_runs(0, 1)
        ref_s = time.perf_counter() - t0
        runs = [r for r in ref if r != "launches"]
        torch.save({r: ref[r].pop("params") for r in runs},
                   os.path.join(tmp, "reference.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        procs = []
        for rank in range(ddp_ranks.WORLD):
            env = dict(os.environ, RANK=str(rank),
                       WORLD_SIZE=str(ddp_ranks.WORLD), LOCAL_RANK="0")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mofo_tpu_torch.tools.ddp_ranks",
                 "check", tmp], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        ranks_s = time.perf_counter() - t0
        for proc, out in zip(procs, outs):
            if proc.returncode != 0:
                print(out[-6000:], flush=True)
                raise AssertionError(f"a rank exited {proc.returncode}")
        got = [torch.load(os.path.join(tmp, f"rank-{r}.pt"))
               for r in range(ddp_ranks.WORLD)]
    report, bad = {}, []
    for run in runs:
        rtol = BF16_STEP_RTOL if "bfloat16" in run else DDP_F32_RTOL
        want = ref[run]
        rows = []
        for r, out in enumerate(got):
            res = {k: max(abs(a - b) / abs(b)
                          for a, b in zip(out[run][k], want[k]))
                   for k in ("loss", "grad_norm")}
            res["params_max_abs_err"] = out[run]["params_max_abs_err"]
            res["step_ms"] = out[run]["ms"]
            bad += [f"{run} rank {r} {k}" for k in ("loss", "grad_norm")
                    if not res[k] <= rtol]
            if "float32" in run and not res["params_max_abs_err"] <= \
                    DDP_F32_ATOL:
                bad.append(f"{run} rank {r} parameters")
            if "eval" in want:
                n = len(out[run]["logits"])
                res["logits_max_abs_err"] = (
                    out[run]["logits"] - want["logits"][r * n:(r + 1) * n]
                ).abs().max().item()
                res["eval"], res["multiview"] = (out[run]["eval"],
                                                 out[run]["multiview"])
                if not res["logits_max_abs_err"] <= DDP_F32_ATOL:
                    bad.append(f"{run} rank {r} logits")
                for key in ("acc1", "acc5"):
                    if out[run]["eval"][key] != want["eval"][key]:
                        bad.append(f"{run} rank {r} validation {key}")
                if out[run]["multiview"] != want["multiview"]:
                    bad.append(f"{run} rank {r} multi-view")
                if abs(out[run]["eval"]["loss"] - want["eval"]["loss"]) > \
                        DDP_F32_RTOL * abs(want["eval"]["loss"]):
                    bad.append(f"{run} rank {r} validation loss")
            rows.append(res)
        report[run] = {"ranks": rows, "bound_rtol": rtol,
                       "one_process": {k: want[k] for k in (
                           "loss", "grad_norm", "ms", "eval", "multiview")
                           if k in want}}
    launches = {k: sum(out["launches"][k] for out in got) for k in fa.KERNELS}
    path = fa.QKV_KERNELS + fa.MH_F32_KERNELS
    skipped = [k for k in path if launches[k] < 1]
    emit("ddp_two_ranks", world=ddp_ranks.WORLD, backend="gloo",
         device="cuda:0 (both ranks)", runs=report,
         batch_per_rank={"pretrain": ddp_ranks.PRETRAIN_BK[0],
                         "finetune": ddp_ranks.FINETUNE_B},
         update_freq=ddp_ranks.PRETRAIN_BK[1], steps=ddp_ranks.STEPS,
         one_process_s=ref_s, ranks_s=ranks_s, launches=launches,
         nvidia_smi=smi)
    if bad or skipped:
        raise AssertionError(f"ranks vs one process: {bad}; kernels not "
                             f"launched under DDP: {skipped}")
    return launches


def phase_ddp_runner(smi: str) -> dict:
    """The ViT-S pretrain runner (then resumed) and the BB-focused finetune
    runner through torch.distributed.run. Returns their launches,
    summed."""
    launch = ["torch.distributed.run", "--standalone", "--nproc_per_node",
              "1", "-m", "mofo_tpu_torch.tools.ddp_ranks", "cli"]
    with tempfile.TemporaryDirectory() as tmp:
        pt, ft = os.path.join(tmp, "pt"), os.path.join(tmp, "ft")
        calls = (("pretrain", "pretrain_mofo",
                  DDP_RUNNER_ARGS + ["--epochs", "1", "--output_dir", pt]),
                 ("resume", "pretrain_mofo",
                  DDP_RUNNER_ARGS + ["--epochs", "2", "--output_dir", pt]),
                 ("finetune", "finetune_mofo",
                  DDP_FT_ARGS + ["--output_dir", ft]))
        launches, texts, seconds = {}, {}, {}
        for name, runner, args in calls:
            counts = os.path.join(tmp, f"{name}.json")
            t0 = time.perf_counter()
            texts[name] = _run_module(launch + [counts, runner, *args])
            seconds[name] = time.perf_counter() - t0
            with open(counts) as f:
                launches[name] = json.load(f)
        pt_log, ft_log = _runner_log(pt), _runner_log(ft)
        pt_files = sorted(os.listdir(pt))
        ft_files = sorted(os.listdir(ft))
        names = list(torch.load(os.path.join(pt, "checkpoint-1.pth"),
                                map_location="cpu",
                                weights_only=True)["model"])
    steps = {"pretrain": 2, "resume": 2, "finetune": DDP_FT_CLIPS // FT_BATCH}
    n_eval = 2 * (DDP_FT_CLIPS // FT_BATCH)  # validation + final test
    want = {name: {k: steps[name] * v for k, v in STEP_LAUNCHES[
        VITS_MODEL if name != "finetune" else FINETUNE_MODEL].items()}
        for name in steps}
    for k in fa.KERNELS:
        want["finetune"][k] += n_eval * EVAL_LAUNCHES[FINETUNE_MODEL][k]
    final = FINAL_TEST.findall(texts["finetune"])
    problems = [
        f"{name} launches {launches[name]} != {want[name]}"
        for name in steps if launches[name] != want[name]]
    if [x["epoch"] for x in pt_log] != [0, 1] or pt_files != [
            "checkpoint-0.pth", "checkpoint-1.pth", "log.txt"]:
        problems.append(f"pretrain log {pt_log}, files {pt_files}")
    if "auto-resumed at epoch 1" not in texts["resume"]:
        problems.append("the second pretrain call did not resume")
    if any(n.startswith("module.") for n in names):
        problems.append("a checkpoint holds module. names")
    if len(final) != 1 or [x["epoch"] for x in ft_log] != [0] or \
            "checkpoint-best.pth" not in ft_files:
        problems.append(f"finetune: final {final}, log {ft_log}, files "
                        f"{ft_files}")
    if not all(np.isfinite(x["train_loss"]) for x in pt_log + ft_log):
        problems.append(f"non-finite losses {pt_log} {ft_log}")
    total = {k: sum(c[k] for c in launches.values()) for k in fa.KERNELS}
    emit("ddp_runner", launcher="torch.distributed.run --standalone "
         "--nproc_per_node 1", seconds=seconds, launches=launches,
         pretrain={"model": VITS_MODEL, "batch": VITS_BATCH,
                   "epochs": [{k: x[k] for k in ("epoch", "train_loss",
                                                 "step_s")} for x in pt_log],
                   "files": pt_files},
         finetune={"model": FINETUNE_MODEL, "batch": FT_BATCH,
                   "train_loss": ft_log[0]["train_loss"],
                   "val_acc1": ft_log[0]["val_acc1"],
                   "step_s": ft_log[0]["step_s"],
                   "final_test": final, "files": ft_files},
         nvidia_smi=smi)
    if problems:
        raise AssertionError(f"ddp_runner: {problems}")
    return total


def _json_boxes(path: str) -> dict:
    with open(path) as f:
        return {k: np.array([[lab["labels"][0]["box2d"][c] for c in (
            "x1", "y1", "x2", "y2")] for lab in v], np.float64)
            for k, v in json.load(f).items()}


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise IoU of (n, 4) x1, y1, x2, y2 boxes."""
    w = np.clip(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]),
                0, None)
    h = np.clip(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]),
                0, None)
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]) + \
        (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return w * h / np.maximum(area - w * h, 1e-9)


def op_roundings(n: int = 1 << 20) -> dict:
    """For each elementwise op that TV-L1 runs, how many of n f32 results
    differ in any bit between the card and the CPU (same inputs); for the
    f32 square root also how many on each device differ from the correctly
    rounded root (an f64 root rounded to f32)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(n, generator=g)
    b = torch.rand(n, generator=g) + 0.5
    ops = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y, "div": lambda x, y: x / y,
           "sqrt": lambda x, y: torch.sqrt(y), "pow2": lambda x, y: x ** 2,
           "flow_sqrt": lambda x, y: flow._sqrt(y),
           "scalar_mul": lambda x, y: 0.045 * x,
           "scalar_add": lambda x, y: 1.0 + 0.8333333 * y,
           "rsub": lambda x, y: 1 - y}
    res = {name: int((f(a, b) != f(a.cuda(), b.cuda()).cpu()).sum())
           for name, f in ops.items()}
    root = torch.sqrt(b.double()).float()
    res["sqrt_cpu_vs_f64"] = int((torch.sqrt(b) != root).sum())
    res["sqrt_card_vs_f64"] = int((torch.sqrt(b.cuda()).cpu() != root).sum())
    return res


def _factory(args: list, reader=VideoReader) -> tuple:
    """cli.motion_factory's main on `args`; (its result, its stdout,
    seconds), the stdout printed and AssertionError raised on a SKIP."""
    result, text, seconds = _quiet_main(
        motion_factory.main, motion_factory.get_args(args), reader)
    if result["skipped"] or "SKIP" in text:
        print(text[-4000:], flush=True)
        raise AssertionError(f"the factory skipped {result['skipped']}")
    return result, text, seconds


def phase_factory(smi: str) -> dict:
    """The motion-box factory on 8 SSV2-style videos on the card, held
    against the CPU, then the ViT-S MOFO pretrain runner on its JSON.
    Returns the runner's launches."""
    problems = []
    with tempfile.TemporaryDirectory() as tmp:
        videos = [os.path.join(tmp, f"v{i}.mp4")
                  for i in range(FACTORY_VIDEOS)]
        for path in videos:
            write_memory_video(path)
        lengths = {MotionBoxIndex.video_key(p): len(MemoryReader(p))
                   for p in videos}
        listing = os.path.join(tmp, "train.csv")
        with open(listing, "w") as f:
            f.writelines(f"{p} {i}\n" for i, p in enumerate(videos))
        bb_json = os.path.join(tmp, "Unsupervised_BB_SSV2_train.json")

        # 1. the factory on the card, its defaults
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        card, _, card_s = _factory(["--data_path", listing, "--output",
                                    bb_json])
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        boxes = _json_boxes(bb_json)
        counts = {k: len(v) for k, v in boxes.items()}
        if counts != lengths:
            problems.append(f"boxes per video {counts} != frames {lengths}")
        stages = {k: card["seconds"][k] for k in lengths}
        flow_ms_per_pair = {k: 1e3 * stages[k]["flow"] / (lengths[k] - 1)
                            for k in lengths}

        # 2. two pairs of the shortest video: card against CPU
        short = min(lengths, key=lengths.get)
        path = videos[list(lengths).index(short)]
        with VideoReader(path) as vr:
            frames = vr.get_batch(np.arange(len(vr)))
        mid = len(frames) // 2
        prev, nxt = frames[[0, mid]], frames[[1, mid + 1]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = flow.tvl1_flow(prev, nxt).cpu().numpy()
        two_pairs_card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = flow.tvl1_flow(prev, nxt, device="cpu").numpy()
        two_pairs_cpu_s = time.perf_counter() - t0
        d = np.abs(on_card - on_cpu)
        card_vs_cpu = {"pairs": [[0, 1], [mid, mid + 1]],
                       "op_roundings": op_roundings(),
                       "max_abs_px": float(d.max()),
                       "p99_abs_px": float(np.percentile(d, 99)),
                       "bounds": [FLOW_CPU_MAX, FLOW_CPU_P99],
                       "card_s": two_pairs_card_s,
                       "cpu_s": two_pairs_cpu_s,
                       "median_flow_px": np.median(on_card, axis=(1, 2)
                                                   ).tolist()}
        if not (d.max() <= FLOW_CPU_MAX and np.percentile(d, 99)
                <= FLOW_CPU_P99):
            problems.append(f"TV-L1 card vs CPU {card_vs_cpu}")

        # 3. four pairs batched against one call a pair, on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = flow.tvl1_flow_batch(frames[:5])
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = torch.stack([flow.tvl1_flow(frames[i], frames[i + 1])
                               for i in range(4)])
        torch.cuda.synchronize()
        singles_s = time.perf_counter() - t0
        gap = float((batched - singles).abs().max())
        batched_vs_pairs = {"pairs": 4, "max_abs_px": gap,
                            "bound": BATCHED_ATOL, "batched_s": batched_s,
                            "one_call_a_pair_s": singles_s}
        if not gap <= BATCHED_ATOL:
            problems.append(f"batched vs per pair {batched_vs_pairs}")

        # 4. that video's JSON from --device cpu
        cpu_json = os.path.join(tmp, "cpu.json")
        cpu, _, cpu_s = _factory(["--data_path", path, "--output", cpu_json,
                                  "--device", "cpu"])
        box_gap = np.abs(_json_boxes(cpu_json)[short] - boxes[short])
        boxes_card_vs_cpu = {
            "video": short, "frames": lengths[short],
            "max_abs_px": float(box_gap.max()),
            "frames_differing": int((box_gap.max(axis=1) > 0).sum()),
            "bound": FACTORY_BOX_PX, "cpu_seconds": cpu["seconds"][short],
            "card_seconds": stages[short]}
        if not box_gap.max() <= FACTORY_BOX_PX:
            problems.append(f"boxes card vs CPU {boxes_card_vs_cpu}")

        # 5. per-frame boxes against the moving square (information)
        frame_json = os.path.join(tmp, "per_frame.json")
        _, _, per_frame_s = _factory(["--data_path", listing, "--output",
                                      frame_json, "--no_clip_union"])
        ious = {}
        for key, got in _json_boxes(frame_json).items():
            square = MemoryReader(videos[list(lengths).index(key)])
            ious[key] = float(_iou(got, np.array(
                [square.box(i) for i in range(len(got))], np.float64)
            ).mean())

        # 6. the loop closed: the ViT-S runner on the factory's boxes
        out = os.path.join(tmp, "pretrain")
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        state, _, runner_s = _quiet_main(
            pretrain_mofo.main, pretrain_mofo.get_args(
                ["--model", VITS_MODEL, "--data_path", listing, "--bb_json",
                 bb_json, "--batch_size", str(FACTORY_BATCH), "--epochs",
                 "1", "--warmup_epochs", "0", "--output_dir", out],
                mofo_defaults=True), VideoReader)
        launches = dict(fa.launch_counts)
        log = _runner_log(out)
    steps = FACTORY_VIDEOS // FACTORY_BATCH
    want = {k: steps * v for k, v in STEP_LAUNCHES[VITS_MODEL].items()}
    if state.step != steps or [x["epoch"] for x in log] != [0] or \
            not np.isfinite(log[0]["train_loss"]) or launches != want:
        problems.append(f"runner on the factory's boxes: step {state.step}, "
                        f"log {log}, launches {launches} != {want}")
    per_video = {k: sum(v.values()) for k, v in stages.items()}
    emit("factory", videos=lengths, flow="tvl1 4 scales x 8 warps x 100 "
         "iterations, window 8, max_frames 64", seconds=card_s,
         seconds_per_video=per_video, stages_per_video=stages,
         stage_means={s: statistics.mean(v[s] for v in stages.values())
                      for s in ("decode", "flow", "maps", "boxes", "write")},
         flow_ms_per_pair=flow_ms_per_pair,
         flow_ms_per_video={k: 1e3 * v["flow"] for k, v in stages.items()},
         peak_memory_mb=peak_mb, flow_card_vs_cpu=card_vs_cpu,
         batched_vs_pairs=batched_vs_pairs,
         boxes_card_vs_cpu=boxes_card_vs_cpu, cpu_call_s=cpu_s,
         per_frame_iou=ious, mean_iou=statistics.mean(ious.values()),
         per_frame_call_s=per_frame_s,
         runner={"model": VITS_MODEL, "batch": FACTORY_BATCH,
                 "steps": state.step, "seconds": runner_s,
                 "train_loss": log[0]["train_loss"],
                 "step_s": log[0]["step_s"],
                 "data_wait_s": log[0]["data_wait_s"]},
         launches=launches, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    if problems:
        raise AssertionError(f"factory: {problems}")
    return launches


def phase_vis(smi: str) -> dict:
    """cli.vis on ViT-B at 224 on the card and on the CPU, the same mask.
    Returns the card call's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v0.mp4")
        write_memory_video(path)
        common = ["--img_path", path, "--model", MODEL]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        card, _, card_s = _quiet_main(vis.main, vis.get_args(
            common + ["--save_path", os.path.join(tmp, "card")]), VideoReader)
        launches = dict(fa.launch_counts)
        files = sorted(os.listdir(os.path.join(tmp, "card")))
        cpu, _, cpu_s = _quiet_main(vis.main, vis.get_args(
            common + ["--save_path", os.path.join(tmp, "cpu"), "--device",
                      "cpu"]), VideoReader)
    gaps = {k: float((card[k] - cpu[k]).abs().max()) for k in card}
    want = {**dict.fromkeys(fa.KERNELS, 0), "qkv_attn_fwd": 16}
    emit("vis", model=MODEL, frames=16, input_size=224, mask_ratio=0.9,
         dtype="float32", files=len(files), card_s=card_s, cpu_s=cpu_s,
         max_abs_card_vs_cpu=gaps, bound=VIS_ATOL, launches=launches,
         nvidia_smi=smi)
    if len(files) != 48 or launches != want or not max(gaps.values()) <= \
            VIS_ATOL:
        raise AssertionError(f"vis: {len(files)} files, launches {launches} "
                             f"!= {want}, card vs CPU {gaps}")
    return launches


def phase_tiny_debug_step(smi: str) -> dict:
    """pretrain_videomae_tiny_debug at 224^2 and 16 frames, B=8: two steps
    in f32 and two in bf16 through K4 (D = 32 and 16) against the same
    steps through the plain versions on the card, from the same weights,
    masks and draws; K4's launches checked exactly. Returns the kernel
    runs' launches, both dtypes together."""
    n_steps = 2
    total = dict.fromkeys(fa.KERNELS, 0)
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for route in ("kernels", "plain"):
            plain = route == "plain"
            _, state, step, gen, batch = build_step(
                TINY_BATCH, TINY_MODEL, plain=plain, dtype=dtype)
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            metrics = []
            for _ in range(n_steps):
                state, m = step(state, batch, gen, 0.5)
                metrics.append({k: float(m[k]) for k in ("loss",
                                                          "grad_norm")})
            torch.cuda.synchronize()
            launches = dict(fa.launch_counts)
            kernels = (fa.HM_KERNELS if dtype == "bfloat16"
                       else fa.HM_F32_KERNELS)
            want = {**dict.fromkeys(fa.KERNELS, 0), **({} if plain else
                    dict.fromkeys(kernels, n_steps * TINY_BLOCKS))}
            if launches != want:
                raise AssertionError(f"tiny_debug_step {dtype} through the "
                                     f"{route}: launches {launches} != "
                                     f"{want}")
            if not plain:
                total = {k: total[k] + launches[k] for k in fa.KERNELS}
            runs[route] = metrics
            del state, step, batch
        rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
               for a, b in zip(runs["kernels"], runs["plain"])]
        bound = BF16_STEP_RTOL if dtype == "bfloat16" else F32_STEP_RTOL
        emit("tiny_debug_step", model=TINY_MODEL, dtype=dtype,
             batch=TINY_BATCH, steps=n_steps, head_dims={"encoder": 32,
                                                         "decoder": 16},
             kernels=runs["kernels"], plain=runs["plain"], rel_diff=rel,
             bound=bound, nvidia_smi=smi)
        values = [v for m in runs["kernels"] for v in m.values()]
        if not np.isfinite(values).all() or max(
                max(r.values()) for r in rel) > bound:
            raise AssertionError(f"tiny_debug_step {dtype}: {rel} beyond "
                                 f"{bound} or non-finite {values}")
    return total


@contextlib.contextmanager
def keep_shares():
    """Counts, by rate, the entries that ops.attention.keep_mask draws and
    those it keeps, over the dropout masks (drop path's per-sample masks,
    one entry a sample, are left out). Yields {rate: [kept, drawn]} as
    0-dim tensors on the masks' device."""
    real, counts = attention.keep_mask, {}

    def counted(shape, rate, generator, device):
        mask = real(shape, rate, generator, device)
        if mask[0].numel() > 1:
            c = counts.setdefault(rate, [0, 0])
            c[0], c[1] = c[0] + mask.sum(), c[1] + mask.numel()
        return mask

    attention.keep_mask = counted
    try:
        yield counts
    finally:
        attention.keep_mask = real


def _shares(counts: dict) -> dict:
    """{rate: kept share} of keep_shares' counts."""
    return {rate: float(kept) / drawn for rate, (kept, drawn)
            in counts.items()}


def phase_dropout_step(smi: str, no_drop_loss: float) -> tuple:
    """The ViT-B BB-focused MCA finetune step with dropout: at --drop 0.1
    (attention dropout 0) two runs of 2 steps from the same seeds, each
    launching K1/K2/K3 as phase finetune_step does, bit-equal to each other
    (losses, gradient norms, every parameter) and off the same step
    without dropout (`no_drop_loss`, its first loss); then at
    --attn_drop_rate 0.1 (B=2) no K1/K2/K3 launch and finite losses.
    Returns the launches of the first run and of the last."""
    n_steps = 2
    runs = []
    for _ in range(2):
        model, state, step, gen, batch, _ = build_finetune_step(
            FT_BATCH, drop=DROP)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        metrics = []
        with keep_shares() as counts:
            for _ in range(n_steps):
                state, m = step(state, batch, gen)
                metrics.append({k: float(m[k])
                                for k in ("loss", "grad_norm")})
        torch.cuda.synchronize()
        runs.append({"metrics": metrics, "launches": dict(fa.launch_counts),
                     "keep_shares": _shares(counts),
                     "params": [p.detach().clone()
                                for p in model.parameters()]})
        del model, state, step, batch
    want = {k: n_steps * v for k, v in STEP_LAUNCHES[FINETUNE_MODEL].items()}
    same = runs[0]["metrics"] == runs[1]["metrics"] and all(
        torch.equal(a, b) for a, b in zip(runs[0]["params"],
                                          runs[1]["params"]))
    first = runs[0]
    del runs
    torch.cuda.empty_cache()

    _, state, step, gen, batch, _ = build_finetune_step(
        ATTN_DROP_BATCH, attn_drop_rate=DROP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    attn_metrics = []
    with keep_shares() as counts:
        for _ in range(n_steps):
            state, m = step(state, batch, gen)
            attn_metrics.append({k: float(m[k])
                                 for k in ("loss", "grad_norm")})
    torch.cuda.synchronize()
    attn_launches = dict(fa.launch_counts)
    attn_shares = _shares(counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step, batch
    emit("dropout_step", model=FINETUNE_MODEL, dtype="bfloat16",
         drop={"batch": FT_BATCH, "rate": DROP, "metrics": first["metrics"],
               "launches": first["launches"], "runs_bit_equal": same,
               "keep_shares": first["keep_shares"],
               "first_loss_without_dropout": no_drop_loss},
         attn_drop={"batch": ATTN_DROP_BATCH, "rate": DROP,
                    "metrics": attn_metrics, "launches": attn_launches,
                    "keep_shares": attn_shares, "peak_mem_gib": peak},
         nvidia_smi=smi)
    problems = []
    if first["launches"] != want:
        problems.append(f"--drop launches {first['launches']} != {want}")
    if not same:
        problems.append("two runs from one seed differ")
    if first["metrics"][0]["loss"] == no_drop_loss:
        problems.append("dropout did not move the loss")
    # every dropout mask is drawn at the rate asked for: over some 1e8
    # entries a run, a binomial share's deviation is of order 1e-4
    for name, shares in (("--drop", first["keep_shares"]),
                         ("--attn_drop_rate", attn_shares)):
        if list(shares) != [DROP] or abs(
                shares[DROP] - (1.0 - DROP)) > KEEP_SHARE_ATOL:
            problems.append(f"{name} keep shares {shares}, want "
                            f"{1.0 - DROP} at rate {DROP} only")
    if any(attn_launches.values()):
        problems.append(f"--attn_drop_rate launched {attn_launches}")
    values = [v for m in first["metrics"] + attn_metrics for v in m.values()]
    if not np.isfinite(values).all():
        problems.append(f"non-finite {values}")
    if problems:
        raise AssertionError(f"dropout_step: {problems}")
    return first["launches"], attn_launches


def phase_attention_vis(smi: str) -> dict:
    """cli.attention_vis on ViT-B at 224^2 and 16 frames, f32, from a
    seeded .pth (a head of scale 1, so the class scores have gradients),
    on the card for each method: 16 files, the map's max 1, the launches
    (grad: K1's f32 forward and K2 in all 12 Blocks; Grad-CAM(++): K2 only
    in the Blocks from the target layer on, which autograd needs for the
    gradient at its norm1; rollout: none, its sowing takes the plain
    math); gradcam++ and rollout once more with --device cpu, the maps
    within VIS_ATOL. Returns the launches of the four card calls."""
    depth = 12
    zeros = dict.fromkeys(fa.KERNELS, 0)
    total, res = dict(zeros), {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v0.mp4")
        write_memory_video(path)
        pth = os.path.join(tmp, "ft.pth")
        torch.save({"model": create_model(
            VIS_MODEL, device="cpu", seed=1, init_scale=1.0,
            num_classes=attention_vis.get_args(["--video", "", "--save_path",
                                                ""]).nb_classes
        ).state_dict()}, pth)
        common = ["--video", path, "--model", VIS_MODEL, "--model_path", pth,
                  "--layer", str(VIS_LAYER)]
        for method in VIS_METHODS:
            out = os.path.join(tmp, method)
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            sal, _, card_s = _quiet_main(attention_vis.main,
                                         attention_vis.get_args(
                common + ["--method", method, "--save_path", out]),
                VideoReader)
            launches = dict(fa.launch_counts)
            total = {k: total[k] + launches[k] for k in fa.KERNELS}
            back = depth if method == "grad" else depth - VIS_LAYER
            want = dict(zeros) if method == "rollout" else {
                **zeros, "qkv_attn_fwd": depth, "qkv_attn_bwd_dkv": back,
                "qkv_attn_bwd_dq": back}
            res[method] = {"card_s": card_s, "launches": launches,
                           "files": len(os.listdir(out)),
                           "max": float(sal.max())}
            if method in ("gradcam++", "rollout"):
                cpu, _, cpu_s = _quiet_main(attention_vis.main,
                                            attention_vis.get_args(
                    common + ["--method", method, "--save_path",
                              out + "_cpu", "--device", "cpu"]), VideoReader)
                res[method].update(cpu_s=cpu_s, max_abs_card_vs_cpu=float(
                    np.abs(sal - cpu).max()))
            r = res[method]
            if r["files"] != 16 or launches != want or not \
                    abs(r["max"] - 1.0) < 1e-3 or \
                    r.get("max_abs_card_vs_cpu", 0.0) > VIS_ATOL:
                emit("attention_vis", methods=res)
                raise AssertionError(f"attention_vis {method}: {r}, "
                                     f"launches want {want}")
    emit("attention_vis", model=VIS_MODEL, frames=16, input_size=224,
         dtype="float32", layer=VIS_LAYER, methods=res, bound=VIS_ATOL,
         nvidia_smi=smi)
    return total


def write_rigid_video(path: str) -> np.ndarray:
    """A CHUNK_HW mp4 (cv2, mp4v) of CHUNK_FRAMES frames: a smoothed
    textured square of SQUARE px moving SQUARE_STEP px a frame over a
    static smoothed texture. Returns the square's (x1, y1, x2, y2) per
    frame."""
    import cv2

    H, W = CHUNK_HW
    rng = np.random.RandomState(0)
    bg = cv2.GaussianBlur(rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
                          (0, 0), 2)
    fg = cv2.GaussianBlur(rng.randint(0, 256, (SQUARE, SQUARE, 3)).astype(
        np.uint8), (0, 0), 2)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (W, H))
    boxes = []
    for i in range(CHUNK_FRAMES):
        x, y = W // 3 + SQUARE_STEP[0] * i, H // 4 + SQUARE_STEP[1] * i
        frame = bg.copy()
        frame[y:y + SQUARE, x:x + SQUARE] = fg
        writer.write(frame)
        boxes.append((x, y, x + SQUARE, y + SQUARE))
    writer.release()
    return np.array(boxes, np.float64)


def phase_factory_chunks(smi: str) -> None:
    """The factory's TV-L1 under a byte budget (motion_factory.video_flows)
    on a 1080p video of rigid motion, decoded by VideoReader: once under a
    budget of CHUNK_PAIRS pairs (3 calls), once in one call; the flows
    bit-equal and so the per-frame boxes (--no_clip_union), each run's peak
    memory, seconds and the boxes' mean IoU with the square printed."""
    H, W = CHUNK_HW
    pair = motion_factory.PAIR_BYTES_PER_PIXEL * H * W
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rigid.mp4")
        square = write_rigid_video(path)
        with VideoReader(path) as vr:
            frames = vr.get_batch(np.arange(len(vr)))
    args = motion_factory.get_args(["--data_path", path, "--output",
                                    "unused", "--no_clip_union"])
    dev = torch.device("cuda")
    runs = {}
    for name, budget in (("chunked", CHUNK_PAIRS * pair),
                         ("one_call", len(frames) * pair)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        flows = motion_factory.video_flows(frames, args, dev, budget=budget)
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        t0 = time.perf_counter()
        boxes = np.array(motion_factory.frame_boxes(
            motion_factory.magnitude_maps(flows, args.window), len(frames),
            clip_union=False), np.float64)
        runs[name] = {"flows": flows, "boxes": boxes, "calls": -(-(
            len(frames) - 1) // motion_factory.pairs_per_call(H, W, budget)),
            "flow_s": flow_s, "peak_mb": peak,
            "host_s": time.perf_counter() - t0}
    a, b = runs["chunked"], runs["one_call"]
    flows_equal = np.array_equal(a["flows"], b["flows"])
    boxes_equal = np.array_equal(a["boxes"], b["boxes"])
    iou = _iou(a["boxes"], square)
    emit("factory_chunks", hw=list(CHUNK_HW), frames=len(frames),
         pairs=len(frames) - 1, square=SQUARE, step_px=list(SQUARE_STEP),
         **{n: {k: v for k, v in r.items() if k not in ("flows", "boxes")}
            for n, r in runs.items()},
         flows_bit_equal=flows_equal, boxes_equal=boxes_equal,
         median_flow_px=[float(np.median(b["flows"][..., c][
             :, square[0, 1].astype(int):square[0, 3].astype(int),
             square[0, 0].astype(int):square[0, 2].astype(int)]))
             for c in (0, 1)],
         mean_iou=float(iou.mean()), nvidia_smi=smi)
    if a["calls"] < 3 or b["calls"] != 1 or not (flows_equal and boxes_equal):
        raise AssertionError(f"factory_chunks: {a['calls']} / {b['calls']} "
                             f"calls, flows equal {flows_equal}, boxes "
                             f"equal {boxes_equal}")


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    errors, timings = phase_kernels()
    mh_errors, mh_timings = phase_mh_kernels()
    launches = phase_step(smi)
    phase_parity()
    ft_launches, ft_step_ms, ft_loss = phase_finetune_step(smi)
    phase_finetune_parity()
    hm_errors, hm_timings = phase_hm_kernels()
    head_dims = phase_hm_head_dims(smi)
    phase_bf16_steps()
    vits_launches = phase_step(smi, "vits_step", VITS_MODEL, VITS_BATCH)
    phase_parity("vits_parity", VITS_MODEL,
                 fa.QKV_F32_KERNELS + fa.HM_F32_KERNELS)
    runner_launches = phase_runner(smi)
    phase_finetune_augment(smi, ft_step_ms)
    phase_fp16_finetune_step()
    ft_runner_launches = phase_finetune_runner(smi)
    real_launches = phase_real_data_runner(smi)
    later = {"launches_ddp_step": phase_ddp_step(smi),
             "launches_ddp_two_ranks": phase_ddp_two_ranks(smi),
             "launches_ddp_runner": phase_ddp_runner(smi),
             "launches_factory": phase_factory(smi),
             "launches_vis": phase_vis(smi)}
    t_new = time.perf_counter()
    later["launches_tiny_debug_step"] = phase_tiny_debug_step(smi)
    (later["launches_dropout_step"],
     later["launches_attn_dropout_step"]) = phase_dropout_step(smi, ft_loss)
    later["launches_attention_vis"] = phase_attention_vis(smi)
    phase_factory_chunks(smi)
    new_s = time.perf_counter() - t_new
    kernels = []
    for name in fa.QKV_KERNELS:
        dec = timings["decoder"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errors["decoder"][name], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "shape": "decoder (B=%d, N=%d, H=%d, D=%d) bf16" % (
                *MAIN["decoder"], D),
            "launches_finetune": ft_launches[name],
            "launches_vits_step": vits_launches[name],
            "launches_runner": runner_launches[name],
            "launches_finetune_runner": ft_runner_launches[name],
            "launches_real_data": real_launches[name],
            **{key: counts[name] for key, counts in later.items()},
            **{geo: {**timings[geo][name],
                     "max_abs_err": errors[geo][name]}
               for geo in ("encoder", "backbone")},
        })
    for name in fa.MH_KERNELS:
        mca = mh_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": ft_launches[name],
            "max_abs_err": mh_errors[name], "ms": mca["ms"],
            "plain_ms": mca["plain_ms"], "bound_ms": mca["bound_ms"],
            "bound_by": mca["bound_by"], "library_ms": mca["library_ms"],
            "shape": "MCA (B=%d, N=%d, H=%d, D=%d) bf16, kv bias" % (
                MH_CHECKS["mca"]),
            "launches_finetune_runner": ft_runner_launches[name],
            "launches_real_data": real_launches[name],
            **{key: counts[name] for key, counts in later.items()},
        })
    for name in fa.HM_KERNELS:
        dec = hm_timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": runner_launches[name],
            "max_abs_err": hm_errors[name], "ms": dec["ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "shape": "ViT-S runner decoder (B=%d, H=%d, N=%d, D=%d) bf16"
                     % (*HM_CHECKS["runner_decoder"], D),
            "launches_vits_step": vits_launches[name],
            "launches_real_data": real_launches[name],
            **{key: counts[name] for key, counts in later.items()},
            "head_dims": {
                hd: {**head_dims[hd][1][name],
                     "max_abs_err": head_dims[hd][0][name],
                     "shape": "(BH=%d, N=%d, D=%d) bf16" % (
                         *HM_HEAD_DIM_CHECKS["long"], hd)}
                for hd in HM_HEAD_DIMS},
        })
    emit("done", seconds=time.perf_counter() - t0,
         new_phases_seconds=new_s)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
