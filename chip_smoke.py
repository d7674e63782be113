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
               versions), same weights and masks. f32 runs the f32
               kernels (K1's forward, K2's dK/dV and dQ in 3xTF32), so this
               phase does not cover the bf16 kernels of the step: phase 3
               holds those.
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
               tiny presets'), 48 (zero-padded to 64), 128, 192 and 256,
               bf16 and f32, at (B*H, N) = (4, 1568) and the ragged (4,
               200), at 48 also (120, 1568),
               against their plain versions at the unpadded D with the
               same bounds and planted faults; then kernel, plain, library,
               bound and pad times at (4, 1568) for those and D = 64.
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
               B=32 with one thread, with four and with four forked
               processes (threadx1, threadx4, processx4): the first batch
               and the mean wait of the next three (a line; the gate is
               only that every mode gives the same batches' count and
               shapes).
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
               two_rank_runs): the ViT-B MOFO pretrain step at full width,
               cut to ddp_ranks.DEPTH = (4, 2) Blocks (B=8 a rank,
               update_freq 2, motion weights, masks drawn in the step), 3
               steps in f32 and in bf16; the ViT-B BB-focused MCA finetune
               step at 4 Blocks (f32, 10 classes, B=5 a rank,
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
               8, --max_frames 64) on FACTORY_VIDEOS = 2 of
               write_real_data's SSV2-style mp4
               files (256 x 320, 40-60 frames, cv2 writes them here): every
               video in the JSON with a box per frame, no SKIP line; two
               frame pairs of the shortest video through tvl1_flow on the
               card against the CPU (FLOW_CPU_MAX, FLOW_CPU_P99; with the
               count of results of each elementwise op that round
               differently on the two devices, op_roundings); two pairs
               batched against one call a pair on the card (BATCHED_ATOL),
               both timed; that video's JSON from --device cpu against
               --device cuda, both on FACTORY_CPU_FRAMES = 4 of its frames
               (--max_frames; at most FACTORY_BOX_PX per coordinate).
               Printed, not
               gated: seconds per video by stage (decode, flow, maps, boxes,
               write), flow ms per pair and per video, peak memory, and the
               mean IoU of the shortest video's per-frame boxes
               (--no_clip_union) against MemoryReader's square. Then the
               loop closed: the ViT-S MOFO
               pretrain runner, one epoch on the 4 videos at B=4 (decoded by
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
               1080, 7-frame video of a square moving rigidly, under a byte
               budget of CHUNK_PAIRS pairs (3 calls) and in one call: flows
               and per-frame boxes equal, each run's peak memory and seconds,
               the boxes' mean IoU with the square.
 28. zoo_parity - every distinct first-order zoo entry (ZOO_PARITY_OPTS:
               the 20 base names but adahessian, lookahead over adamw and
               sgd), two f32 steps each (seven for radam and lookahead:
               RAdam's rectified branch and a lookahead sync run, both
               checked) of the ViT-B pretrain at full width
               cut to 2+1 Blocks, B=1, on the card (K1/K2's f32 kernels, at
               least one launch each) and on the CPU from the same weights
               and masks: parameters, losses and gradient norms within
               ZOO_PARAM_RTOL, the parameters' change within
               ZOO_UPDATE_RTOL of the CPU's; then two AdamP updates, the
               second from gradients orthogonal to the weights in
               mofo_tpu's channel view: the change card against CPU within
               ZOO_PARAM_RTOL, and with the planted fault (the channel view
               on the port's own axis 0) beyond it.
 29. zoo_steps - the full ViT-B pretrain step (bf16, B=16, K1/K2) with
               adamw, lamb, adafactor, adamp and lookahead_adamw: ms a step
               from CUDA events over a chain of 5, the update's own ms, peak
               memory and the launches a step (16 of each, as `step`).
 30. adahessian_step - the full ViT-B pretrain step with adahessian on the
               plain attention route (bf16, B=16): no kernel launch, a
               finite loss, ms a step and peak memory; the probe z * Hz at
               2+1 Blocks in f32, card against CPU with the same injected z
               (ZOO_PARAM_RTOL); one ViT-B BB-focused MCA finetune step with
               adahessian under the fp16 loss scale (B=10): finite, not
               skipped, no kernel launch. An OOM fails the phase.
 31. zoo_runner - the ViT-S pretrain runner (phase `runner`'s flags) with
               --opt lookahead_adamp: 2 epochs; checkpoint-1 read back into
               a fresh state equals the run's own state bit for bit
               (moments, slow weights, count, parameters); then resumed for
               a third epoch, launches a step as phase `runner`'s.
 32. mesh_step - 4 ranks on cuda:0 over gloo on the (1, 2, 2) mesh
               (parallel/mesh.py; python -m mofo_tpu_torch.tools.mesh_ranks
               step) against one process at G' on the same card: the ViT-B
               MOFO pretrain at full width cut to mesh_ranks.DEPTH = (4,
               2) Blocks, B=4 a rank (G'=16), 2 steps in f32 and 3 in bf16,
               and the ViT-B BB-focused MCA finetune step at 4 Blocks (f32,
               2 a rank, mixup elem, cutmix, drop path
               0.1) for 2 steps with one validation pass and the
               multi-view merge: losses and gradient norms within
               DDP_F32_RTOL (f32) and BF16_STEP_RTOL (bf16), the parameters
               gathered whole within DDP_F32_ATOL (f32), every rank's
               launches equal to one process's (6 of each K1/K2 kernel a
               pretrain step, at 6 and 3 heads a rank); the fused qkv cut
               as a contiguous third (planted) must move the loss beyond
               DDP_F32_RTOL.
 33. mesh_memory - ViT-L (1024 wide, 16 heads; decoder 512, 8 heads) at
               full width, cut to MESH_MEMORY_DEPTH Blocks, on the 4 ranks of
               (1, 2, 2), 2 bf16 steps: each rank's bytes of parameters,
               gradients and AdamW moments against one process's and the
               share the sharding rules give (within 1%), peak memory per
               rank and step ms.
 34. mesh_runner - cli.pretrain_mofo's main in 4 processes that joined a
               gloo group on cuda:0 (mesh_ranks cli), --mesh_fsdp 2
               --mesh_model 2, ViT-B f32 (--decoder_depth 1) on 32
               synthetic clips at 4 a device, epoch 0 (2 steps) at a
               constant LR; then epoch 1
               resumed in this one process, against both epochs in one
               process fed the same global batches: the losses within
               DDP_F32_RTOL, log.txt written once, the checkpoint's names
               the reference's, the ranks' launches.
 35. mesh_zoo - the layout-reading optimizers on the 4 ranks of (1, 2, 2)
               (mesh_ranks zoo) against one process at G' on the same card:
               the ViT-B MOFO pretrain at full width cut to
               mesh_ranks.DEPTH (bf16, 4 a rank, K1/K2) for 2 steps each
               of adamw (the yardstick),
               adafactor, adamp and sgdp, then the ViT-B BB-MCA finetune
               step (f32, 2 a rank, K1/K2 and K3) for 2 steps of adamp:
               losses and gradient norms within BF16_STEP_RTOL (bf16) and
               DDP_F32_RTOL (f32), the gathered parameters' change within
               ZOO_UPDATE_RTOL of one process's, or MESH_ZOO_ADAMW_FACTOR
               times AdamW's where that is more (bf16), the parameters
               within DDP_F32_ATOL (f32), every rank's launches equal to
               one process's; a rank's step ms, peak memory and the
               collectives of the step and of its optimizer's update (calls
               and bytes a step).
 36. mesh_adahessian - adahessian on the 4 ranks of (1, 2, 2) (mesh_ranks
               adahessian) against one process at G': ViT-B widths (768 /
               384, 12 / 6 heads) at mesh_ranks.AH_DEPTH Blocks, f32, the
               plain attention route (no kernel launch), 2 a rank, 2 steps
               with z drawn in the step: losses and gradient norms within
               DDP_F32_RTOL, the probes and the parameters within
               MESH_AH_BOUND; a rank's step ms, peak memory, collectives.
 37. convergence_ab - mofo_tpu_torch.tools.convergence_ab: the ViT-B MOFO
               pretrain at full width and depth, 50 steps at B=16 on the
               JAX tool's synthetic stream (32 batches on the card), from
               one seed's f32 weights, in bf16 through K1/K2 and in f32
               through the plain attention math (TF32 off), the same masks
               in both; mofo_tpu's gates (both arms train, max rel diff
               below 2e-2, the improvements within 5%); 16 launches of
               each K1/K2 kernel a bf16 step, none in f32; the production
               arm again with a doubled learning rate (main_path.
               doubled_lr), which the gates must reject, and with K2's dQ
               zeroed (printed: how far the check reaches).
 38. convergence_ft - mofo_tpu_torch.tools.convergence_ab_finetune: the
               ViT-B classifier (174 classes, mixup, cutmix, smoothing,
               drop path 0.1), 50 steps at B=16, bf16 and fp16 (dynamic
               loss scale) through K1/K2 against f32 plain attention;
               the gates of phase 37 and the fp16 arm's max rel diff below
               2e-2; launches counted against the model's 12 attention
               Blocks a step (none in f32); each arm's peak memory.
 39. e2e_recipe - mofo_tpu_torch.tools.e2e_recipe on the card: 8 mp4 files
               that cv2 writes, the pretrain CLI (tiny model, tube masks,
               2 epochs), its last checkpoint into the finetune CLI, which
               must report the tensors it took, validation and the final
               test; finite losses, no kernel launch (8 tokens: the plain
               math).
 40. overfit_real - mofo_tpu_torch.tools.overfit_real at its defaults:
               the finetune CLI (ViT-B, B=8, lr 1e-3 as the optimizer
               sees it) in a subprocess that writes its launch counts, on 8
               class-pattern mp4 files with the crop, the flip and
               RandAugment (rand-m7-n1-mstd0.5-inc1), mixup off, for
               OVERFIT_EPOCHS = 20 epochs: the train loss must fall (the
               mean of the last 5 epochs 0.05 below the first); the tool's own
               60-epoch run, which must reach 100% validation accuracy on
               the training clips, is its recorded run; K1/K2 launches from
               the steps and the eval calls.
 41. qkv_head_dims - K1/K2's four entry points at the flat head dims
               16, 32, 128, 192 and 256 and at 48 and 96 (zero-padded to
               64 and 128) (QKV_HEAD_DIM_CHECKS: a long (B, 1568, H) with
               A % 128 == 0 and a ragged N = 100), bf16 and f32, against
               their plain versions at the unpadded D (main_path's bounds,
               the planted faults rejected); kernel, plain, library, bound
               and pad times at the long one (at 96 also ViT-B's 12 heads
               at B = 10). It runs after kernels, and mh_head_dims (K3 at 16,
               32, 128 and 192 and at 48 and 96, zero-padded, with the kv
               bias, MH_HEAD_DIM_CHECKS: the long ones at 48, 96 and 192
               the MCA's own in any_head_dim_steps; the same checks and
               times) after mh_kernels.
 42. large_presets - the registry's large geometries as whole steps
               through the port's entry points (tools/bench_pretrain_model
               and tools/bench_finetune's build): ViT-L MOFO pretrain
               (B=32), the ViT-L classifier at 224, ViT-B at 384 px and at
               32 frames, ViT-L at 384 and 512 px, at full width and depth
               and the JAX tools' batches: 3 bf16 train steps (1 warm-up,
               2 timed between CUDA events) and, for the classifiers, 2
               eval calls (1 timed); finite losses, launches equal to
               STEP_LAUNCHES / EVAL_LAUNCHES; step ms, peak memory, clips/s
               and MFU. Then each at 2 Blocks (2 + 2 for the pretrain
               model), B = 1, full width and all tokens: 2 bf16 steps
               through the kernels against the same steps through the
               plain versions, within BF16_STEP_RTOL.
 43. any_head_dim_steps - the slice's path: the ViT-B BB-focused model
               with an MCA of 8, 16 and 4 heads (mca_num_heads: K3 at head
               dim 96, zero-padded to 128, at 48, padded to 64, and at 192
               on the strip kernels; the backbone's K1/K2 at 64), full
               width and depth, through the finetune step and the eval
               step, bf16, B = 10: 3 train steps and one eval call each,
               finite losses, the launches and the zero-padding copies
               exact; then each at 2 Blocks, B = 2: 2 steps through the
               kernels against the same steps through the plain versions,
               the loss and gradient norm within BF16_STEP_RTOL and every
               attention weight's gradient within ATTN_GRAD_RTOL, which
               the same steps with K3's dQ zeroed must fail.
 44. wide_head_dims - every family above head dim 256, on the column-split
               kernels (csrc/wgmma_attn_split.cuh; f32
               csrc/wgmma_tf32_split.cuh):
               K1/K2 at (B, 1568, H, D) = (2, 2, 264 -> 320), (2, 2, 320),
               (2, 1, 512); K3 with the kv bias at (10, 3, 341 -> 384),
               (10, 2, 384), (10, 1, 768), (2, 1, 1024), the MCA's own;
               K4 at (B*H, N) = (4, 1568) with D = 320, 512, 1024; bf16
               and f32 against the plain versions at the unpadded D with
               main_path's bounds, the prep pass, and the planted faults
               (dQ zeroed, one output group left unwritten, dK's last
               group alone and out's alone left unwritten) rejected; then
               kernel, plain, library and pad times, each beside its bound
               at the least work and with the groups' recomputed S and dP
               counted, and the library call's backends (flash takes no
               head dim above 256). It runs after hm_head_dims.
 45. wide_head_dim_steps - the slice's path above 256: the BB-focused
               model with an MCA of 2 and 1 heads at ViT-B width (K3 at
               384 and 768, no copy) and of 3 heads at ViT-L's (embed_dim
               1024, 16 heads, depth 24, B = 4: K3 at 341, zero-padded to
               384), as any_head_dim_steps runs its three: 3 train steps
               and one eval call, launches and pad copies exact, finite
               losses, then at 2 Blocks against the plain versions with
               K3's dQ zeroed rejected. It runs last.
The steps of phases 5 and 11 must make no zero-padding copy (every head
dim of the main path is built).
The f32 instances: phases 3, 4 and 9 also time them (K1/K2 at the decoder
and the backbone, K3 at the MCA, K4 at the runner's decoder; bounds with
4-byte elements at PEAK_TF32X3 and, beside it, PEAK_FMA_F32; lines
k1_f32_vs_library and k2_f32_vs_library, the latter with the backward's
delta reduction); qkv_head_dims checks f32 at scale 0.1 on each ragged
geometry; after it, f32_precision holds K1's forward and K2's dK/dV and
dQ (3xTF32 on wgmma) against a float64 run (each output within
PRECISION_FACTOR of the plain f32 version's error, the plain version with
TF32 on beyond it) at every head dim they take and the ViT-B decoder, and
K3's forward, dK/dV and dQ at every head dim (3xTF32, D streamed in
64-column chunks at 256 and 192) at MH_F32_PRECISION_CHECKS with the kv
bias, K4's two-pass forward at 64, 128 and 256 (HM_F32_PRECISION_CHECKS),
and above 256 the column-split 3xTF32 forward and backward of K1/K2
(d320), K3 (the MCA at 2 and 1 heads, ragged, N = 1) and K4
(HM_F32_PRECISION_CHECKS), the 1xTF32 fault beyond the bound on
dQ everywhere and on out, lse, dK and dV at F32_FAULT_BEYOND; after vis,
f32_eval
times feature_extract's forward (B = 4) and the f32 ViT-B step, launches
held exactly.
The kernels phase also checks and times K1/K2 at the mesh's per-rank
head counts (MESH_GEOS: H = 3, the ViT-B decoder at model 2; H = 4 and 8,
ViT-L's decoder and encoder) and at ViT-L's 16 heads over the 4608 and
8192 tokens of vit_large_patch16_384 and _512 (LARGE_CHECKS). Every
phase line carries "t", the seconds since the script started. The streams
of phases 37 and 38 (the JAX tools' numpy draws, a minute of one host core
each) are drawn on two threads from the build until real_data_runner
(draw_ab_streams), whose process workers fork.
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
import threading
import time
import warnings
from unittest import mock

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
from mofo_tpu_torch.parallel import mesh as mesh_lib
from mofo_tpu_torch.tools import bench_finetune as BF
from mofo_tpu_torch.tools import bench_pretrain_model as BP
from mofo_tpu_torch.tools import convergence_ab as CA
from mofo_tpu_torch.tools import convergence_ab_finetune as CF
from mofo_tpu_torch.tools import ddp_ranks, e2e_recipe, mesh_ranks
from mofo_tpu_torch.tools import overfit_real
from mofo_tpu_torch.tools.main_path import (
    AUG_ATOL,
    AUG_SHARE,
    FINETUNE_MODEL,
    MODEL,
    PRECISION_FACTOR,
    SPLIT_GROUP,
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
    count_pads,
    doubled_lr,
    f32_precision,
    finetune_model,
    forced_draws,
    frame_ids,
    group_unwritten,
    hm_attention_against_plain,
    hm_inputs,
    hm_planted_faults,
    masked_kv_grad,
    memory_box_json,
    mh_attention_against_plain,
    hm_f32_precision,
    mh_f32_precision,
    mh_inputs,
    moved_draws,
    plain_attention,
    planted_faults,
    synthetic_batch,
    synthetic_clips_u8,
    synthetic_finetune_batch,
)
from mofo_tpu_torch.train import checkpoint as ckpt
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
# f32: the fastest f32-accurate products on the card are 3xTF32 on the
# tensor cores (495 TFLOP/s dense TF32, three products each), the bound the
# f32 kernels are held under; the FMA rate outside the tensor cores beside it
PEAK_TF32X3 = 495e12 / 3
PEAK_FMA_F32 = 67e12
HBM = 3.35e12  # H100 SXM bytes/s
STEP_BATCH = 16
# (B, N, H) of the main path's attention at STEP_BATCH; the checks add a
# ragged geometry, the long sequences the TPU kernels are gated at
# (tests/test_tpu_kernels.py:302-321: 32 frames at 224^2 with 6 and 12
# heads, 16 frames at 384^2) and ViT-L's 16 heads
MAIN = {"encoder": (STEP_BATCH, 160, 12), "decoder": (STEP_BATCH, 1568, 6),
        "backbone": (10, 1568, 12)}  # the finetune backbone's Blocks
# the heads a rank of the (1, 2, 2) mesh holds (B = 8 rows a batch
# coordinate): the ViT-B decoder's 6 at model 2 (A = 192 a rank, qkv rows
# of 576 bf16: a 1152-byte TMA pitch), ViT-L's decoder (8 -> 4) and encoder
# (16 -> 8, the 160 visible tokens)
MESH_GEOS = {"mesh_vitb_decoder_h3": (8, 1568, 3),
             "mesh_vitl_decoder_h4": (8, 1568, 4),
             "mesh_vitl_encoder_h8": (8, 160, 8)}
# the registry's largest token grids at ViT-L's 16 heads, one clip each:
# vit_large_patch16_384 (4608 tokens) and vit_large_patch16_512 (8192)
LARGE_CHECKS = {"res384_vitl_h16": (1, 4608, 16), "res512_h16": (1, 8192, 16)}
# the 3xTF32 kernels' precision check (phase f32_precision): (B, N, H, D)
# at every head dim they take, and the ViT-B decoder's own
F32_PRECISION_CHECKS = {"d16": (2, 1568, 8, 16), "d32": (2, 1568, 6, 32),
                        "d64": (2, 1568, 6, 64), "d128": (2, 1568, 4, 128),
                        "decoder": (STEP_BATCH, 1568, 6, 64),
                        # above 256: K3's column-split kernels
                        "d320": (2, 1568, 2, 320)}
# and K3's 3xTF32 kernels (dQ at every head dim; the forward and dK/dV at
# 192 and 256, D streamed in 64-column chunks), with the kv bias and k, v
# column views of one fused kv: (B, N, H, D) the MCA at a reduced batch,
# the MCA at 4, 8 and 16 heads (the narrow dQ at 128 and 64), the ragged
# one and N = 1 (held there to the against-plain bounds: the plain version
# is exact at one kv column, and TF32 does not change it)
MH_F32_PRECISION_CHECKS = {"mca_b4": (4, 1568, 3, 256),
                           "mca_h4_d192": (4, 1568, 4, 192),
                           "mca_h8_d128": (4, 1568, 8, 128),
                           "mca_h16_d64": (4, 1568, 16, 64),
                           "ragged_d256": (4, 100, 1, 256),
                           "n1_d256": (4, 1, 1, 256),
                           # the column-split kernels: the MCA at 2 and 1
                           # heads, ragged, N = 1
                           "mca_h2_d384": (4, 1568, 2, 384),
                           "mca_h1_d768": (2, 1568, 1, 768),
                           "ragged_d384": (4, 100, 1, 384),
                           "n1_d384": (4, 1, 1, 384)}
# and K4's 3xTF32 forwards (B*H, N, D): the two-pass narrow one at 64 and
# 128, the column-split one at one group at 256 (ragged), and the
# column-split kernels above 256
HM_F32_PRECISION_CHECKS = {"d64": (4, 1568, 64), "d128": (4, 1568, 128),
                           "ragged_d256": (4, 100, 256),
                           "d320": (4, 1568, 320), "d512": (4, 1568, 512)}
# f32_precision's geometries at which the 1xTF32 fault must land beyond
# the bound on other outputs too (on dQ it must everywhere): on out and
# lse at every geometry above N = 1, and on dK and dV at the column-split
# ones, at K3's 8 x 128 and 16 x 64 and at K4's up to 256, where the FMA
# kernels' runs of the same check (NVIDIA H100 80GB HBM3, 700.00 W)
# showed it beyond (the fault is the plain version with TF32 on: no
# kernel moves it)
F32_FAULT_BEYOND = {
    **dict.fromkeys(
        ("d16", "d32", "d64", "d128", "decoder", "k3_mca_b4",
         "k3_mca_h4_d192", "k3_ragged_d256"), ("out", "lse")),
    **dict.fromkeys(
        ("d320", "k3_mca_h2_d384", "k3_mca_h1_d768", "k3_ragged_d384",
         "k3_mca_h8_d128", "k3_mca_h16_d64", "k4_d64", "k4_d128",
         "k4_ragged_d256", "k4_d320", "k4_d512"),
        ("out", "lse", "dk", "dv"))}
# K1/K2's f32 instances are timed at the bf16 rows' main shapes (K3's at
# the MCA, K4's at the runner's decoder: each family's timed geometry)
F32_TIMED = ("decoder", "backbone")
CHECKS = {**MAIN, "ragged": (8, 100, 2), "frames32_h6": (2, 3136, 6),
          "frames32_h12": (2, 3136, 12), "res384_h12": (1, 4608, 12),
          "vitl_h16": (2, 1568, 16), **MESH_GEOS, **LARGE_CHECKS}
# K1/K2 at the flat head dims besides 64: built (16, 32, 128; 192 and 256
# through K3's strip kernels) and zero-padded (48 -> 64, 96 -> 128); (B, N,
# H), a long geometry (1568 tokens, A % 128 == 0) and a ragged one; times
# at the long one; at 96 also ViT-B's 12 heads at the finetune batch. Above
# 256 the column-split kernels take D (phase wide_head_dims).
QKV_FLAT_HEAD_DIMS = (16, 32, 48, 96, 128, 192, 256)
QKV_HEAD_DIM_CHECKS = {16: {"long": (2, 1568, 16), "ragged": (4, 100, 8)},
                       32: {"long": (2, 1568, 12), "ragged": (4, 100, 4)},
                       48: {"long": (2, 1568, 8), "ragged": (4, 100, 8)},
                       96: {"long": (2, 1568, 12), "ragged": (4, 100, 4),
                            "vitb_b10": (10, 1568, 12)},
                       128: {"long": (2, 1568, 12), "ragged": (4, 100, 2)},
                       192: {"long": (2, 1568, 4), "ragged": (4, 100, 2)},
                       256: {"long": (2, 1568, 4), "ragged": (4, 100, 1)}}
FT_BATCH = 10
# K3: (B, N, H, D); the MCA is the finetune step's own
MH_CHECKS = {"mca": (FT_BATCH, 1568, 3, 256), "h12": (FT_BATCH, 1568, 12, 64),
             "ragged_d256": (4, 100, 1, 256), "ragged_d64": (4, 100, 2, 64),
             "frames32_h12": (2, 3136, 12, 64)}
# K3 at the other head dims, with the bias: built (16, 32, 128, 192) and
# zero-padded (48 -> 64, 96 -> 128); (B, N, H), a long and a ragged one;
# the long ones at 48, 96 and 192 are the MCA's own at 16, 8 and 4 heads
# (any_head_dim_steps)
MH_HEAD_DIMS = (16, 32, 48, 96, 128, 192)
MH_HEAD_DIM_CHECKS = {16: {"long": (2, 1568, 8), "ragged": (4, 100, 2)},
                      32: {"long": (2, 1568, 6), "ragged": (4, 100, 2)},
                      48: {"long": (FT_BATCH, 1568, 16),
                           "ragged": (4, 100, 2)},
                      96: {"long": (FT_BATCH, 1568, 8),
                           "ragged": (4, 100, 2)},
                      128: {"long": (2, 1568, 6), "ragged": (4, 100, 1)},
                      192: {"long": (FT_BATCH, 1568, 4),
                            "ragged": (4, 100, 1)}}
VITS_BATCH = 32  # B*H = 96 in the ViT-S decoder, as ViT-B's at B=16
# K4: (B, H, N); the runner's decoder is the main path's own
HM_CHECKS = {"runner_decoder": (VITS_BATCH, 3, 1568),
             "tpu_gated": (2, 6, 1568), "ragged": (4, 3, 100),
             "frames32": (2, 6, 3136)}
# K4 at the tiny presets' head dims (32 in the encoders, 16 in the
# decoder), 48 (zero-padded to 64), 128, 192 and 256: (B*H, N), a long and
# a ragged one; times at the first, D = 64 beside them; at 48 also 12 heads
# at the finetune batch (HM_WIDE_CHECKS)
HM_HEAD_DIMS = (16, 32, 48, 128, 192, 256)
HM_HEAD_DIM_CHECKS = {"long": (4, 1568), "ragged": (4, 200)}
HM_WIDE_CHECKS = {48: {"bh120": (12 * FT_BATCH, 1568)}}
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
# the registry's large geometries as whole steps (phase large_presets):
# label -> (bench tool, its flags; the tools' batch rules give B), and the
# K1/K2 launches of each a train step and an eval call: every Block (ViT-L
# pretrain: 24 encoder + 4 decoder)
LARGE_PRESETS = {
    "vitl_pretrain": ("pretrain", ["--model", "large"]),
    "vitl_224": ("finetune", ["--model", "large"]),
    "vitb_384": ("finetune", ["--img", "384"]),
    "vitb_32f": ("finetune", ["--frames", "32"]),
    "vitl_384": ("finetune", ["--model", "large", "--img", "384"]),
    "vitl_512": ("finetune", ["--model", "large", "--img", "512"]),
}
LARGE_BLOCKS = {"vitl_pretrain": 28, "vitl_224": 24, "vitb_384": 12,
                "vitb_32f": 12, "vitl_384": 24, "vitl_512": 24}
STEP_LAUNCHES.update({
    label: {**dict.fromkeys(fa.KERNELS, 0),
            **dict.fromkeys(fa.QKV_KERNELS, n)}
    for label, n in LARGE_BLOCKS.items()})
EVAL_LAUNCHES.update({
    label: {**dict.fromkeys(fa.KERNELS, 0), "qkv_attn_fwd": n}
    for label, n in LARGE_BLOCKS.items()
    if LARGE_PRESETS[label][0] == "finetune"})
# the slice's path (any_head_dim_steps): the ViT-B BB-focused finetune
# model with an MCA of 8, 16 and 4 heads (mca_num_heads, a keyword of both
# packages' create_model): its K3 at head dims 96 (-> 128) and 48 (-> 64),
# zero-padded, and 192, built; the backbone's K1/K2 at 64 as on the main
# path. Launches as FINETUNE_MODEL's; the zero-padding copies of a train
# step (the MCA's q, k, v and its dout) and of an eval call (q, k, v)
HEAD_DIM_MODELS = {"bb_mca_8_heads": 8, "bb_mca_16_heads": 16,
                   "bb_mca_4_heads": 4}
HEAD_DIM_PADS = {"bb_mca_8_heads": (4, 3), "bb_mca_16_heads": (4, 3),
                 "bb_mca_4_heads": (0, 0)}
HEAD_DIM_STEPS = 3
HEAD_DIM_CHECK_DEPTH = 2
# above head dim 256, the column-split kernels (phase wide_head_dims): each
# family against its plain version, bf16 and f32, the MCA's own geometries
# among them. K1/K2 at D -> (B, N, H), 264 padded to 320; K3 with the kv
# bias at the BB-focused MCA's 3 heads at ViT-L width (341, padded to 384),
# 2 and 1 heads at ViT-B's (384, 768) and D = 1024; K4 at D -> (B*H, N)
WIDE_QKV_CHECKS = {264: (2, 1568, 2), 320: (2, 1568, 2), 512: (2, 1568, 1)}
WIDE_MH_CHECKS = {341: (FT_BATCH, 1568, 3), 384: (FT_BATCH, 1568, 2),
                  768: (FT_BATCH, 1568, 1), 1024: (2, 1568, 1)}
WIDE_HM_CHECKS = {320: (4, 1568), 512: (4, 1568), 1024: (4, 1568)}
# the slice's path above 256 (wide_head_dim_steps): the BB-focused model
# with an MCA of 2 and 1 heads at ViT-B width (K3 at 384 and 768, no copy)
# and of 3 heads at ViT-L's (embed_dim 1024, 16 backbone heads, depth 24;
# K3 at 341, zero-padded to 384): label -> (mca_num_heads, (embed_dim,
# num_heads) or None for ViT-B's, batch, depth). ViT-L width runs at
# B = WIDE_VITL_BATCH: the phase needs the path's launches, losses and
# gradients, and each clip of ViT-L's 24 Blocks costs script time
WIDE_VITL_BATCH = 4
WIDE_HEAD_DIM_MODELS = {
    "bb_mca_2_heads": (2, None, FT_BATCH, 12),
    "bb_mca_1_head": (1, None, FT_BATCH, 12),
    "bb_vitl_mca_3_heads": (3, (1024, 16), WIDE_VITL_BATCH, 24)}
WIDE_HEAD_DIM_PADS = {"bb_mca_2_heads": (0, 0), "bb_mca_1_head": (0, 0),
                      "bb_vitl_mca_3_heads": (4, 3)}
# the 2-Block kernels-against-plain check reads each attention weight's
# gradient (the Blocks' qkv and proj, the MCA's q, kv and proj): its
# relative L2 error against the plain versions' may not pass the kernel
# checks' bf16 gradient bound (main_path, allclose 3e-2), and K3's dQ
# zeroed must pass it
ATTN_LEAF = re.compile(r"\.attn\.(qkv|q|kv|proj)\.weight$")
ATTN_GRAD_RTOL = 3e-2
LARGE_STEPS = 3  # 1 warm-up + 2 timed
LARGE_EVALS = 2  # 1 warm-up + 1 timed
# the depth of the kernels-against-plain steps: the plain versions keep
# (B, H, N, N) f32 scores, 4.3 GB a Block at 8192 tokens and 16 heads
LARGE_CHECK_DEPTH = 2
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
D = 64  # the registry presets' head dim
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
# the factory: 2 videos (8, then 4, before later phases needed the time:
# the same checks on fewer videos), TV-L1 on the card against the CPU on two
# pairs (the
# same elementwise ops in the same order on both devices, each rounding
# alike, op_roundings shows it: bits are expected, the bounds are the ones
# the slice was specified with), batched against one call a pair (the same
# ops on the same values), the boxes of --device cuda against --device cpu
# (a uint8 map level may flip)
FACTORY_VIDEOS = 2
FACTORY_BATCH = 2
# the frames (stride-sampled) of the factory's card-against-CPU run: the
# CPU's TV-L1 takes 2-5 s a pair, and the script has a time limit
FACTORY_CPU_FRAMES = 4
# the pairs batched against one call a pair (a timed comparison)
FACTORY_BATCHED_PAIRS = 2
FLOW_CPU_MAX = 1e-3
FLOW_CPU_P99 = 1e-4
BATCHED_ATOL = 1e-5
FACTORY_BOX_PX = 2
# vis in f32: the card's reconstruction against the CPU's, pixels in [0, 1]
# (attention_vis: its maps, scaled to a max of 1)
VIS_ATOL = 1e-4
# phase f32_eval: feature_extract's default model and batch (f32 by default)
F32_EVAL_MODEL = "vit_base_patch16_224_feature_ext"
F32_EVAL_BATCH = 4
F32_EVAL_REPS = 3
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
# the factory on a 1080p video whose square moves rigidly: 6 pairs, at
# most CHUNK_PAIRS a call under the forced budget (3 calls; 15 pairs at 5
# a call, then 9 at 3, before the script needed the time)
CHUNK_HW = (1080, 1920)
CHUNK_FRAMES = 7
CHUNK_PAIRS = 2
SQUARE = 360
SQUARE_STEP = (6, 4)  # px a frame, (x, y)
# the optimizer zoo (phases zoo_parity, zoo_steps, adahessian_step,
# zoo_runner): every distinct first-order entry of mofo_tpu's 30 names (the
# fused* and nvnovograd aliases left out), lookahead over two of them
ZOO_PARITY_OPTS = ("adamw", "adam", "sgd", "nesterov", "momentum", "lamb",
                   "adafactor", "rmsprop", "adadelta", "lars", "lion",
                   "nadam", "radam", "novograd", "adamax", "adagrad",
                   "adabelief", "yogi", "adamp", "sgdp", "lookahead_adamw",
                   "lookahead_sgd")
# two updates each: the second already runs from non-zero moments, and a
# third would push the script past 800 s with the mesh phases
ZOO_PARITY_STEPS = 2
# where a branch starts later: lookahead syncs at update 6, and RAdam
# rectifies from rho_t >= 5 (rho_t = 5.7 at update 6 with b2 = 0.95)
ZOO_PARITY_LONG = ("radam", "lookahead_adamw", "lookahead_sgd")
ZOO_PARITY_LONG_STEPS = 7
LOOKAHEAD_K = 6
# card against CPU in f32: ||card - CPU|| / ||CPU|| over the parameters (and
# the probe), and the loss and gradient norm, within the f32 step bound
ZOO_PARAM_RTOL = 1e-4
# and the parameters' change, card against CPU, relative to the CPU's: an
# update skipped, doubled or of the wrong sign is off by 1 or more, while
# Lion's signs may flip where their argument is ~0 (~1e-3 at ViT-B width)
ZOO_UPDATE_RTOL = 1e-2
ZOO_STEP_OPTS = ("adamw", "lamb", "adafactor", "adamp", "lookahead_adamw")
ZOO_STEP_CHAIN = 5  # timed steps between two CUDA events
ADAHESSIAN_CHAIN = 3
ZOO_RUNNER_OPT = "lookahead_adamp"
# mesh_memory: ViT-L's (encoder, decoder) Blocks (its full depth, 24 and
# 4, spent the script's time; every Block shards alike); each rank's state
# bytes against the share the sharding rules give it
MESH_MEMORY_DEPTH = (8, 2)
MESH_MEMORY_RTOL = 0.01
# mesh_runner: ViT-B f32 (its decoder cut to MESH_RUNNER_DECODER Blocks) on
# 32 synthetic clips, 4 a device on the mesh and 16 in one process (G' = 16,
# 2 steps an epoch), at a constant LR (the scaled lr, 1.6e-4 * 16 / 256, is
# the min_lr): a run of --epochs 1 resumed with --epochs 2 steps as one of
# --epochs 2 does
MESH_RUNNER_DECODER = 1
MESH_RUNNER_ARGS = ["--model", MODEL, "--decoder_depth",
                    str(MESH_RUNNER_DECODER), "--synthetic", "32", "--dtype",
                    "float32", "--save_ckpt_freq", "1", "--warmup_epochs",
                    "0", "--lr", "1.6e-4", "--min_lr", "1e-5"]
# mesh_zoo, bf16: the parameters' change against one process's, relative to
# it, within ZOO_UPDATE_RTOL or within this many times AdamW's on the same
# ranks, batch and steps (AdamW has no stage that reads a layout; its own
# change sits 1.08e-2 off, from the batch coordinates' bf16 gradients
# rounded before they are summed, which sign-like first updates carry in
# full where a gradient element is near 0)
MESH_ZOO_ADAMW_FACTOR = 2.0
# mesh_adahessian: the probes (each tensor's largest error over its largest
# magnitude) and the parameters (absolute), ranks against one process, as
# two gloo ranks are held on the CPU (tests/test_torch_second_order.py)
MESH_AH_BOUND = 1e-4
# the convergence A/B phases: mofo_tpu's 50-step artifacts at its B=16
CONV_STEPS = 50
CONV_BATCH = 16
# overfit_real: the tool's own 60 epochs reach 100% (its recorded run,
# tests/golden/torch_overfit_real_h100.json); this script, near its time
# limit, runs OVERFIT_EPOCHS and checks that the train loss falls: the mean
# of the last OVERFIT_TAIL epochs at least OVERFIT_DROP below the first
# epoch's (a run that stalls at the uniform prediction's ln 4 stays within
# 0.02 of it)
OVERFIT_FULL = 60
OVERFIT_EPOCHS = 20
OVERFIT_TAIL = 5
OVERFIT_DROP = 0.05
ROOT = os.path.dirname(os.path.abspath(__file__))


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 2),
                      **fields}), flush=True)


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


def _qkv(B, N, H, dtype, seed, d: int = D):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * H * d, generator=g).to(dtype).cuda()


def check_kernels(x, H, scale: float = SCALE) -> dict:
    """Each kernel against its plain version on qkv x (main_path's bounds;
    raises beyond them), in bf16 the backward's prep pass too. The same
    bounds must reject two planted faults, dQ zeroed and dK without its
    1/log2(e) fix."""
    got, want = attention_against_plain(x, H, scale)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    if x.dtype == torch.bfloat16:  # at the width the kernels ran D at
        xw, out = got["at_width"]
        res["prep"] = check_prep(xw, out, (2 * out.float()).to(x.dtype), H,
                                 scale)
    res["planted"] = {}
    for fault, outputs in split_faults(planted_faults(got), got, H,
                                       x.shape[-1] // (3 * H)).items():
        caught = compare_with_plain(outputs, want)
        if not caught["beyond_bounds"]:
            raise AssertionError(f"the bounds let a planted fault pass: "
                                 f"{fault}")
        res["planted"][fault] = {
            "beyond_bounds": caught["beyond_bounds"],
            "max_abs_err": {k: caught["max_abs_err"][k] for k in ("dq", "dk")},
        }
    return res


def split_faults(faults: dict, got: dict, heads: int, d: int) -> dict:
    """`faults` and, at a head dim above 256 (the column-split kernels),
    the last output group of every head left unwritten
    (main_path.group_unwritten), dK's last group alone (its blocks are not
    dV's) and the forward's last group alone on out."""
    if fa.head_dim_width(d) > fa.HEAD_DIMS[-1]:
        faults["group_unwritten"] = group_unwritten(got, heads)
        faults["dk_group_unwritten"] = group_unwritten(got, heads, ("dk",))
        faults["out_group_unwritten"] = group_unwritten(got, heads, ("out",))
    return faults


def split_groups(d: int) -> int:
    """The output groups the column-split kernels split head dim d into
    (0 at a head dim up to 256, which they do not run)."""
    w = fa.head_dim_width(d)
    return 0 if w <= fa.HEAD_DIMS[-1] else -(-w // SPLIT_GROUP)


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


def least_times(work: dict, peak: float = PEAK_BF16) -> dict:
    """name -> (least ms, what bounds it) for name -> (FLOPs, bytes), the
    FLOPs at `peak` FLOP/s."""
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def products(groups: int, two_pass: bool = False) -> dict:
    """The (N x N x d) products of each kernel's work: at its least
    (groups = 0: S and P.V forward, 4 in dK/dV, 3 in dQ), or as the
    column-split kernels do it at `groups` output groups, each group forming
    S (and dP) again: the forward G S + P.V (K4's two passes 2 G S + P.V),
    dK/dV 2 G S^T (both warpgroups) + G dP^T + dV + dK, dQ G S + G dP + dQ."""
    if not groups:
        return {"fwd": 2, "dkv": 4, "dq": 3}
    return {"fwd": (2 if two_pass else 1) * groups + 1,
            "dkv": 3 * groups + 2, "dq": 2 * groups + 1}


def bounds(B, N, H, d: int = D, groups: int = 0, e: int = 2,
           peak: float = PEAK_BF16) -> dict:
    """Least time (ms) for each kernel's work on an H100 SXM: the larger of
    its FLOPs over `peak` (the bf16 tensor peak) and its bytes (each input
    read once, each output written once, e bytes an element) over HBM
    bandwidth; with `groups` the products the column-split kernels do
    (products())."""
    A = H * d
    mm = 2 * B * H * N * N * d  # one (N x N x d) product
    n = products(groups)
    qkv, row = B * N * 3 * A * e, B * N * A * e
    stat = B * H * N * 4
    work = {
        # S, P.V -> out, lse
        "qkv_attn_fwd": (n["fwd"] * mm, qkv + row + stat),
        # q, out, dout -> q * scale, delta
        "qkv_attn_bwd_prep": (2 * B * N * A + B * N * A, 3 * row + row + stat),
        # k, v, q * scale, dout, lse, delta -> dk, dv
        "qkv_attn_bwd_dkv": (n["dkv"] * mm, 4 * row + 2 * stat + 2 * row),
        "qkv_attn_bwd_dq": (n["dq"] * mm, 4 * row + 2 * stat + row),  # -> dq
    }
    return least_times(work, peak)


def pad_times(run, xs, grads, dout, groups, heads: int) -> dict:
    """The zero-padding copies' time (ms) of a kernel family at a head dim
    without a kernel: fa.fwd_at_width's and fa.bwd_at_width's own copies
    (inputs xs in, out back; dout in, the gradients back) around launchers
    that return the outputs `run` (fwd_at_width's return) and `grads` at
    once. {"fwd": ms, "bwd": ms}, or {} at a built head dim."""
    xs_w, out, lse, out_d = run
    if out.shape == out_d.shape:
        return {}
    return {"fwd": time_ms(lambda: fa.fwd_at_width(
                lambda *a: (out, lse), xs, groups, heads)),
            "bwd": time_ms(lambda: fa.bwd_at_width(
                lambda *a: grads, xs_w, out, lse, dout, groups, heads))}


def _with_pad_times(res: dict, pads: dict, fwd_name: str) -> None:
    for name in res:
        if pads:
            res[name]["pad_ms"] = pads["fwd" if name == fwd_name else "bwd"]


def with_bounds(res: dict, bound_fn, dtype, *shape) -> dict:
    """Puts bound_fn(*shape)'s least time of each kernel in res into it
    (bf16: 2-byte elements at the bf16 tensor peak; f32: 4-byte elements
    at PEAK_TF32X3, and at PEAK_FMA_F32 beside it as bound_fma_ms); raises
    if a kernel beat its bound."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    fma = bound_fn(*shape, e=e, peak=PEAK_FMA_F32) if f32 else {}
    for name, (bound, by) in bound_fn(
            *shape, e=e, peak=PEAK_TF32X3 if f32 else PEAK_BF16).items():
        if name not in res:  # the prep passes run in bf16 only
            continue
        res[name].update(bound_ms=bound, bound_by=by)
        if f32:
            res[name].update(bound_fma_ms=fma[name][0],
                             bound_fma_by=fma[name][1])
        if res[name]["ms"] < bound:
            raise AssertionError(f"{name} beat its bound: {res[name]}")
    return res


def time_kernels(x, H) -> dict:
    """kernel, plain, library and bound times (ms) on qkv x (head dim d =
    x's width / 3H, scale d^-1/2), bf16 or f32 (in f32 no prep pass: the
    dK/dV row carries "delta_ms", the time of _qkv_prep's reduction, and
    the library call is F.scaled_dot_product_attention's f32 backend).
    At a d without a kernel the kernels
    run on x zero-padded to their width as flash_attention_qkv runs them
    (fa.fwd_at_width; their times are the padded calls'), "pad_ms" is the
    padding copies' time (pad_times), and the plain versions, the library
    call and the bound take d itself."""
    dtype = x.dtype
    B, N, A3 = x.shape
    d = A3 // (3 * H)
    scale = d ** -0.5
    run = fa.fwd_at_width(fa.qkv_attn_fwd, (x,), fa.QKV_GROUPS, H, scale, H)
    (xw,), out, lse, out_d = run
    dout, dout_d = ((2 * t.float()).to(dtype) for t in (out, out_d))
    dqkv = torch.empty_like(xw)
    q, k, v = (t.contiguous().requires_grad_(True)
               for t in fa.split_heads(x, H))
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=scale)
    g_lib = dout_d.reshape(B, N, H, d).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_qkv_bwd_plain(
        x, out_d, lse, dout_d, scale, H), runs=10)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (q, k, v), g_lib, retain_graph=True))
    f32 = dtype == torch.float32
    prep = fa._qkv_prep(xw, out, dout, scale, H)
    res = {
        "qkv_attn_fwd": {
            "ms": time_ms(lambda: fa.qkv_attn_fwd(xw, scale, H)),
            "plain_ms": time_ms(
                lambda: fa.attention_qkv_fwd_plain(x, scale, H), runs=10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q.detach(), k.detach(), v.detach(), scale=scale)),
        },
        "qkv_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dkv(
                xw, out, lse, dout, dqkv, scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "qkv_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_dq(
                xw, out, lse, dout, dqkv, scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    if f32:
        res["qkv_attn_bwd_dkv"]["delta_ms"] = time_ms(
            lambda: fa._qkv_prep(xw, out, dout, scale, H))
    else:  # no one library call computes delta and the scaled q alone
        res["qkv_attn_bwd_prep"] = {
            "ms": time_ms(lambda: fa.qkv_attn_bwd_prep(
                xw, out, dout, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_qkv_bwd_prep_plain(
                x, out_d, dout_d, scale, H)),
            "library_ms": None,
        }
    _with_pad_times(res, pad_times(run, (x,), dqkv, dout_d, fa.QKV_GROUPS,
                                   H), "qkv_attn_fwd")
    return with_bounds(res, bounds, dtype, B, N, H, d)


def qkv_errors(res: dict) -> dict:
    """Each K1/K2 entry point's largest error from check_kernels' bf16
    result."""
    err = res["max_abs_err"]
    return {"qkv_attn_fwd": err["out"],
            "qkv_attn_bwd_prep": res["prep"]["max_abs_err"],
            "qkv_attn_bwd_dkv": max(err["dk"], err["dv"]),
            "qkv_attn_bwd_dq": err["dq"]}


def phase_qkv_head_dims(smi: str) -> dict:
    """F7 and its remainder: K1/K2's four entry points at the flat head dims
    QKV_FLAT_HEAD_DIMS (48 and 96 zero-padded to 64 and 128, 192 and 256
    through K3's strip kernels) against their plain versions at the
    unpadded D (check_kernels' bounds and planted faults; the scale D^-0.5,
    which is a power of two only at 16, 64 and 256: elsewhere dQ's
    scaled-K copy up to 128 and the in-place fold above) at
    QKV_HEAD_DIM_CHECKS, bf16 and f32; kernel, plain, library, bound and
    pad times at the long geometry in bf16 (above 256: phase
    wide_head_dims). Returns {D: (max errors, times)}."""
    out = {}
    for hd in QKV_FLAT_HEAD_DIMS:
        for i, (geo, (B, N, heads)) in enumerate(
                QKV_HEAD_DIM_CHECKS[hd].items()):
            for dtype in (torch.bfloat16, torch.float32):
                x = _qkv(B, N, heads, dtype, hd + i, d=hd)
                res = check_kernels(x, heads, hd ** -0.5)
                emit("qkv_head_dims_vs_plain", D=hd,
                     width=fa.head_dim_width(hd), geometry=geo, B=B, N=N,
                     H=heads, dtype=str(dtype).replace("torch.", ""), **res)
                if geo == "ragged" and dtype == torch.float32:
                    emit("qkv_head_dims_vs_plain", D=hd,
                         width=fa.head_dim_width(hd), geometry=geo, B=B,
                         N=N, H=heads, dtype="float32", scale=0.1,
                         **check_kernels(x, heads, 0.1))
                if geo == "long" and dtype == torch.bfloat16:
                    times = time_kernels(x, heads)
                    emit("qkv_head_dim_times", D=hd,
                         width=fa.head_dim_width(hd), B=B, N=N, H=heads,
                         dtype="bfloat16", times=times, nvidia_smi=smi)
                    out[hd] = (qkv_errors(res), times)
                del x
    return out


def f32_ratios(times: dict, fwd: str, bwd: tuple) -> dict:
    """The f32 rows over the library's f32 call: the forward, and the
    backward's kernels plus its delta reduction over the library's
    backward."""
    dkv = times[bwd[0]]
    return {"fwd": times[fwd]["ms"] / times[fwd]["library_ms"],
            "bwd": (dkv.get("delta_ms", 0.0) + sum(times[n]["ms"]
                                                  for n in bwd))
            / dkv["library_ms"]}


def phase_f32_precision(smi: str) -> dict:
    """The 3xTF32 kernels (K1's f32 forward, K2's f32 dK/dV and dQ)
    against one float64 run at F32_PRECISION_CHECKS (every head dim they take, and
    the ViT-B decoder): each output's error within PRECISION_FACTOR of
    the plain f32 version's (TF32 off), and the plain version with TF32
    on (1xTF32, the planted fault) beyond it (main_path.f32_precision);
    then K3's at MH_F32_PRECISION_CHECKS (main_path.mh_f32_precision; at
    N = 1 the against-plain bounds) and K4's at HM_F32_PRECISION_CHECKS
    (main_path.hm_f32_precision); the fault beyond the bound on dQ and, at
    F32_FAULT_BEYOND's geometries, on dK and dV (fault_caught). Returns
    {label: each output's error over the plain version's}."""
    out = {}
    for label, (B, N, H, d) in F32_PRECISION_CHECKS.items():
        res = f32_precision(_qkv(B, N, H, torch.float32, seed=5, d=d), H,
                            d ** -0.5)
        emit("f32_precision", geometry=label, B=B, N=N, H=H, D=d,
             factor=PRECISION_FACTOR, nvidia_smi=smi, **res)
        if not fault_caught(label, res):
            raise AssertionError(f"f32 precision at {label}: {res}")
        out[label] = res["over_plain"]
    for label, (B, N, H, d) in MH_F32_PRECISION_CHECKS.items():
        q, k, v, b = mh_inputs(B, N, H, d, torch.float32, 5, "cuda")
        res = mh_f32_precision(q, k, v, b, H, d ** -0.5)
        if N == 1:  # one kv column: out = v exactly in the plain version
            got, want = mh_attention_against_plain(q, k, v, b, H, d ** -0.5)
            res["against_plain"] = compare_with_plain(got, want)
            ok = not res["against_plain"]["beyond_bounds"]
        else:
            ok = fault_caught(f"k3_{label}", res)
        emit("f32_precision", geometry=f"k3_{label}", B=B, N=N, H=H, D=d,
             factor=PRECISION_FACTOR, nvidia_smi=smi, **res)
        if not ok:
            raise AssertionError(f"K3 f32 precision at {label}: {res}")
        out[f"k3_{label}"] = res["over_plain"]
    for label, (BH, N, d) in HM_F32_PRECISION_CHECKS.items():
        q, k, v = hm_inputs(BH, N, torch.float32, 5, "cuda", D=d)
        res = hm_f32_precision(q, k, v, d ** -0.5)
        emit("f32_precision", geometry=f"k4_{label}", BH=BH, N=N, D=d,
             factor=PRECISION_FACTOR, nvidia_smi=smi, **res)
        if not fault_caught(f"k4_{label}", res):
            raise AssertionError(f"K4 f32 precision at {label}: {res}")
        out[f"k4_{label}"] = res["over_plain"]
    return out


def fault_caught(geometry: str, res: dict) -> bool:
    """A precision report's verdict: no output beyond the bound, and the
    1xTF32 fault beyond it on dQ and on F32_FAULT_BEYOND's outputs of the
    geometry."""
    need = {"dq", *F32_FAULT_BEYOND.get(geometry, ())}
    return not res["beyond"] and need <= set(res["fault_beyond"])


def phase_kernels():
    """Checks every fused-qkv kernel at the steps' shapes (and a ragged
    one) in bf16 and f32, and times them on the very qkv that was checked:
    in bf16 at the main path's, the mesh's and the large geometries, in
    f32 at F32_TIMED."""
    errors, timings, f32_timings = {}, {}, {}
    for i, (geo, (B, N, H)) in enumerate(CHECKS.items()):
        for dtype in (torch.bfloat16, torch.float32):
            x = _qkv(B, N, H, dtype, seed=i)
            res = check_kernels(x, H)
            emit("kernels_vs_plain", geometry=geo, B=B, N=N, H=H,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if dtype == torch.bfloat16 and (geo in MAIN or
                                            geo in MESH_GEOS or
                                            geo in LARGE_CHECKS):
                errors[geo] = qkv_errors(res)
                timings[geo] = time_kernels(x, H)
                emit("kernel_times", geometry=geo, B=B, N=N, H=H,
                     dtype="bfloat16", times=timings[geo])
            if dtype == torch.float32 and geo in F32_TIMED:
                f32_timings[geo] = time_kernels(x, H)
                emit("kernel_times", geometry=geo, B=B, N=N, H=H,
                     dtype="float32", times=f32_timings[geo])
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
    f32 = {geo: f32_ratios(t, "qkv_attn_fwd", fa.QKV_F32_KERNELS[1:])
           for geo, t in f32_timings.items()}
    emit("k1_f32_vs_library", **{geo: r["fwd"] for geo, r in f32.items()})
    emit("k2_f32_vs_library", **{geo: r["bwd"] for geo, r in f32.items()})
    return errors, timings, f32_timings


def bounds_mh(B, N, H, D, groups: int = 0, e: int = 2,
              peak: float = PEAK_BF16) -> dict:
    """bounds() for the K3 kernels: separate q, k, v (each read once), the
    bias row, and the backward's delta; the work at its least (the dK/dV
    kernel's recomputed products not counted), or with `groups` as the
    column-split kernels do it."""
    A = H * D
    mm = 2 * B * H * N * N * D
    n = products(groups)
    row, stat = B * N * A * e, B * H * N * 4
    inputs = 3 * row + B * N * 4  # q, k, v, bias
    work = {
        "mh_attn_fwd": (n["fwd"] * mm, inputs + row + stat),  # -> out, lse
        # q, out, dout -> q * scale, delta
        "mh_attn_bwd_prep": (3 * B * N * A, 3 * row + row + stat),
        # + dout, lse, delta -> dk, dv
        "mh_attn_bwd_dkv": (n["dkv"] * mm,
                            inputs + row + 2 * stat + 2 * row),
        "mh_attn_bwd_dq": (n["dq"] * mm, inputs + row + 2 * stat + row),
    }
    return least_times(work, peak)


def time_mh_kernels(q, k, v, b, H, D) -> dict:
    """kernel, plain, library and bound times (ms) of K3 on bf16 or f32
    inputs (f32 as time_kernels: "delta_ms" for mh_delta); at a D without
    a kernel as time_kernels does it (the kernels on q, k, v
    zero-padded by fa.fwd_at_width, "pad_ms" from pad_times)."""
    scale = D ** -0.5
    B, N, _ = q.shape
    run = fa.fwd_at_width(fa.mh_attn_fwd, (q, k, v, b), fa.MH_GROUPS, H,
                          scale, H)
    (qw, kw, vw, _), out, lse, out_d = run
    dout, dout_d = ((2 * t.float()).to(q.dtype) for t in (out, out_d))
    f32 = q.dtype == torch.float32
    prep = fa._mh_prep(qw, kw, out, dout, scale, H, None)
    A = qw.shape[-1]
    dkv = torch.empty(B, N, 2 * A, dtype=q.dtype, device=q.device)
    dq = torch.empty_like(qw)
    heads = [t.reshape(B, N, H, D).transpose(1, 2).contiguous()
             .requires_grad_(True) for t in (q, k, v)]
    mask = b[:, None, None, :].to(q.dtype)
    o_lib = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                           scale=scale)
    g_lib = dout_d.reshape(B, N, H, D).transpose(1, 2).contiguous()
    plain_bwd = time_ms(lambda: fa.attention_mh_bwd_plain(
        q, k, v, b, out_d, lse, dout_d, scale, H), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "mh_attn_fwd": {
            "ms": time_ms(lambda: fa.mh_attn_fwd(qw, kw, vw, b, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_mh_fwd_plain(
                q, k, v, b, scale, H), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), attn_mask=mask, scale=scale)),
        },
        "mh_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dkv(
                qw, kw, vw, b, out, lse, dout, dkv[..., :A], dkv[..., A:],
                scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "mh_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.mh_attn_bwd_dq(
                qw, kw, vw, b, out, lse, dout, dq, scale, H, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    if f32:
        res["mh_attn_bwd_dkv"]["delta_ms"] = time_ms(
            lambda: fa.mh_delta(out, dout, H))
    else:  # no one library call computes delta and the scaled q alone
        res["mh_attn_bwd_prep"] = {
            "ms": time_ms(lambda: fa.mh_attn_bwd_prep(
                qw, kw, out, dout, scale, H)),
            "plain_ms": time_ms(lambda: fa.attention_mh_bwd_prep_plain(
                q, k, out_d, dout_d, scale, H)),
            "library_ms": None,
        }
    _with_pad_times(res, pad_times(run, (q, k, v, b), (
        dq, dkv[..., :A], dkv[..., A:]), dout_d, fa.MH_GROUPS, H),
        "mh_attn_fwd")
    return with_bounds(res, bounds_mh, q.dtype, B, N, H, D)


def check_mh_kernels(q, k, v, b, H, scale: float) -> dict:
    """check_kernels for K3 on q, k, v and the bias row b (or None): the
    bounds, in bf16 the backward's prep pass too, the planted faults (with a
    bias also the kernels' outputs without it; in f32 with a one-column
    sample also dQ moved on that sample's rows) rejected, and masked kv rows
    with exactly zero dK/dV."""
    got, want = mh_attention_against_plain(q, k, v, b, H, scale)
    torch.cuda.synchronize()
    res = check_against_plain(got, want)
    if q.dtype == torch.bfloat16:  # at the width the kernels ran D at
        qw, kw, _, _, out = got["at_width"]
        res["prep"] = check_mh_prep(qw, kw, out, (2 * out.float()).to(
            q.dtype), H, scale)
    ignored = None
    if b is not None:
        ignored, _ = mh_attention_against_plain(q, k, v, None, H, scale)
    res["planted"] = {}
    for fault, outputs in split_faults(planted_faults(got, ignored, want),
                                       got, H, q.shape[-1] // H).items():
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
    at scale 0.1. Times at the MCA, bf16 and f32."""
    errors, timings, f32_timings = {}, {}, {}
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
                if geo == "mca" and dtype == torch.float32 and bias:
                    f32_timings = time_mh_kernels(q, k, v, b, H, D)
                    emit("mh_kernel_times", geometry=geo, B=B, N=N, H=H,
                         D=D, dtype="float32", bias=True,
                         times=f32_timings, vs_library=f32_ratios(
                             f32_timings, "mh_attn_fwd",
                             fa.MH_F32_KERNELS[1:]))
                del q, k, v, b
    # a scale that is not a power of two: at head dim 64 dQ reads the prep
    # pass's scaled K copy, at 256 it folds the scale into its K strip
    for geo in ("ragged_d64", "ragged_d256"):
        B, N, H, D = MH_CHECKS[geo]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, b = mh_inputs(B, N, H, D, dtype, 7, "cuda")
            res = check_mh_kernels(q, k, v, b, H, 0.1)
            if dtype == torch.bfloat16 and res["prep"]["ks"] is not (
                    True if D == 64 else None):
                raise AssertionError(f"the scaled K copy at D={D}: {res}")
            emit("mh_kernels_vs_plain", geometry=geo, B=B, N=N, H=H, D=D,
                 scale=0.1, dtype=str(dtype).replace("torch.", ""),
                 bias=True, **res)
    return errors, timings, f32_timings


def phase_mh_head_dims(smi: str) -> dict:
    """K3's four entry points at MH_HEAD_DIMS (16 and 32 on one box, 128 on
    wgmma_attn_bwd.cuh's backward, 192 on the strip kernels; 48 and 96
    zero-padded to 64 and 128) with the kv bias against their plain
    versions at the unpadded D (check_mh_kernels: the bounds, the planted
    faults with the bias ignored, zero dK/dV on masked kv rows; the scale
    D^-0.5, no power of two at 32, 48, 96, 128 and 192) at
    MH_HEAD_DIM_CHECKS, bf16 and f32; kernel, plain, library, bound and pad
    times at the long geometry in bf16. Returns {D: (max errors, times)}."""
    out = {}
    for hd in MH_HEAD_DIMS:
        for i, (geo, (B, N, H)) in enumerate(MH_HEAD_DIM_CHECKS[hd].items()):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, b = mh_inputs(B, N, H, hd, dtype, hd + i, "cuda")
                res = check_mh_kernels(q, k, v, b, H, hd ** -0.5)
                emit("mh_head_dims_vs_plain", D=hd,
                     width=fa.head_dim_width(hd), geometry=geo, B=B, N=N,
                     H=H, dtype=str(dtype).replace("torch.", ""), bias=True,
                     **res)
                if geo == "long" and dtype == torch.bfloat16:
                    err = res["max_abs_err"]
                    errors = {"mh_attn_fwd": err["out"],
                              "mh_attn_bwd_prep": res["prep"]["max_abs_err"],
                              "mh_attn_bwd_dkv": max(err["dk"], err["dv"]),
                              "mh_attn_bwd_dq": err["dq"]}
                    times = time_mh_kernels(q, k, v, b, H, hd)
                    emit("mh_head_dim_times", D=hd,
                         width=fa.head_dim_width(hd), B=B, N=N, H=H,
                         dtype="bfloat16", bias=True, times=times,
                         nvidia_smi=smi)
                    out[hd] = (errors, times)
                del q, k, v, b
    return out


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
    with count_pads() as pads:
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
    if pads["copies"]:  # every head dim of the path is built
        raise AssertionError(f"{pads['copies']} zero-padding copies")
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
         pad_copies=pads["copies"],
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


def bounds_hm(BH, N, D, groups: int = 0, e: int = 2,
              peak: float = PEAK_BF16) -> dict:
    """bounds() for the K4 kernels on (BH, N, D) q, k, v (each read once),
    the LSE and the backward's delta; the work at its least (the forward's
    second score product and the dK/dV kernel's recomputed ones not
    counted), or with `groups` as the column-split kernels do it."""
    mm = 2 * BH * N * N * D
    n = products(groups, two_pass=True)
    row, stat = BH * N * D * e, BH * N * 4
    return least_times({
        "hm_attn_fwd": (n["fwd"] * mm, 3 * row + row + stat),  # -> out, lse
        # q, out, dout -> q * scale, delta
        "hm_attn_bwd_prep": (3 * BH * N * D, 3 * row + row + stat),
        # k, v, q * scale, dout, lse, delta -> dk, dv
        "hm_attn_bwd_dkv": (n["dkv"] * mm, 4 * row + 2 * stat + 2 * row),
        "hm_attn_bwd_dq": (n["dq"] * mm, 4 * row + 2 * stat + row),  # -> dq
    }, peak)


def time_hm_kernels(q, k, v, B, H) -> dict:
    """kernel, plain, library and bound times (ms) of K4 on bf16 or f32
    (B*H, N, D) inputs (f32 as time_kernels: "delta_ms" for hm_delta); at
    a D without a kernel as time_kernels does it (the
    kernels on q, k, v zero-padded by fa.fwd_at_width, "pad_ms" from
    pad_times)."""
    BH, N, D = q.shape
    scale = D ** -0.5
    run = fa.fwd_at_width(fa.hm_attn_fwd, (q, k, v), fa.HM_GROUPS, 1, scale)
    (qw, kw, vw), out, lse, out_d = run
    dout, dout_d = ((2 * t.float()).to(q.dtype) for t in (out, out_d))
    f32 = q.dtype == torch.float32
    prep = fa._hm_prep(qw, kw, out, dout, scale, None)
    dq, dk, dv = (torch.empty_like(qw) for _ in range(3))
    heads = [t.reshape(B, H, N, D).clone().requires_grad_(True)
             for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*heads, scale=scale)
    g_lib = dout_d.reshape(B, H, N, D)
    plain_bwd = time_ms(lambda: fa.attention_hm_bwd_plain(
        q, k, v, out_d, lse, dout_d, scale), runs=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, heads, g_lib, retain_graph=True))
    res = {
        "hm_attn_fwd": {
            "ms": time_ms(lambda: fa.hm_attn_fwd(qw, kw, vw, scale)),
            "plain_ms": time_ms(lambda: fa.attention_hm_fwd_plain(
                q, k, v, scale), runs=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in heads), scale=scale)),
        },
        "hm_attn_bwd_dkv": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dkv(
                qw, kw, vw, out, lse, dout, dk, dv, scale, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
        "hm_attn_bwd_dq": {
            "ms": time_ms(lambda: fa.hm_attn_bwd_dq(
                qw, kw, vw, out, lse, dout, dq, scale, prep)),
            "plain_ms": plain_bwd, "library_ms": lib_bwd,
        },
    }
    if f32:
        res["hm_attn_bwd_dkv"]["delta_ms"] = time_ms(
            lambda: fa.hm_delta(out, dout))
    else:  # no one library call computes delta and the scaled q alone
        res["hm_attn_bwd_prep"] = {
            "ms": time_ms(lambda: fa.hm_attn_bwd_prep(qw, kw, out, dout,
                                                      scale)),
            "plain_ms": time_ms(lambda: fa.attention_hm_bwd_prep_plain(
                q, k, out_d, dout_d, scale)),
            "library_ms": None,
        }
    _with_pad_times(res, pad_times(run, (q, k, v), (dq, dk, dv), dout_d,
                                   fa.HM_GROUPS, 1), "hm_attn_fwd")
    return with_bounds(res, bounds_hm, q.dtype, BH, N, D)


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
    if q.dtype == torch.bfloat16:  # at the width the kernels ran D at
        qw, kw, _, out = got["at_width"]
        res["prep"] = check_hm_prep(qw, kw, out, (2 * out.float()).to(
            q.dtype), scale)
    res["planted"] = {}
    for fault, outputs in split_faults(hm_planted_faults(got), got, 1,
                                       q.shape[-1]).items():
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
    decoder shape (bf16 and f32), and K1's numerics against K4's there."""
    errors, timings, f32_timings = {}, {}, {}
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
            if geo == "runner_decoder" and dtype == torch.float32:
                f32_timings = time_hm_kernels(q, k, v, B, H)
                emit("hm_kernel_times", geometry=geo, B=B, H=H, N=N, D=D,
                     dtype="float32", times=f32_timings,
                     vs_library=f32_ratios(f32_timings, "hm_attn_fwd",
                                           fa.HM_F32_KERNELS[1:]))
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
    return errors, timings, f32_timings


def phase_hm_head_dims(smi: str) -> dict:
    """K4's four entry points at HM_HEAD_DIMS (48 zero-padded to 64; 192
    and 256 on the strip kernels) against their plain versions at the
    unpadded D (check_hm_kernels' bounds and planted faults; the scale
    D^-0.5, no power of two at 32, 48 and 128: dQ's scaled-K copy, nor at
    192: the strip kernels' folded K) at HM_HEAD_DIM_CHECKS (and
    HM_WIDE_CHECKS) and at tiny_debug_step's own HM_TINY_CHECKS, bf16
    and f32; then kernel, plain, library, bound and pad times at the long
    geometry in bf16 for each and D = 64. Returns {D: (max errors, times)}
    for HM_HEAD_DIMS."""
    out = {}
    for hd in HM_HEAD_DIMS:
        errors = {}
        for i, (geo, (BH, N)) in enumerate({
                **HM_HEAD_DIM_CHECKS, **HM_WIDE_CHECKS.get(hd, {})}.items()):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = hm_inputs(BH, N, dtype, hd + i, "cuda", D=hd)
                res = check_hm_kernels(q, k, v, hd ** -0.5)
                emit("hm_head_dims_vs_plain", D=hd,
                     width=fa.head_dim_width(hd), geometry=geo, BH=BH, N=N,
                     dtype=str(dtype).replace("torch.", ""), **res)
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
        emit("hm_head_dim_times", D=hd, width=fa.head_dim_width(hd), BH=BH,
             N=N, dtype="bfloat16", times=times, nvidia_smi=smi)
        if hd in out:
            out[hd] = (out[hd], times)
    return out


def mod_is_finetune(label: str) -> bool:
    return LARGE_PRESETS[label][0] == "finetune"


def _large_flags(label: str, *extra: str) -> tuple:
    """(bench module, its parsed flags) of preset `label`."""
    tool, flags = LARGE_PRESETS[label]
    mod = BF if tool == "finetune" else BP
    return mod, mod.parse_args([*flags, *extra])


def _large_check_steps(label: str, plain: bool) -> list:
    """2 bf16 steps of preset `label` at LARGE_CHECK_DEPTH Blocks, B = 1,
    through the kernels or (plain) their plain versions: loss and gradient
    norm a step; each route's launches checked."""
    depth = str(LARGE_CHECK_DEPTH)
    mod, args = _large_flags(label, "--batch", "1", *(
        ("--depth", depth) if mod_is_finetune(label) else
        ("--encoder_depth", depth, "--decoder_depth", depth)))
    run = mod.build(args)
    extra = () if mod is BF else (BP.LOSS_WEIGHT,)
    fa.reset_launch_counts()
    metrics = []
    with plain_attention() if plain else contextlib.nullcontext():
        for _ in range(2):
            run["state"], m = run["step"](run["state"], run["batch"],
                                          run["generator"], *extra)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    torch.cuda.synchronize()
    want = {k: 0 if plain else 2 * v
            for k, v in run["launches_per_step"].items()}
    if fa.launch_counts != want:
        raise AssertionError(f"{label} depth {depth} through the "
                             f"{'plain versions' if plain else 'kernels'}: "
                             f"launches {fa.launch_counts}, expected {want}")
    return metrics


def phase_large_presets(smi: str) -> dict:
    """The registry's large geometries (LARGE_PRESETS) as whole bf16 steps
    at full width and depth and the JAX tools' batches: LARGE_STEPS train
    steps and, for the classifiers, LARGE_EVALS eval calls, finite losses,
    every kernel's launches against STEP_LAUNCHES / EVAL_LAUNCHES; then at
    LARGE_CHECK_DEPTH Blocks and B = 1 the steps through the kernels
    against the same steps through the plain versions. Returns the
    launches of the full-depth runs, summed."""
    total = dict.fromkeys(fa.KERNELS, 0)
    for label in LARGE_PRESETS:
        t0 = time.perf_counter()
        mod, args = _large_flags(label)
        run = mod.build(args)
        if run["launches_per_step"] != STEP_LAUNCHES[label]:
            raise AssertionError(f"{label}: the tool's launches a step "
                                 f"{run['launches_per_step']}")
        res = mod.run_steps(run, LARGE_STEPS - 1)
        rec = BF.record(run, res, label, train=True)
        launches = dict(res["launches"])
        ev = None
        if mod_is_finetune(label):
            ev = BF.run_steps(run, LARGE_EVALS - 1, ev=True)
            if ev["launches"] != {k: LARGE_EVALS * v for k, v in
                                  EVAL_LAUNCHES[label].items()}:
                raise AssertionError(f"{label} eval launches "
                                     f"{ev['launches']}")
            launches = {k: launches[k] + ev["launches"][k] for k in launches}
        for k in total:
            total[k] += launches[k]
        extra = rec["extra"]
        emit("large_presets", preset=label, model=run["cfg"].model,
             flags=LARGE_PRESETS[label][1], batch=run["B"],
             tokens=run["tokens"], blocks=LARGE_BLOCKS[label],
             steps=LARGE_STEPS, step_ms=res["ms"], losses=res["losses"],
             clips_per_s=rec["value"], mfu=extra["mfu"],
             peak_mem_gib=res["peak_mem_gib"],
             eval_ms=ev and ev["ms"], eval_losses=ev and ev["losses"],
             eval_clips_per_s=ev and run["B"] / ev["ms"] * 1e3,
             launches={k: v for k, v in launches.items() if v},
             seconds=time.perf_counter() - t0, nvidia_smi=smi)
        del run
        torch.cuda.empty_cache()
    for label in LARGE_PRESETS:
        runs = {route: _large_check_steps(label, route == "plain")
                for route in ("kernels", "plain")}
        torch.cuda.empty_cache()
        rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
               for a, b in zip(runs["kernels"], runs["plain"])]
        emit("large_presets_vs_plain", preset=label, dtype="bfloat16",
             batch=1, depth=LARGE_CHECK_DEPTH, steps=2, **runs,
             rel_diff=rel, bound=BF16_STEP_RTOL)
        if not max(max(r.values()) for r in rel) <= BF16_STEP_RTOL:
            raise AssertionError(f"{label}: kernels vs plain versions beyond "
                                 f"rtol {BF16_STEP_RTOL}: {rel}")
    return total


@contextlib.contextmanager
def k3_dq_zeroed():
    """A planted fault for any_head_dim_steps' step check: inside, K3's
    backward returns dQ zeroed."""
    kept = fa.mh_attn_bwd

    def faulty(*args):
        dq, dk, dv = kept(*args)
        return torch.zeros_like(dq), dk, dv

    fa.mh_attn_bwd = faulty
    try:
        yield
    finally:
        fa.mh_attn_bwd = kept


def _attn_grad_steps(heads: int, route: str, width=None) -> list:
    """2 bf16 finetune steps at B = 2 of the BB-focused model cut to
    HEAD_DIM_CHECK_DEPTH Blocks, its MCA at `heads` heads (at `width`,
    build_finetune_step's), through the kernels ("kernels"), the plain
    versions ("plain") or the kernels with K3's dQ zeroed ("dq_zeroed"):
    per step the loss, the gradient norm and every ATTN_LEAF weight's
    gradient (f32 copies)."""
    _, state, step, gen, batch, _ = build_finetune_step(
        2, plain=route == "plain", depth=HEAD_DIM_CHECK_DEPTH,
        mca_num_heads=heads, width=width)
    steps = []
    for _ in range(2):
        with k3_dq_zeroed() if route == "dq_zeroed" else \
                contextlib.nullcontext():
            state, m = step(state, batch, gen)
        steps.append(({k: float(m[k]) for k in ("loss", "grad_norm")}, {
            n: p.grad.float().clone() for n, p in state.params.items()
            if ATTN_LEAF.search(n)}))
    return steps


def _attn_grad_rel(got: list, want: list) -> dict:
    """Per step the worst ATTN_LEAF weight's relative L2 gradient error,
    that weight, and the loss's and gradient norm's relative differences."""
    out = []
    for (m, g), (pm, pg) in zip(got, want):
        rel = {n: (torch.linalg.vector_norm(g[n] - pg[n])
                   / torch.linalg.vector_norm(pg[n])).item() for n in pg}
        worst = max(rel, key=rel.get)
        out.append({"worst_leaf": worst, "grad_rel": rel[worst],
                    **{k: abs(m[k] - pm[k]) / abs(pm[k]) for k in m}})
    return out


def mca_head_dim_steps(smi: str, phase: str, models: dict,
                       pads: dict) -> dict:
    """The BB-focused finetune model with `models`' MCAs, label ->
    (mca_num_heads, width (build_finetune_step's) or None, batch, depth),
    at full width and depth through the port's finetune step and eval
    step, bf16: HEAD_DIM_STEPS train steps and one eval call each, finite
    losses, every kernel's launches against FINETUNE_MODEL's STEP_LAUNCHES /
    EVAL_LAUNCHES (K1/K2 in each of `depth` Blocks) and the zero-padding
    copies against `pads` (a train step's, an eval call's); then each at
    HEAD_DIM_CHECK_DEPTH Blocks, B = 2: 2 steps through the kernels against
    the same steps through the plain versions at the unpadded head dims,
    the loss and gradient norm within BF16_STEP_RTOL and every attention
    weight's gradient within ATTN_GRAD_RTOL (relative L2); the same steps
    with K3's dQ zeroed must fail that bound. Lines `phase` and
    `phase`_vs_plain. Returns the launches of the full-depth runs,
    summed."""
    total = dict.fromkeys(fa.KERNELS, 0)
    for label, (heads, width, B, depth) in models.items():
        per_step = {**STEP_LAUNCHES[FINETUNE_MODEL],
                    **dict.fromkeys(fa.QKV_KERNELS, depth)}
        per_eval = {**EVAL_LAUNCHES[FINETUNE_MODEL], "qkv_attn_fwd": depth}
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model, state, step, gen, batch, cfg = build_finetune_step(
            B, depth=depth, mca_num_heads=heads, width=width)
        fa.reset_launch_counts()
        times, losses, norms = [], [], []
        with count_pads() as counted:
            for _ in range(HEAD_DIM_STEPS):
                t1 = time.perf_counter()
                state, m = step(state, batch, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            train = dict(fa.launch_counts), counted["copies"]
            fa.reset_launch_counts()
            ev = make_eval_step(model, cfg, bb_focused=True)(batch)
            torch.cuda.synchronize()
            evals = dict(fa.launch_counts), counted["copies"] - train[1]
        step_pads, eval_pads = pads[label]
        want = ({k: HEAD_DIM_STEPS * v for k, v in per_step.items()},
                HEAD_DIM_STEPS * step_pads)
        if train != want or evals != (per_eval, eval_pads):
            raise AssertionError(f"{label}: launches and pad copies {train}, "
                                 f"eval {evals}; expected {want}")
        if not (np.isfinite(losses + norms).all() and all(
                np.isfinite(float(ev[k])) for k in ("loss", "acc1"))) or \
                ev["logits"].shape != (B, cfg.nb_classes):
            raise AssertionError(f"{label}: {losses} {norms} {ev}")
        for k, v in train[0].items():
            total[k] += v + evals[0][k]
        attn = model.local_MCA[0].attn
        emit(phase, model=FINETUNE_MODEL,
             keywords={"mca_num_heads": heads, **(
                 {} if width is None else {"embed_dim": width[0],
                                           "num_heads": width[1]}),
                 "depth": depth},
             label=label, mca_head_dim=attn.head_dim,
             kernel_head_dim=fa.head_dim_width(attn.head_dim),
             dtype="bfloat16", batch=B, steps=HEAD_DIM_STEPS,
             step_ms=times, loss=losses, grad_norm=norms,
             eval={k: float(ev[k]) for k in ("loss", "acc1", "acc5")},
             launches={k: v for k, v in train[0].items() if v},
             eval_launches={k: v for k, v in evals[0].items() if v},
             pad_copies=train[1], eval_pad_copies=evals[1],
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             seconds=time.perf_counter() - t0, nvidia_smi=smi)
        del model, state, step, batch
        torch.cuda.empty_cache()
    for label, (heads, width, _, _) in models.items():
        runs = {route: _attn_grad_steps(heads, route, width)
                for route in ("kernels", "plain", "dq_zeroed")}
        rel = _attn_grad_rel(runs["kernels"], runs["plain"])
        planted = _attn_grad_rel(runs["dq_zeroed"], runs["plain"])
        emit(phase.replace("_steps", "_vs_plain"), label=label,
             dtype="bfloat16", batch=2, depth=HEAD_DIM_CHECK_DEPTH, steps=2,
             **{route: [m for m, _ in r] for route, r in runs.items()},
             rel_diff=rel, bound=BF16_STEP_RTOL, grad_bound=ATTN_GRAD_RTOL,
             dq_zeroed_rel=planted)
        if not all(r["loss"] <= BF16_STEP_RTOL and r["grad_norm"] <=
                   BF16_STEP_RTOL and r["grad_rel"] <= ATTN_GRAD_RTOL
                   for r in rel):
            raise AssertionError(f"{label}: kernels vs plain versions beyond "
                                 f"the bounds: {rel}")
        if not all(r["grad_rel"] > ATTN_GRAD_RTOL for r in planted):
            raise AssertionError(f"{label}: the bounds let K3's dQ zeroed "
                                 f"pass: {planted}")
    return total


def phase_any_head_dim_steps(smi: str) -> dict:
    """The ViT-B BB-focused finetune model at full width and depth with an
    MCA of HEAD_DIM_MODELS heads (K3 zero-padded from 96 to 128 and from
    48 to 64, and at 192 on the strip kernels; the backbone's K1/K2 at 64),
    B = FT_BATCH, through mca_head_dim_steps (pads HEAD_DIM_PADS)."""
    return mca_head_dim_steps(smi, "any_head_dim_steps", {
        label: (heads, None, FT_BATCH, 12)
        for label, heads in HEAD_DIM_MODELS.items()}, HEAD_DIM_PADS)


def phase_wide_head_dim_steps(smi: str) -> dict:
    """The slice's path above 256: WIDE_HEAD_DIM_MODELS (the MCA's K3 at
    384 and 768 at ViT-B width, at 341 zero-padded to 384 at ViT-L's, on
    the column-split kernels) through mca_head_dim_steps (pads
    WIDE_HEAD_DIM_PADS)."""
    return mca_head_dim_steps(smi, "wide_head_dim_steps",
                              WIDE_HEAD_DIM_MODELS, WIDE_HEAD_DIM_PADS)


def sdpa_backends(q, k, v, **kw) -> dict:
    """The library call's backends on these inputs: which of
    F.scaled_dot_product_attention's take them (each forced in turn; flash
    takes no head dim above 256), and the CUDA kernels its default call
    launches (a profiler trace; "not measured" if it shows no device
    time)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    takes = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v, **kw)
            takes.append(backend.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    kernels = sorted({e.key for e in prof.key_averages()
                      if getattr(e, "self_device_time_total", 0) > 0})
    return {"takes": takes, "default_launches": kernels or "not measured"}


def _heads4(t, B, N, H, d):
    return t.reshape(B, N, H, d).transpose(1, 2).contiguous()


def phase_wide_head_dims(smi: str) -> dict:
    """Every family above head dim 256, on the column-split kernels: K1/K2
    at WIDE_QKV_CHECKS, K3 with the kv bias at WIDE_MH_CHECKS and K4 at
    WIDE_HM_CHECKS, bf16 and f32, against their plain versions at the
    unpadded D (check_kernels / check_mh_kernels / check_hm_kernels:
    main_path's bounds, the prep pass in bf16, the planted faults with one
    output group left unwritten among them); then kernel, plain, library
    and pad times in bf16, each beside its bound at the unpadded D's least
    work (bound_ms) and with the groups' recomputed S and dP counted
    (bound_recompute_ms), and the library's backends on those inputs.
    Returns {family: {D: (max errors, times)}}."""
    out = {"qkv": {}, "mh": {}, "hm": {}}
    dtypes = (torch.bfloat16, torch.float32)

    def times_line(family, hd, shape, times, backends):
        emit("wide_head_dim_times", family=family, D=hd,
             width=fa.head_dim_width(hd), groups=split_groups(hd), **shape,
             dtype="bfloat16", times=times, sdpa=backends, nvidia_smi=smi)

    def recompute(times, extra):
        for name, (bound, by) in extra.items():
            times[name].update(bound_recompute_ms=bound,
                               bound_recompute_by=by)

    for hd, (B, N, H) in WIDE_QKV_CHECKS.items():
        for dtype in dtypes:
            x = _qkv(B, N, H, dtype, hd, d=hd)
            res = check_kernels(x, H, hd ** -0.5)
            emit("wide_head_dims_vs_plain", family="qkv", D=hd,
                 width=fa.head_dim_width(hd), B=B, N=N, H=H,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if dtype == torch.bfloat16:
                times = time_kernels(x, H)
                recompute(times, bounds(B, N, H, hd, split_groups(hd)))
                q, k, v = (_heads4(t, B, N, H, hd)
                           for t in fa.split_heads(x, H))
                times_line("qkv", hd, {"B": B, "N": N, "H": H}, times,
                           sdpa_backends(q, k, v, scale=hd ** -0.5))
                out["qkv"][hd] = (qkv_errors(res), times)
            del x
    for hd, (B, N, H) in WIDE_MH_CHECKS.items():
        for dtype in dtypes:
            q, k, v, b = mh_inputs(B, N, H, hd, dtype, hd, "cuda")
            res = check_mh_kernels(q, k, v, b, H, hd ** -0.5)
            emit("wide_head_dims_vs_plain", family="mh", D=hd,
                 width=fa.head_dim_width(hd), B=B, N=N, H=H,
                 dtype=str(dtype).replace("torch.", ""), bias=True, **res)
            if dtype == torch.bfloat16:
                err = res["max_abs_err"]
                errors = {"mh_attn_fwd": err["out"],
                          "mh_attn_bwd_prep": res["prep"]["max_abs_err"],
                          "mh_attn_bwd_dkv": max(err["dk"], err["dv"]),
                          "mh_attn_bwd_dq": err["dq"]}
                times = time_mh_kernels(q, k, v, b, H, hd)
                recompute(times, bounds_mh(B, N, H, hd, split_groups(hd)))
                times_line("mh", hd, {"B": B, "N": N, "H": H}, times,
                           sdpa_backends(
                               *(_heads4(t, B, N, H, hd) for t in (q, k, v)),
                               attn_mask=b[:, None, None, :].to(q.dtype),
                               scale=hd ** -0.5))
                out["mh"][hd] = (errors, times)
            del q, k, v, b
    for hd, (BH, N) in WIDE_HM_CHECKS.items():
        for dtype in dtypes:
            q, k, v = hm_inputs(BH, N, dtype, hd, "cuda", D=hd)
            res = check_hm_kernels(q, k, v, hd ** -0.5)
            emit("wide_head_dims_vs_plain", family="hm", D=hd,
                 width=fa.head_dim_width(hd), BH=BH, N=N,
                 dtype=str(dtype).replace("torch.", ""), **res)
            if dtype == torch.bfloat16:
                err = res["max_abs_err"]
                errors = {"hm_attn_fwd": err["out"],
                          "hm_attn_bwd_prep": res["prep"]["max_abs_err"],
                          "hm_attn_bwd_dkv": max(err["dk"], err["dv"]),
                          "hm_attn_bwd_dq": err["dq"]}
                times = time_hm_kernels(q, k, v, 1, BH)
                recompute(times, bounds_hm(BH, N, hd, split_groups(hd)))
                times_line("hm", hd, {"BH": BH, "N": N}, times,
                           sdpa_backends(*(t[None] for t in (q, k, v)),
                                         scale=hd ** -0.5))
                out["hm"][hd] = (errors, times)
            del q, k, v
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
    256 x 320, boxes, frames from MemoryReader) with one thread, with four
    and with four forked worker processes (worker_mode="process", forked
    with CUDA up in this process; the workers decode on the host only): the
    first batch and the mean of the next three, each batch pinned and
    copied to the card. Every mode must give the same number of batches
    of the same shapes."""
    ds = P.PretrainClipDataset(
        read_setting_file(data["pretrain"]) * 2, decode_size=DECODE_HW,
        boxes=MotionBoxIndex.from_file(data["bb_json"]), reader=MemoryReader)
    res, shapes = {}, {}
    for mode, workers in (("thread", 1), ("thread", 4), ("process", 4)):
        waits = []
        t = time.perf_counter()
        for batch in P.PrefetchLoader(ds, VITS_BATCH, num_workers=workers,
                                      worker_mode=mode):
            torch.cuda.synchronize()
            now = time.perf_counter()
            waits.append(now - t)
            t = now
            shape = {k: tuple(v.shape) for k, v in batch.items()}
        key = f"{mode}x{workers}"
        shapes[key] = (len(waits), shape)
        res[key] = {"first_batch_ms": waits[0] * 1e3,
                    "wait_ms_per_batch": statistics.mean(waits[1:]) * 1e3,
                    "batches": len(waits)}
    if len(set(map(str, shapes.values()))) != 1:
        raise AssertionError(f"the loader modes differ: {shapes}")
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
    """The motion-box factory on FACTORY_VIDEOS SSV2-style videos on the
    card, held against the CPU, then the ViT-S MOFO pretrain runner on its
    JSON. Returns the runner's launches."""
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

        # 3. pairs batched against one call a pair, on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = flow.tvl1_flow_batch(frames[:FACTORY_BATCHED_PAIRS + 1])
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = torch.stack([flow.tvl1_flow(frames[i], frames[i + 1])
                               for i in range(FACTORY_BATCHED_PAIRS)])
        torch.cuda.synchronize()
        singles_s = time.perf_counter() - t0
        gap = float((batched - singles).abs().max())
        batched_vs_pairs = {"pairs": FACTORY_BATCHED_PAIRS,
                            "max_abs_px": gap, "bound": BATCHED_ATOL,
                            "batched_s": batched_s,
                            "one_call_a_pair_s": singles_s}
        if not gap <= BATCHED_ATOL:
            problems.append(f"batched vs per pair {batched_vs_pairs}")

        # 4. that video's JSON from --device cpu against --device cuda, on
        # FACTORY_CPU_FRAMES of its frames (--max_frames, stride-sampled)
        both = ["--data_path", path, "--max_frames", str(FACTORY_CPU_FRAMES)]
        cut_json, cpu_json = (os.path.join(tmp, f"{d}.json")
                              for d in ("cuda", "cpu"))
        cut, _, _ = _factory(both + ["--output", cut_json])
        cpu, _, cpu_s = _factory(both + ["--output", cpu_json, "--device",
                                         "cpu"])
        box_gap = np.abs(_json_boxes(cpu_json)[short]
                         - _json_boxes(cut_json)[short])
        boxes_card_vs_cpu = {
            "video": short, "frames": len(box_gap),
            "max_abs_px": float(box_gap.max()),
            "frames_differing": int((box_gap.max(axis=1) > 0).sum()),
            "bound": FACTORY_BOX_PX, "cpu_seconds": cpu["seconds"][short],
            "card_seconds": cut["seconds"][short]}
        if not box_gap.max() <= FACTORY_BOX_PX:
            problems.append(f"boxes card vs CPU {boxes_card_vs_cpu}")

        # 5. per-frame boxes against the moving square (information), on
        # the shortest video
        frame_json = os.path.join(tmp, "per_frame.json")
        _, _, per_frame_s = _factory(["--data_path", path, "--output",
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


def phase_f32_eval(smi: str) -> dict:
    """The f32 paths end to end (K1's f32 forward, K2's f32 dK/dV): the
    classifier forward of feature_extract (its default model and batch,
    F32_EVAL_MODEL at B = F32_EVAL_BATCH, 16 x 224^2 clips, f32, no grad:
    12 K1 f32 forwards a batch) and the ViT-B MOFO pretrain step in f32 at
    B = STEP_BATCH (16 launches of each QKV_F32_KERNELS kernel), each 1
    warm-up + F32_EVAL_REPS timed calls, medians, launches held exactly.
    Returns the launches of both."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_model(F32_EVAL_MODEL, device="cuda", seed=1,
                         num_classes=0)
    model.eval()
    clips = synthetic_batch(F32_EVAL_BATCH, gen, "cuda")["clip"]
    per_batch = {**dict.fromkeys(fa.KERNELS, 0),
                 "qkv_attn_fwd": len(model.blocks)}
    res, total = {}, dict.fromkeys(fa.KERNELS, 0)

    def timed(name, run, want):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        times, out = [], None
        for _ in range(1 + F32_EVAL_REPS):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(fa.launch_counts)
        expected = {k: (1 + F32_EVAL_REPS) * v for k, v in want.items()}
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches} != {expected}")
        for k in total:
            total[k] += launches[k]
        res[name] = {"ms": statistics.median(times[1:]), "ms_all": times,
                     "launches": launches}
        return out

    with torch.no_grad():
        feats = timed("classifier_forward",
                      lambda: model(clips, return_features=True), per_batch)
    if feats.dtype != torch.float32 or not torch.isfinite(feats).all():
        raise AssertionError(f"features {feats.dtype}, not all finite")
    res["classifier_forward"].update(model=F32_EVAL_MODEL,
                                     batch=F32_EVAL_BATCH,
                                     features=list(feats.shape))
    del model, clips, feats
    _, state, step, gen, batch = build_step(STEP_BATCH, dtype="float32")
    losses = []

    def one_step():
        nonlocal state
        state, metrics = step(state, batch, gen, 0.5)
        losses.append(float(metrics["loss"]))

    timed("pretrain_step", one_step, {
        **dict.fromkeys(fa.KERNELS, 0),
        **dict.fromkeys(fa.QKV_F32_KERNELS, STEP_LAUNCHES[MODEL][
            "qkv_attn_fwd"])})
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite f32 losses {losses}")
    res["pretrain_step"].update(model=MODEL, batch=STEP_BATCH, loss=losses)
    emit("f32_eval", dtype="float32", nvidia_smi=smi, **res)
    return total


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


# --- the optimizer zoo and second-order training ---------------------------


def _rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every tensor of two name -> tensor dicts (on
    the CPU, f64 sums)."""
    num = sum(float((a[n].double() - b[n].double()).square().sum())
              for n in b)
    den = sum(float(b[n].double().square().sum()) for n in b)
    return (num / max(den, 1e-300)) ** 0.5


def _host(params: dict) -> dict:
    """f32 copies on the CPU (never views of the tensors)."""
    return {n: p.detach().float().cpu().clone() for n, p in params.items()}


def _cut_vitb(dev: str, **overrides):
    """ViT-B width cut to 2+1 Blocks, the weights of phase_parity."""
    return create_model(MODEL, device=dev, seed=5, encoder_depth=2,
                        decoder_depth=1, **overrides)


def _parity_inputs(steps: int):
    """phase_parity's clip and boxes (B=1) and one tube_bb mask a step."""
    gen = torch.Generator().manual_seed(7)
    batch = synthetic_batch(1, gen, "cpu")
    masks = [masking.motion_tube_mask(batch["boxes"], generator=gen)
             for _ in range(steps)]
    cfg = PretrainConfig(model=MODEL, batch_size=1, dtype="float32",
                         masking=MaskingConfig(mask_type="tube_bb"),
                         motion_loss_weight=True)
    return cfg, batch, masks


def _channel_orthogonal(params: dict, seed: int) -> dict:
    """Gradients orthogonal to each weight in every row of mofo_tpu's
    channel view (axis 0 of optim.jax_layout): where AdamP projects."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for n, p in params.items():
        g = torch.randn(p.shape, generator=gen)
        if p.ndim >= 2:
            pj = optim.jax_layout(n, p).double()
            gj = optim.jax_layout(n, g).double()
            pm, gm = pj.reshape(pj.shape[0], -1), gj.reshape(gj.shape[0], -1)
            gm = gm - pm * (gm * pm).sum(1, keepdim=True) / (pm * pm).sum(
                1, keepdim=True)
            g = optim.torch_layout(n, gm.reshape(pj.shape).float(),
                                   p.shape).contiguous()
        out[n] = g
    return out


@contextlib.contextmanager
def _channels_on_torch_axis():
    """The planted AdamP fault: the channel view on the port's own axis 0
    (a Linear's output features), not mofo_tpu's."""
    kept = optim.jax_layout, optim.torch_layout
    optim.jax_layout = lambda name, t: t
    optim.torch_layout = lambda name, t, shape: t
    try:
        yield
    finally:
        optim.jax_layout, optim.torch_layout = kept


def _adamp_fault_check() -> dict:
    """Two AdamP updates (lr 1e-3) of the cut ViT-B's weights, from random
    gradients and then from channel-orthogonal ones, whose projection takes
    out the first step's momentum along the weights. The parameters' change
    on the card against the CPU's within ZOO_PARAM_RTOL (relative to the
    CPU's change), the card's with the channel view on the torch axis
    beyond it."""
    params = _host(dict(_cut_vitb("cpu").named_parameters()))
    gen = torch.Generator().manual_seed(2)
    grads = [{n: torch.randn(p.shape, generator=gen)
              for n, p in params.items()},
             _channel_orthogonal(params, seed=3)]
    lr = np.full(2, 1e-3, np.float32)

    def one(dev: str, fault: bool) -> dict:
        p = {n: t.to(dev).clone() for n, t in params.items()}
        tx = optim.create_optimizer(p, opt="adamp", lr_schedule=lr,
                                    weight_decay=0.05)
        st = tx.init(p)
        with _channels_on_torch_axis() if fault else contextlib.nullcontext():
            for g in grads:
                tx.update({n: t.to(dev) for n, t in g.items()}, st, p)
        return {n: t - params[n] for n, t in _host(p).items()}

    cpu = one("cpu", False)
    out = {"card_vs_cpu": _rel(one("cuda", False), cpu),
           "torch_axis_fault_vs_cpu": _rel(one("cuda", True), cpu),
           "update_rel": _rel({n: params[n] + d for n, d in cpu.items()},
                              params)}
    if not out["card_vs_cpu"] <= ZOO_PARAM_RTOL:
        raise AssertionError(f"AdamP card vs CPU: {out}")
    if not out["torch_axis_fault_vs_cpu"] > ZOO_PARAM_RTOL:
        raise AssertionError(f"the planted AdamP fault passed: {out}")
    return out


def _radam_rho(t: int, b2: float) -> float:
    """optax.scale_by_radam's rho_t at update t (>= 5: rectified)."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    return ro_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)


def phase_zoo_parity() -> dict:
    """Every distinct first-order zoo entry: ZOO_PARITY_STEPS f32 steps
    (ZOO_PARITY_LONG_STEPS for ZOO_PARITY_LONG, so that their later branch
    runs) of the ViT-B pretrain at full width cut to 2+1 Blocks, B=1, on
    the card (K1/K2's f32 kernels) and on the CPU (their plain versions)
    from the same weights and masks; then AdamP's planted fault. Returns
    the card runs' launches."""
    cfg, batch, masks = _parity_inputs(ZOO_PARITY_LONG_STEPS)
    t0 = time.perf_counter()
    total = dict.fromkeys(fa.KERNELS, 0)
    results = {}
    for opt in ZOO_PARITY_OPTS:
        steps = (ZOO_PARITY_LONG_STEPS if opt in ZOO_PARITY_LONG
                 else ZOO_PARITY_STEPS)
        lr = np.full(steps, 1e-4, np.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            model = _cut_vitb(dev)
            named = dict(model.named_parameters())
            start = _host(named)
            tx = optim.create_optimizer(named, opt=opt, lr_schedule=lr,
                                        betas=(0.9, 0.95), weight_decay=0.05)
            state = TrainState.create(model, tx)
            step = make_pretrain_step(model, tx, cfg, lr, device=dev)
            fa.reset_launch_counts()
            losses, norms = [], []
            for s in range(steps):
                state, m = step(state, {k: v.to(dev) for k, v in
                                        batch.items()}, None, 0.5,
                                mask=masks[s].to(dev))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            slow = state.opt_state.slow
            runs[dev] = {"loss": losses, "grad_norm": norms,
                         "params": _host(named),
                         "launches": dict(fa.launch_counts),
                         "synced": slow is not None and any(
                             not torch.equal(t.cpu(), start[n])
                             for n, t in slow.items())}
        card, cpu = runs["cuda"], runs["cpu"]
        for k, v in card["launches"].items():
            total[k] += v
        if min(card["launches"][k] for k in fa.QKV_F32_KERNELS) < 1:
            raise AssertionError(f"{opt}: the card run skipped a kernel: "
                                 f"{card['launches']}")
        res = {"params_rel": _rel(card["params"], cpu["params"]),
               "update_err": _rel(
                   {n: t - start[n] for n, t in card["params"].items()},
                   {n: t - start[n] for n, t in cpu["params"].items()}),
               "update_rel": _rel(cpu["params"], start),
               "loss_rel": max(abs(a - b) / abs(b) for a, b in
                               zip(card["loss"], cpu["loss"])),
               "grad_norm_rel": max(abs(a - b) / abs(b) for a, b in
                                    zip(card["grad_norm"],
                                        cpu["grad_norm"])),
               "loss": card["loss"], "steps": steps}
        if opt.startswith("lookahead_") and not (card["synced"]
                                                 and cpu["synced"]):
            raise AssertionError(f"{opt}: no lookahead sync in {steps} "
                                 f"steps (k = {LOOKAHEAD_K})")
        if opt == "radam":
            res["rho_last"] = _radam_rho(steps, b2=0.95)
            if not res["rho_last"] >= 5.0:
                raise AssertionError(f"radam never rectified: {res}")
        results[opt] = res
        worst = max(res["params_rel"], res["loss_rel"], res["grad_norm_rel"])
        if not (worst <= ZOO_PARAM_RTOL
                and res["update_err"] <= ZOO_UPDATE_RTOL):
            raise AssertionError(f"{opt}: card vs CPU beyond "
                                 f"{ZOO_PARAM_RTOL} / {ZOO_UPDATE_RTOL}: "
                                 f"{res}")
    fault = _adamp_fault_check()
    emit("zoo_parity", model=MODEL, depth="2+1", dtype="float32", batch=1,
         steps=ZOO_PARITY_STEPS, steps_long=ZOO_PARITY_LONG_STEPS,
         bound=ZOO_PARAM_RTOL, results=results,
         adamp_fault=fault, launches=total,
         seconds=time.perf_counter() - t0)
    return total


def _timed_chain(step, state, batch, gen, n: int):
    """n steps between two CUDA events: (state, ms a step, last metrics)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, m = step(state, batch, gen, 0.5)
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / n, m


def phase_zoo_steps(smi: str) -> dict:
    """The full ViT-B pretrain step (bf16, B=16, K1/K2) with each of
    ZOO_STEP_OPTS: step ms from CUDA events over a chain of steps, the
    update's own ms (ZOO_STEP_CHAIN updates of a second optimizer of the
    same entry on the last step's gradients), peak memory and the launches
    per step (phase_step's). Returns the launches."""
    n = ZOO_STEP_CHAIN
    per_step = STEP_LAUNCHES[MODEL]
    total = dict.fromkeys(fa.KERNELS, 0)
    out = {}
    for opt in ZOO_STEP_OPTS:
        model, state, step, gen, batch = build_step(STEP_BATCH, opt=opt)
        state, _ = step(state, batch, gen, 0.5)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        state, step_ms, m = _timed_chain(step, state, batch, gen, n)
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss = float(m["loss"])
        if launches != {k: n * v for k, v in per_step.items()}:
            raise AssertionError(f"{opt}: launches {launches}, expected "
                                 f"{n} x {per_step}")
        if not np.isfinite(loss):
            raise AssertionError(f"{opt}: loss {loss}")
        for k, v in launches.items():
            total[k] += v
        named = state.params
        grads = {k: p.grad for k, p in named.items()}
        tx = optim.create_optimizer(named, opt=opt, lr_schedule=np.full(
            1, 1e-6, np.float32), betas=(0.9, 0.95), weight_decay=0.05)
        st = tx.init(named)
        update_ms = time_ms(lambda: tx.update(grads, st, named), runs=5,
                            warmup=1, run_ms=0.0)
        out[opt] = {"step_ms": step_ms, "update_ms": update_ms,
                    "peak_mem_gib": peak, "loss": loss,
                    "launches_per_step": {k: v / n
                                          for k, v in launches.items()}}
        del model, state, step, batch, named, grads, tx, st
        torch.cuda.empty_cache()
    emit("zoo_steps", model=MODEL, dtype="bfloat16", batch=STEP_BATCH,
         chain=n, results=out, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi)
    return total


class _Recorder:
    """An optimizer that applies nothing and keeps the gradients and the
    probe its step hands it."""

    def init(self, params):
        return None

    def update(self, grads, state, params, hessian_diag=None):
        self.grads = _host(grads)
        self.hess = _host(hessian_diag)


def phase_adahessian_step(smi: str) -> dict:
    """adahessian: the full ViT-B pretrain step on the plain attention route
    (bf16, B=16: 29 GiB at peak), no kernel launched; its probe at 2+1
    Blocks in f32, card against CPU with the same injected z; one ViT-B
    BB-focused MCA finetune step under the fp16 loss scale (B=10: 71 GiB at
    peak; an OOM fails the phase). Returns the launches (all 0)."""
    fa.reset_launch_counts()
    model, state, step, gen, batch = build_step(STEP_BATCH, opt="adahessian")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch, gen, 0.5)  # warm-up
    state, ms, m = _timed_chain(step, state, batch, gen, ADAHESSIAN_CHAIN)
    vitb = {"step_ms": ms, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "batch": STEP_BATCH}
    del model, state, step, batch
    torch.cuda.empty_cache()
    if not np.isfinite(vitb["loss"]):
        raise AssertionError(f"adahessian ViT-B: {vitb}")

    # the probe, card against CPU, z injected
    cfg, batch, masks = _parity_inputs(1)
    lr = np.full(1, 1e-4, np.float32)
    probe = {}
    for dev in ("cpu", "cuda"):
        model = _cut_vitb(dev, attn_impl="xla")
        named = dict(model.named_parameters())
        if dev == "cpu":
            z = optim.rademacher(named, torch.Generator().manual_seed(11))
        rec = _Recorder()
        step = make_pretrain_step(model, rec, cfg, lr, device=dev,
                                  second_order=True)
        _, m = step(TrainState.create(model, rec),
                    {k: v.to(dev) for k, v in batch.items()}, None, 0.5,
                    mask=masks[0].to(dev),
                    probe_z=[{n: t.to(dev) for n, t in z.items()}])
        probe[dev] = {"loss": float(m["loss"]), "grads": rec.grads,
                      "hess": rec.hess}
    parity = {"probe_rel": _rel(probe["cuda"]["hess"], probe["cpu"]["hess"]),
              "grads_rel": _rel(probe["cuda"]["grads"],
                                probe["cpu"]["grads"]),
              "loss_rel": abs(probe["cuda"]["loss"] - probe["cpu"]["loss"])
              / abs(probe["cpu"]["loss"])}
    if not max(parity.values()) <= ZOO_PARAM_RTOL:
        raise AssertionError(f"adahessian probe card vs CPU: {parity}")

    model, state, step, gen, batch, _ = build_finetune_step(
        FT_BATCH, dtype="float16", opt="adahessian")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    ft = {"step_ms": (time.perf_counter() - t0) * 1e3,
          "metrics": {k: float(v) for k, v in m.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "batch": FT_BATCH}
    del model, state, step, batch
    torch.cuda.empty_cache()
    launches = dict(fa.launch_counts)
    emit("adahessian_step", model=MODEL, dtype="bfloat16", vitb=vitb,
         probe_parity=dict(parity, depth="2+1", dtype="float32",
                           bound=ZOO_PARAM_RTOL),
         finetune_fp16=dict(ft, model=FINETUNE_MODEL), launches=launches,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if any(launches.values()):
        raise AssertionError(f"adahessian launched kernels: {launches}")
    m = ft["metrics"]
    if not (np.isfinite(m["loss"]) and m["skipped"] == 0.0
            and m["loss_scale"] == 128.0):
        raise AssertionError(f"adahessian fp16 finetune step: {ft}")
    return launches


def phase_zoo_runner(smi: str) -> dict:
    """The ViT-S pretrain runner with --opt lookahead_adamp: 2 epochs, the
    last checkpoint read back into a fresh state equal to the run's own,
    then resumed for a third epoch (the lookahead syncs at step 6)."""
    argv = RUNNER_ARGS + ["--opt", ZOO_RUNNER_OPT]
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        args = pretrain_mofo.get_args(argv + ["--epochs", "2",
                                              "--output_dir", out],
                                      mofo_defaults=True)
        first, _, s1 = _quiet_main(pretrain_mofo.main, args)
        model = create_model(VITS_MODEL, seed=9)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, opt=ZOO_RUNNER_OPT,
                                    lr_schedule=np.ones(1, np.float32))
        back = TrainState.create(model, tx)
        ckpt.load_checkpoint(os.path.join(out, "checkpoint-1.pth"), model,
                             back)
        ours, theirs = first.opt_state, back.opt_state
        differ = [f"{f}:{n}" for f, buf in ours.buffers.items()
                  for n, t in buf.items()
                  if not torch.equal(t, theirs.buffers[f][n])]
        differ += [f"slow:{n}" for n, t in ours.slow.items()
                   if not torch.equal(t, theirs.slow[n])]
        differ += [n for n, p in first.params.items()
                   if not torch.equal(p.detach(), back.params[n].detach())]
        counts = [ours.count, theirs.count]
        del model, named, tx, back
        args = pretrain_mofo.get_args(argv + ["--epochs", "3",
                                              "--output_dir", out],
                                      mofo_defaults=True)
        last, _, s2 = _quiet_main(pretrain_mofo.main, args)
        launches = dict(fa.launch_counts)
        log = _runner_log(out)
    per_step = {k: v / last.step for k, v in launches.items()}
    emit("zoo_runner", model=VITS_MODEL, opt=ZOO_RUNNER_OPT, args=argv,
         steps=[first.step, last.step], counts_read_back=counts,
         differ_after_read_back=differ[:5], seconds=[s1, s2],
         losses=[line["train_loss"] for line in log],
         launches_per_step=per_step, nvidia_smi=smi)
    if differ or counts != [4, 4]:
        raise AssertionError(f"the state read back differs: {differ[:5]}, "
                             f"counts {counts}")
    if [first.step, last.step] != [4, 6] or [
            line["epoch"] for line in log] != [0, 1, 2]:
        raise AssertionError(f"the runner took other steps: {log}")
    if not all(np.isfinite(line["train_loss"]) for line in log):
        raise AssertionError(f"non-finite losses: {log}")
    if per_step != STEP_LAUNCHES[VITS_MODEL]:
        raise AssertionError(f"launches per step {per_step}")
    return launches


def _run_ranks(args: list, world: int, timeout: float = 900) -> tuple:
    """`world` processes of python -m mofo_tpu_torch.tools.mesh_ranks
    <args> on cuda:0 (RANK and WORLD_SIZE set, LOCAL_RANK 0); their outputs
    and the seconds they took. A rank that fails fails the phase."""
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mofo_tpu_torch.tools.mesh_ranks", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, out in zip(procs, outs):
        if proc.returncode != 0:
            print(out[-6000:], flush=True)
            raise AssertionError(f"a mesh rank exited {proc.returncode}")
    return outs, time.perf_counter() - t0


def phase_mesh_step(smi: str) -> dict:
    """4 ranks on the (1, 2, 2) mesh against one process at G' on the same
    card. Returns the ranks' launches, summed."""
    world = mesh_ranks.WORLD
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = mesh_ranks.mesh_runs(None)
        ref_s = time.perf_counter() - t0
        runs = list(ref)
        torch.save({r: ref[r].pop("params") for r in runs},
                   os.path.join(tmp, "reference.pt"))
        torch.cuda.empty_cache()
        _, ranks_s = _run_ranks(["step", tmp], world)
        got = [torch.load(os.path.join(tmp, f"rank-{r}.pt"))
               for r in range(world)]
    report, bad = {}, []
    for run in runs:
        rtol = BF16_STEP_RTOL if "bfloat16" in run else DDP_F32_RTOL
        want, rows = ref[run], []
        for r, out in enumerate(got):
            res = {f"{k}_rel_diff": max(abs(a - b) / abs(b)
                                        for a, b in zip(out[run][k], want[k]))
                   for k in ("loss", "grad_norm")}
            res.update(params_max_abs_err=out[run]["params_max_abs_err"],
                       step_ms=out[run]["ms"], loss=out[run]["loss"],
                       grad_norm=out[run]["grad_norm"],
                       launches=out[run]["launches"])
            bad += [f"{run} rank {r} {k}" for k in ("loss", "grad_norm")
                    if not res[f"{k}_rel_diff"] <= rtol]
            if "float32" in run and not res["params_max_abs_err"] <= \
                    DDP_F32_ATOL:
                bad.append(f"{run} rank {r} parameters")
            if out[run]["launches"] != want["launches"]:
                bad.append(f"{run} rank {r} launches {out[run]['launches']}"
                           f" != one process's {want['launches']}")
            if "eval" in want:
                b = out["coord"][0] * 2 + out["coord"][1]
                n = len(out[run]["logits"])
                res["logits_max_abs_err"] = (
                    out[run]["logits"] - want["logits"][b * n:(b + 1) * n]
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
            rows.append(res)
        report[run] = {"ranks": rows, "bound_rtol": rtol,
                       "one_process": {k: want[k] for k in (
                           "loss", "grad_norm", "ms", "launches", "eval",
                           "multiview") if k in want}}
    first = ref["pretrain_float32"]["loss"][0]
    planted = [abs(out["contiguous_qkv_loss"] - first) / abs(first)
               for out in got]
    per_step = {k: v // mesh_ranks.STEPS["pretrain_bfloat16"] for k, v in
                got[0]["pretrain_bfloat16"]["launches"].items()}
    launches = {k: sum(out[run]["launches"][k] for out in got
                       for run in runs) for k in fa.KERNELS}
    emit("mesh_step", mesh=dict(zip(mesh_lib.AXES, mesh_ranks.SHAPE)),
         backend="gloo", device="cuda:0 (all 4 ranks)",
         coords=[out["coord"] for out in got], runs=report,
         batch_per_device={"pretrain": mesh_ranks.PRETRAIN_B,
                           "finetune": mesh_ranks.FINETUNE_B},
         steps=mesh_ranks.STEPS, pretrain_bf16_launches_per_step=per_step,
         planted_contiguous_qkv={"loss_rel_diff": planted,
                                 "bound": DDP_F32_RTOL},
         one_process_s=ref_s, ranks_s=ranks_s,
         ranks_run_s=[out["seconds"] for out in got], launches=launches,
         nvidia_smi=smi)
    if not all(x > DDP_F32_RTOL for x in planted):
        bad.append(f"the contiguous qkv split passed: {planted}")
    blocks = sum(mesh_ranks.DEPTH)  # one launch of each a Block
    if any(per_step[k] != blocks for k in fa.QKV_KERNELS):
        bad.append(f"K1/K2 launches a bf16 step {per_step}, not {blocks}")
    if bad:
        raise AssertionError(f"mesh ranks vs one process: {bad}")
    return launches


def _ranks_against(runs_fn, mode: str) -> tuple:
    """One process's runs_fn(None) on this card, then the 4 ranks of
    mesh_ranks <mode> held against its reference.pt: (one process's
    results, the ranks', one process's seconds, the ranks')."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = runs_fn(None)
        ref_s = time.perf_counter() - t0
        torch.save(mesh_ranks.reference_of(ref),
                   os.path.join(tmp, "reference.pt"))
        for res in ref.values():
            res.pop("init")
        torch.cuda.empty_cache()
        _, ranks_s = _run_ranks([mode, tmp], mesh_ranks.WORLD)
        got = [torch.load(os.path.join(tmp, f"rank-{r}.pt"))
               for r in range(mesh_ranks.WORLD)]
    return ref, got, ref_s, ranks_s


def _rank_row(res: dict, want: dict, steps: int) -> dict:
    """A rank's run against one process's: the relative differences of
    the losses and gradient norms, the parameters' (and probes') errors,
    its step ms, peak memory, launches and collectives a step."""
    row = {f"{k}_rel_diff": max(abs(a - b) / abs(b)
                                for a, b in zip(res[k], want[k]))
           for k in ("loss", "grad_norm")}
    row.update({k: res[k] for k in ("params_max_abs_err", "change_rel",
                                    "probe_rel_err") if k in res})
    row.update(step_ms=res["ms"], peak_gib=res["peak_bytes"] / 2 ** 30,
               launches=res["launches"],
               collectives_a_step={k: [c / steps for c in v] for k, v in
                                   res["collectives"].items()})
    return row


def phase_mesh_zoo(smi: str) -> dict:
    """Adafactor, AdamP and SGDP (and AdamW beside them) on the (1, 2, 2)
    ranks against one process at G' on the same card. Returns the ranks'
    launches, summed."""
    ref, got, ref_s, ranks_s = _ranks_against(mesh_ranks.zoo_runs, "zoo")
    yardstick = max(out["pretrain_adamw"]["change_rel"] for out in got)
    change_bound = max(ZOO_UPDATE_RTOL, MESH_ZOO_ADAMW_FACTOR * yardstick)
    report, bad = {}, []
    for run, want in ref.items():
        bf16 = run.startswith("pretrain")
        rtol = BF16_STEP_RTOL if bf16 else DDP_F32_RTOL
        rows = [_rank_row(out[run], want, mesh_ranks.ZOO_STEPS)
                for out in got]
        for r, row in enumerate(rows):
            bad += [f"{run} rank {r} {k}" for k in ("loss", "grad_norm")
                    if not row[f"{k}_rel_diff"] <= rtol]
            if bf16 and run != "pretrain_adamw" and not (
                    row["change_rel"] <= change_bound):
                bad.append(f"{run} rank {r} change {row['change_rel']}")
            if not bf16 and not row["params_max_abs_err"] <= DDP_F32_ATOL:
                bad.append(f"{run} rank {r} parameters")
            if row["launches"] != want["launches"]:
                bad.append(f"{run} rank {r} launches {row['launches']} != "
                           f"one process's {want['launches']}")
        report[run] = {"ranks": rows, "dtype": "bfloat16" if bf16
                       else "float32",
                       "one_process": {"loss": want["loss"],
                                       "grad_norm": want["grad_norm"],
                                       "step_ms": want["ms"],
                                       "peak_gib": want["peak_bytes"] / 2
                                       ** 30, "launches": want["launches"]}}
    launches = {k: sum(out[run]["launches"][k] for out in got for run in ref)
                for k in fa.KERNELS}
    emit("mesh_zoo", mesh=dict(zip(mesh_lib.AXES, mesh_ranks.SHAPE)),
         backend="gloo", device="cuda:0 (all 4 ranks)", runs=report,
         steps=mesh_ranks.ZOO_STEPS,
         batch_per_device={"pretrain": mesh_ranks.PRETRAIN_B,
                           "finetune": mesh_ranks.FINETUNE_B},
         bounds={"bf16_rtol": BF16_STEP_RTOL,
                 "bf16_change_rel": change_bound,
                 "adamw_change_rel": yardstick,
                 "f32_rtol": DDP_F32_RTOL, "f32_atol": DDP_F32_ATOL},
         one_process_s=ref_s, ranks_s=ranks_s,
         ranks_run_s=[out["seconds"] for out in got], launches=launches,
         nvidia_smi=smi)
    if bad:
        raise AssertionError(f"mesh_zoo: {bad}")
    return launches


def phase_mesh_adahessian(smi: str) -> dict:
    """AdaHessian on the (1, 2, 2) ranks against one process at G' on the
    same card. Returns the ranks' launches, summed (all 0)."""
    ref, got, ref_s, ranks_s = _ranks_against(mesh_ranks.adahessian_runs,
                                              "adahessian")
    want = ref["pretrain_adahessian"]
    rows = [_rank_row(out["pretrain_adahessian"], want, mesh_ranks.AH_STEPS)
            for out in got]
    bad = []
    for r, row in enumerate(rows):
        bad += [f"rank {r} {k}" for k in ("loss", "grad_norm")
                if not row[f"{k}_rel_diff"] <= DDP_F32_RTOL]
        bad += [f"rank {r} {k} {row[k]}" for k in ("params_max_abs_err",
                                                    "probe_rel_err")
                if not row[k] <= MESH_AH_BOUND]
        if row["launches"] != want["launches"] or any(
                row["launches"].values()):
            bad.append(f"rank {r} launches {row['launches']}")
    emit("mesh_adahessian", model=MODEL, dtype="float32",
         depth={"encoder": mesh_ranks.AH_DEPTH[0],
                "decoder": mesh_ranks.AH_DEPTH[1]},
         mesh=dict(zip(mesh_lib.AXES, mesh_ranks.SHAPE)), backend="gloo",
         device="cuda:0 (all 4 ranks)", batch_per_device=mesh_ranks.AH_B,
         steps=mesh_ranks.AH_STEPS, eps=mesh_ranks.AH_EPS, ranks=rows,
         one_process={"loss": want["loss"], "grad_norm": want["grad_norm"],
                      "step_ms": want["ms"],
                      "peak_gib": want["peak_bytes"] / 2 ** 30},
         bounds={"rtol": DDP_F32_RTOL, "probe_and_params": MESH_AH_BOUND},
         one_process_s=ref_s, ranks_s=ranks_s,
         ranks_run_s=[out["seconds"] for out in got], nvidia_smi=smi)
    if bad:
        raise AssertionError(f"mesh_adahessian: {bad}")
    return {k: sum(out["pretrain_adahessian"]["launches"][k] for out in got)
            for k in fa.KERNELS}


def phase_mesh_memory(smi: str) -> dict:
    """ViT-L at MESH_MEMORY_DEPTH on the (1, 2, 2) ranks: state bytes,
    peak memory and step ms a rank. Returns the launches, summed."""
    enc, dec = MESH_MEMORY_DEPTH
    with tempfile.TemporaryDirectory() as tmp:
        _, seconds = _run_ranks(["memory", tmp, str(enc), str(dec)],
                                mesh_ranks.WORLD)
        got = [torch.load(os.path.join(tmp, f"memory-{r}.pt"))
               for r in range(mesh_ranks.WORLD)]
    rows, bad = [], []
    for r, out in enumerate(got):
        one = out["one_process_param_bytes"]
        state = out["param_bytes"] + out["grad_bytes"] + out["moment_bytes"]
        off = abs(out["param_bytes"] - out["analytic_param_bytes"]) / \
            out["analytic_param_bytes"]
        rows.append({
            "coord": out["coord"], "param_bytes": out["param_bytes"],
            "grad_bytes": out["grad_bytes"],
            "moment_bytes": out["moment_bytes"],
            "state_bytes": state, "one_process_state_bytes": 4 * one,
            "state_share": state / (4 * one),
            "analytic_param_bytes": out["analytic_param_bytes"],
            "analytic_share": out["analytic_param_bytes"] / one,
            "param_bytes_vs_analytic": off,
            "peak_bytes": out["peak_bytes"], "step_ms": out["step_ms"],
            "loss": out["loss"], "launches": out["launches"]})
        if not off <= MESH_MEMORY_RTOL or out["grad_bytes"] != \
                out["param_bytes"] or out["moment_bytes"] != \
                2 * out["param_bytes"]:
            bad.append(f"rank {r}: {rows[-1]}")
        if not all(np.isfinite(out["loss"])):
            bad.append(f"rank {r} losses {out['loss']}")
        want = enc + dec
        if any(out["launches"][k] != mesh_ranks.MEMORY_STEPS * want
               for k in fa.QKV_KERNELS):
            bad.append(f"rank {r} launches {out['launches']}")
    emit("mesh_memory", model=mesh_ranks.LARGE,
         depth={"encoder": enc, "decoder": dec}, dtype="bfloat16",
         mesh=dict(zip(mesh_lib.AXES, mesh_ranks.SHAPE)),
         batch_per_device=mesh_ranks.PRETRAIN_B,
         steps=mesh_ranks.MEMORY_STEPS, ranks=rows, seconds=seconds,
         bound=MESH_MEMORY_RTOL, nvidia_smi=smi)
    if bad:
        raise AssertionError(f"mesh_memory: {bad}")
    return {k: sum(out["launches"][k] for out in got) for k in fa.KERNELS}


def phase_mesh_runner(smi: str) -> dict:
    """cli.pretrain_mofo on the (1, 2, 2) ranks for epoch 0, resumed in
    this process for epoch 1, against both epochs in one process. Returns
    the ranks' launches, summed."""
    mesh_flags = ["--mesh_fsdp", "2", "--mesh_model", "2"]
    B = mesh_ranks.PRETRAIN_B
    with tempfile.TemporaryDirectory() as tmp:
        pt, one = os.path.join(tmp, "pt"), os.path.join(tmp, "one")
        _, mesh_s = _run_ranks(
            ["cli", tmp, "pretrain_mofo", *MESH_RUNNER_ARGS, "--batch_size",
             str(B), "--epochs", "1", "--output_dir", pt, *mesh_flags],
            mesh_ranks.WORLD)
        mesh_log = _runner_log(pt)
        files = sorted(os.listdir(pt))
        names = set(torch.load(os.path.join(pt, "checkpoint-0.pth"),
                               map_location="cpu",
                               weights_only=True)["model"])
        launches = []
        for r in range(mesh_ranks.WORLD):
            with open(os.path.join(tmp, f"counts-{r}.json")) as f:
                launches.append(json.load(f))
        G = B * mesh_ranks.WORLD
        args = MESH_RUNNER_ARGS + ["--batch_size", str(G), "--epochs", "2"]
        _, resumed_text, resume_s = _quiet_main(
            pretrain_mofo.main, pretrain_mofo.get_args(
                args + ["--output_dir", pt], mofo_defaults=True))
        resumed = _runner_log(pt)
        with mock.patch.object(P, "ShardedSampler",
                               mesh_ranks.coord_order(2, G // 2)):
            _, _, one_s = _quiet_main(pretrain_mofo.main,
                                      pretrain_mofo.get_args(
                                          args + ["--output_dir", one],
                                          mofo_defaults=True))
        want = _runner_log(one)
        ref_names = set(torch.load(os.path.join(one, "checkpoint-0.pth"),
                                   map_location="cpu",
                                   weights_only=True)["model"])
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(resumed, want)]
           for k in ("train_loss", "train_grad_norm")}
    problems = []
    if [x["epoch"] for x in mesh_log] != [0] or files != [
            "checkpoint-0.pth", "log.txt"]:
        problems.append(f"mesh run: log {mesh_log}, files {files}")
    if "auto-resumed at epoch 1" not in resumed_text or [
            x["epoch"] for x in resumed] != [0, 1]:
        problems.append(f"the one-process call did not resume: {resumed}")
    if names != ref_names or any(n.startswith("module.") for n in names):
        problems.append(f"checkpoint names {sorted(names ^ ref_names)[:4]}")
    if not all(x <= DDP_F32_RTOL for v in rel.values() for x in v):
        problems.append(f"resumed vs one process {rel}")
    per_rank_steps = 2  # one of each a Block: 12 encoder, the decoder's
    want_launches = dict.fromkeys(
        fa.QKV_F32_KERNELS, per_rank_steps * (12 + MESH_RUNNER_DECODER))
    for r, counts_r in enumerate(launches):
        if {k: counts_r[k] for k in fa.QKV_F32_KERNELS} != want_launches:
            problems.append(f"rank {r} launches {counts_r}")
    emit("mesh_runner", model=MODEL, dtype="float32",
         mesh=dict(zip(mesh_lib.AXES, mesh_ranks.SHAPE)),
         batch_per_device=B, global_batch=G,
         mesh_epoch=[{k: x[k] for k in ("epoch", "train_loss",
                                        "train_grad_norm", "step_s")}
                     for x in mesh_log],
         resumed=[{k: x[k] for k in ("epoch", "train_loss",
                                     "train_grad_norm")} for x in resumed],
         one_process=[{k: x[k] for k in ("epoch", "train_loss",
                                         "train_grad_norm")} for x in want],
         rel_diff=rel, bound=DDP_F32_RTOL, files=files,
         seconds={"mesh": mesh_s, "resume": resume_s, "one_process": one_s},
         launches=launches, nvidia_smi=smi)
    if problems:
        raise AssertionError(f"mesh_runner: {problems}")
    return {k: sum(c[k] for c in launches) for k in fa.KERNELS}


@contextlib.contextmanager
def _k2_without_dq():
    """K2's dQ kernel runs and its output is zeroed: attention passes no
    gradient to q. It measures how far the convergence check reaches into
    a kernel's backward (printed, not a gate)."""
    kept = fa.qkv_attn_bwd_dq

    def zeroed(qkv, out, lse, dout, dqkv, *args, **kwargs):
        kept(qkv, out, lse, dout, dqkv, *args, **kwargs)
        dqkv[..., :dqkv.shape[-1] // 3].zero_()

    fa.qkv_attn_bwd_dq = zeroed
    try:
        yield
    finally:
        fa.qkv_attn_bwd_dq = kept


def _arm_launches(phase: str, art: dict, kernel_arms) -> dict:
    """Each K1/K2 kernel launched steps x the model's attention Blocks
    times in each of `kernel_arms`, no kernel in the other arms; returns
    the launches summed over the arms."""
    steps, blocks = art["steps"], art["attention_blocks"]
    for arm, got in art["launches"].items():
        want = ({k: steps * blocks for k in fa.QKV_KERNELS}
                if arm in kernel_arms else {})
        if got != want:
            raise AssertionError(f"{phase} {arm}: launches {got}, "
                                 f"expected {want}")
    return {k: sum(a.get(k, 0) for a in art["launches"].values())
            for k in fa.KERNELS}


def _curve_fields(art: dict) -> dict:
    keys = ("steps", "batch", "max_rel_diff", "final_rel_diff",
            "fp16_max_rel_diff", "step_ms", "peak_gib", "launches",
            "attention_blocks", "stream_s", "wall_s", "gate_failures")
    return {k: art[k] for k in keys if k in art}


def draw_ab_streams() -> tuple:
    """Starts drawing the A/B phases' streams (the JAX tools' legacy numpy
    randn, CA's and CF's synthetic_stream: about a minute of one host core
    each) on two threads, so that they are ready when phases convergence_ab
    and convergence_ft come; returns the threads and the dict they fill."""
    streams = {}

    def draw(key, fn):
        try:
            streams[key] = fn(CONV_STEPS, CONV_BATCH)
        except BaseException as e:  # re-raised by ab_stream
            streams["error"] = e

    threads = [threading.Thread(target=draw, args=(key, fn), daemon=True,
                                name=f"{key}-stream")
               for key, fn in (("ab", CA.synthetic_stream),
                               ("ft", CF.synthetic_stream))]
    for t in threads:
        t.start()
    return threads, streams


def ab_streams_drawn(drawing: tuple) -> None:
    """Waits for draw_ab_streams' threads: before the first phase that
    forks (the loader's process workers), and before the streams are
    used."""
    threads, streams = drawing
    for t in threads:
        t.join()
    if "error" in streams:
        raise RuntimeError("drawing the A/B streams failed") from \
            streams["error"]


def ab_stream(drawing: tuple, key: str):
    """Stream `key` of draw_ab_streams, once drawn (it leaves the dict)."""
    ab_streams_drawn(drawing)
    return drawing[1].pop(key)


def phase_convergence_ab(smi: str, drawing: tuple) -> dict:
    """ViT-B MOFO pretrain, 50 steps at B=16: the bf16 production arm
    (K1/K2) against the f32 plain-attention arm (tools/convergence_ab.py)
    under mofo_tpu's gates, on the stream draw_ab_streams drew; then the
    production arm with a doubled learning rate (the planted fault the
    gates must reject) and with K2's dQ zeroed (how far the check reaches;
    printed)."""
    t0 = time.perf_counter()
    stream = ab_stream(drawing, "ab")
    art = CA.run(CONV_STEPS, CONV_BATCH, device="cuda", stream=stream)
    launches = _arm_launches("convergence_ab", art, ("prod",))
    planted = {}
    for name, fault in (("doubled_lr", doubled_lr),
                        ("k2_dq_zeroed", _k2_without_dq)):
        with fault():
            bad = CA.run_curve(*CA.PRODUCTION, CONV_STEPS, *stream,
                               device="cuda")["losses"]
        planted[name] = {
            "max_rel_diff": CA.rel_curve(bad, art["ref_losses"]),
            "gate_failures": CA.gate_failures(
                {"prod_losses": bad, "ref_losses": art["ref_losses"]})}
    emit("convergence_ab", model=MODEL, **_curve_fields(art),
         first_last={"prod": art["prod_losses"][::CONV_STEPS - 1],
                     "ref": art["ref_losses"][::CONV_STEPS - 1]},
         planted=planted, seconds=time.perf_counter() - t0,
         nvidia_smi=smi)
    if art["attention_blocks"] != 16:
        raise AssertionError(f"{art['attention_blocks']} attention Blocks")
    if art["gate_failures"]:
        raise AssertionError(f"convergence_ab: {art['gate_failures']}")
    if not planted["doubled_lr"]["gate_failures"]:
        raise AssertionError("the gates passed the doubled learning rate")
    return launches


def phase_convergence_ft(smi: str, drawing: tuple) -> tuple:
    """ViT-B classifier finetune, 50 steps at B=16, mixup on: the bf16 and
    fp16 (dynamic loss scale) arms through K1/K2 against the f32
    plain-attention arm (tools/convergence_ab_finetune.py) under
    mofo_tpu's gates, on the stream draw_ab_streams drew; each arm's peak
    memory. Returns the launches and the model's attention Blocks."""
    t0 = time.perf_counter()
    art = CF.run(CONV_STEPS, CONV_BATCH, fp16=True, device="cuda",
                 stream=ab_stream(drawing, "ft"))
    launches = _arm_launches("convergence_ft", art, ("prod", "fp16"))
    emit("convergence_ft", model=CF.MODEL, **_curve_fields(art),
         fp16_skipped_steps=art["fp16_skipped_steps"],
         fp16_loss_scale=art["fp16_loss_scale"],
         first_last={k: art[f"{k}_losses"][::CONV_STEPS - 1]
                     for k in ("prod", "ref", "fp16")},
         seconds=time.perf_counter() - t0, nvidia_smi=smi)
    if art["gate_failures"]:
        raise AssertionError(f"convergence_ft: {art['gate_failures']}")
    return launches, art["attention_blocks"]


def phase_e2e_recipe(smi: str) -> None:
    """tools/e2e_recipe.py on the card: 8 cv2-written mp4 files through the
    pretrain CLI (2 epochs), its last checkpoint into the finetune CLI
    (2 epochs, validation, the final test). At 32 px every Block takes the
    plain attention math: no kernel launch."""
    fa.reset_launch_counts()
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rec = e2e_recipe.main(["--device", "cuda"])
        torch.cuda.synchronize()
    except BaseException:
        print(text.getvalue()[-4000:], flush=True)
        raise
    launches = {k: v for k, v in fa.launch_counts.items() if v}
    emit("e2e_recipe", **rec, launches=launches, nvidia_smi=smi)
    if not np.isfinite(rec["pretrain_final_loss"]):
        raise AssertionError(f"pretrain loss {rec['pretrain_final_loss']}")
    if rec["finetune_init_tensors"] < 1 or [
            rec["pretrain_steps"], rec["finetune_steps"]] != [4, 4]:
        raise AssertionError(f"e2e_recipe: {rec}")
    if not np.isfinite(rec["finetune_last_epoch"]["val_loss"]) or launches:
        raise AssertionError(f"e2e_recipe: {rec}, launches {launches}")


def phase_overfit_real(smi: str, blocks: int) -> dict:
    """tools/overfit_real.py at its defaults: the finetune CLI (ViT-B, B=8,
    in a subprocess that writes its launch counts) on 8 class-pattern mp4
    files for OVERFIT_EPOCHS epochs; at OVERFIT_FULL epochs it must reach
    100% validation accuracy on the training clips, in a shorter run the
    train loss must fall. Each train step launches K1/K2 `blocks` times,
    each eval call K1's forward."""
    with tempfile.TemporaryDirectory() as tmp:
        counts = os.path.join(tmp, "launches.json")
        rec = overfit_real.run(tmp, epochs=OVERFIT_EPOCHS, device="cuda",
                               launch_counts=counts)
        with open(counts) as f:
            launches = json.load(f)
    splits = [split for _, _, split in P.expand_views(
        overfit_real.N_CLASSES * overfit_real.PER_CLASS, 2, 3)]
    n_eval = eval_calls(splits, rec["batch"], rec["n_videos"],
                        rec["epochs_run"])
    want = {**dict.fromkeys(fa.KERNELS, 0),
            **dict.fromkeys(fa.QKV_KERNELS, blocks * rec["steps"]),
            "qkv_attn_fwd": blocks * (rec["steps"] + n_eval)}
    emit("overfit_real", **rec, eval_calls=n_eval,
         launches={k: v for k, v in launches.items() if v}, nvidia_smi=smi)
    if launches != want:
        raise AssertionError(f"overfit_real launches {launches}, "
                             f"expected {want}")
    if OVERFIT_EPOCHS >= OVERFIT_FULL:
        if not rec["best_val_acc1"] >= 100.0:
            raise AssertionError(f"overfit_real: {rec['best_val_acc1']}")
    elif not (np.mean(rec["train_loss"][-OVERFIT_TAIL:])
              < rec["train_loss"][0] - OVERFIT_DROP):
        raise AssertionError(f"overfit_real: the loss did not fall: {rec}")
    return launches


def wide_entries(family: dict, name: str, shapes: dict) -> dict:
    """A kernel's entries of phase wide_head_dims for the kernels line:
    D -> its times, largest error, shape, width and output groups."""
    return {hd: {**times[name], "max_abs_err": errors[name],
                 "shape": "%s, width %d, %d groups" % (
                     shapes[hd], fa.head_dim_width(hd), split_groups(hd))}
            for hd, (errors, times) in family.items()}


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    drawing = draw_ab_streams()
    errors, timings, f32_timings = phase_kernels()
    qkv_head_dims = phase_qkv_head_dims(smi)
    precision = phase_f32_precision(smi)
    mh_errors, mh_timings, mh_f32_timings = phase_mh_kernels()
    mh_head_dims = phase_mh_head_dims(smi)
    launches = phase_step(smi)
    phase_parity()
    ft_launches, ft_step_ms, ft_loss = phase_finetune_step(smi)
    phase_finetune_parity()
    hm_errors, hm_timings, hm_f32_timings = phase_hm_kernels()
    head_dims = phase_hm_head_dims(smi)
    wide = phase_wide_head_dims(smi)
    phase_bf16_steps()
    vits_launches = phase_step(smi, "vits_step", VITS_MODEL, VITS_BATCH)
    phase_parity("vits_parity", VITS_MODEL,
                 fa.QKV_F32_KERNELS + fa.HM_F32_KERNELS)
    runner_launches = phase_runner(smi)
    phase_finetune_augment(smi, ft_step_ms)
    phase_fp16_finetune_step()
    ft_runner_launches = phase_finetune_runner(smi)
    ab_streams_drawn(drawing)  # no fork while a drawing thread runs
    real_launches = phase_real_data_runner(smi)
    later = {"launches_ddp_step": phase_ddp_step(smi),
             "launches_ddp_two_ranks": phase_ddp_two_ranks(smi),
             "launches_ddp_runner": phase_ddp_runner(smi),
             "launches_factory": phase_factory(smi),
             "launches_vis": phase_vis(smi),
             "launches_f32_eval": phase_f32_eval(smi)}
    later["launches_tiny_debug_step"] = phase_tiny_debug_step(smi)
    (later["launches_dropout_step"],
     later["launches_attn_dropout_step"]) = phase_dropout_step(smi, ft_loss)
    later["launches_attention_vis"] = phase_attention_vis(smi)
    phase_factory_chunks(smi)
    later["launches_zoo_parity"] = phase_zoo_parity()
    later["launches_zoo_steps"] = phase_zoo_steps(smi)
    later["launches_adahessian_step"] = phase_adahessian_step(smi)
    later["launches_zoo_runner"] = phase_zoo_runner(smi)
    later["launches_mesh_step"] = phase_mesh_step(smi)
    later["launches_mesh_memory"] = phase_mesh_memory(smi)
    later["launches_mesh_runner"] = phase_mesh_runner(smi)
    later["launches_mesh_zoo"] = phase_mesh_zoo(smi)
    later["launches_mesh_adahessian"] = phase_mesh_adahessian(smi)
    later["launches_convergence_ab"] = phase_convergence_ab(smi, drawing)
    later["launches_convergence_ft"], blocks = phase_convergence_ft(
        smi, drawing)
    phase_e2e_recipe(smi)
    later["launches_overfit_real"] = phase_overfit_real(smi, blocks)
    t_new = time.perf_counter()
    later["launches_large_presets"] = phase_large_presets(smi)
    later["launches_any_head_dim_steps"] = phase_any_head_dim_steps(smi)
    later["launches_wide_head_dim_steps"] = phase_wide_head_dim_steps(smi)
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
               for geo in ("encoder", "backbone", *MESH_GEOS,
                           *LARGE_CHECKS)},
            "f32": {geo: t[name] for geo, t in f32_timings.items()
                    if name in t},
            "head_dims": {
                hd: {**qkv_head_dims[hd][1][name],
                     "max_abs_err": qkv_head_dims[hd][0][name],
                     "shape": "(B=%d, N=%d, H=%d, D=%d) bf16, width %d" % (
                         *QKV_HEAD_DIM_CHECKS[hd]["long"], hd,
                         fa.head_dim_width(hd))}
                for hd in QKV_FLAT_HEAD_DIMS},
            "wide_head_dims": wide_entries(wide["qkv"], name, {
                hd: "(B=%d, N=%d, H=%d, D=%d) bf16" % (*geo, hd)
                for hd, geo in WIDE_QKV_CHECKS.items()}),
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
            "f32": mh_f32_timings.get(name),
            "launches_finetune_runner": ft_runner_launches[name],
            "launches_real_data": real_launches[name],
            **{key: counts[name] for key, counts in later.items()},
            "head_dims": {
                hd: {**mh_head_dims[hd][1][name],
                     "max_abs_err": mh_head_dims[hd][0][name],
                     "shape": "(B=%d, N=%d, H=%d, D=%d) bf16, kv bias, "
                              "width %d" % (*MH_HEAD_DIM_CHECKS[hd]["long"],
                                            hd, fa.head_dim_width(hd))}
                for hd in MH_HEAD_DIMS},
            "wide_head_dims": wide_entries(wide["mh"], name, {
                hd: "(B=%d, N=%d, H=%d, D=%d) bf16, kv bias" % (*geo, hd)
                for hd, geo in WIDE_MH_CHECKS.items()}),
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
            "f32": hm_f32_timings.get(name),
            "launches_vits_step": vits_launches[name],
            "launches_real_data": real_launches[name],
            **{key: counts[name] for key, counts in later.items()},
            "head_dims": {
                hd: {**head_dims[hd][1][name],
                     "max_abs_err": head_dims[hd][0][name],
                     "shape": "(BH=%d, N=%d, D=%d) bf16, width %d" % (
                         *HM_HEAD_DIM_CHECKS["long"], hd,
                         fa.head_dim_width(hd))}
                for hd in HM_HEAD_DIMS},
            "wide_head_dims": wide_entries(wide["hm"], name, {
                hd: "(BH=%d, N=%d, D=%d) bf16" % (*geo, hd)
                for hd, geo in WIDE_HM_CHECKS.items()}),
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
