"""MOFO pretrain-step throughput at the registry's widths on one card.

    python -m mofo_tpu_torch.tools.bench_pretrain_model
        [--model small|base|large] [--batch B] [--steps 30] [--device cpu]

Counterpart of tools/bench_pretrain_model.py, with its defaults (ViT-L, B
= 128 / 80 / 32 for small / base / large, 30 timed steps), its step
(pretrain_videomae_{model}_patch16_224 in bf16, tube_bb masks from
per-frame boxes, the motion loss weight 0.5, AdamW betas (0.9, 0.95), wd
0.05 on cosine_schedule(1.5e-4, 1e-5, 800, 100, 40); clips and boxes
drawn as bench.py draws them) and its FLOP count (pretrain_fwd_flops).
ViT-S's 192-wide decoder (3 x 64 heads) takes the head-major kernels
(K4); every other Block K1/K2.

It times the chain as tools/bench_finetune.py does (one warm-up step, then
--steps steps between two CUDA events and one synchronization), checks
every kernel's launches against step_launches, and prints one JSON line:
metric, value (clips/s), unit and extra.{step_ms, batch, mfu, peak_flops,
device, power_limit, loss, peak_mem_gib, tokens, launches_per_step}. It
runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools.bench_finetune import chain, record
from mofo_tpu_torch.tools.main_path import synthetic_batch
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

# enc_dim, enc_depth, dec_dim, dec_depth (the registry presets; decoder
# depth 4 is the runner default)
GEOM = {
    "small": (384, 12, 192, 4),
    "base": (768, 12, 384, 4),
    "large": (1024, 24, 512, 4),
}
# the JAX tool's batches: ~the ViT-B B=80 activation footprint scaled by
# encoder width
DEFAULT_BATCH = {"small": 128, "base": 80, "large": 32}
N_TOKENS, N_VISIBLE = 1568, 160
LOSS_WEIGHT = 0.5


def pretrain_fwd_flops(batch: int, enc_dim: int, enc_depth: int,
                       dec_dim: int, dec_depth: int) -> float:
    """tools/bench_pretrain_model.py's count: encoder Blocks on the visible
    tokens, the patch embedding, encoder_to_decoder, the decoder Blocks on
    all tokens and the head on the masked ones."""
    def block_flops(n, d, mlp=4):
        return 2 * n * d * (3 * d + d + 2 * mlp * d) + 4 * n * n * d

    enc = enc_depth * block_flops(N_VISIBLE, enc_dim)
    patch = 2 * N_TOKENS * 1536 * enc_dim
    e2d = 2 * N_VISIBLE * enc_dim * dec_dim
    dec = dec_depth * block_flops(N_TOKENS, dec_dim)
    head = 2 * (N_TOKENS - N_VISIBLE) * dec_dim * 1536
    return batch * (patch + enc + e2d + dec + head)


def step_launches(model: str, enc_depth: int, dec_depth: int) -> dict:
    """Each kernel's launches a step makes: a Block whose width is a
    multiple of 128 takes K1/K2, another K4 (its prep pass too)."""
    enc_dim, _, dec_dim, _ = GEOM[model]
    counts = dict.fromkeys(fa.KERNELS, 0)
    for dim, depth in ((enc_dim, enc_depth), (dec_dim, dec_depth)):
        for name in fa.QKV_KERNELS if dim % 128 == 0 else fa.HM_KERNELS:
            counts[name] += depth
    return counts


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=sorted(GEOM), default="large")
    p.add_argument("--batch", type=int, default=None,
                   help="clips a step (default: the JAX tool's)")
    p.add_argument("--steps", type=int, default=30,
                   help="timed steps after one warm-up step")
    p.add_argument("--encoder_depth", type=int, default=None,
                   help="cut the encoder to this many Blocks (checks)")
    p.add_argument("--decoder_depth", type=int, default=None,
                   help="cut the decoder to this many Blocks (checks)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        p.error("no CUDA device: the bench times the card; --device cpu "
                "runs the plain versions on the CPU")
    return args


def build(args: argparse.Namespace, seed: int = 1) -> dict:
    """The model, train state, step and batch of `args` on args.device."""
    dev = torch.device(args.device)
    enc_dim, enc_depth, dec_dim, dec_depth = GEOM[args.model]
    enc_depth = args.encoder_depth or enc_depth
    dec_depth = args.decoder_depth or dec_depth
    B = args.batch or DEFAULT_BATCH[args.model]
    name = f"pretrain_videomae_{args.model}_patch16_224"
    cfg = PretrainConfig(model=name, batch_size=B, masking=MaskingConfig(
        mask_type="tube_bb"), motion_loss_weight=True)
    model = create_model(name, device=dev, dtype=torch.bfloat16, seed=seed,
                         encoder_depth=enc_depth, decoder_depth=dec_depth)
    lr = schedules.cosine_schedule(1.5e-4, 1e-5, 800, 100, 40)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    gen = torch.Generator(device=dev).manual_seed(0)
    return {
        "args": args, "device": dev, "model": model, "cfg": cfg, "B": B,
        "tokens": N_TOKENS, "batch": synthetic_batch(B, gen, dev),
        "state": TrainState.create(model, tx),
        "step": make_pretrain_step(model, tx, cfg, lr, device=dev),
        "generator": gen,
        "fwd_flops": pretrain_fwd_flops(B, enc_dim, enc_depth, dec_dim,
                                        dec_depth),
        "launches_per_step": step_launches(args.model, enc_depth,
                                           dec_depth),
    }


def run_steps(run: dict, n: int) -> dict:
    """One warm-up step and a chain of n more (bench_finetune.chain)."""
    def once():
        run["state"], m = run["step"](run["state"], run["batch"],
                                      run["generator"], LOSS_WEIGHT)
        return m["loss"]

    return chain(run["device"], once, n, run["launches_per_step"])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = build(args)
    metric = f"clips/sec/card ViT-{args.model[0].upper()} MOFO pretrain"
    rec = record(run, run_steps(run, args.steps), metric, train=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
