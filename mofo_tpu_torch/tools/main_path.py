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
  `synthetic_finetune_batch`.
- `attention_against_plain`: the fused-qkv attention kernels (K1/K2:
  forward, dK/dV, dQ) and their plain PyTorch versions on the same qkv;
  `mh_inputs` / `mh_attention_against_plain`: the same for the masked
  multihead kernels (K3) on q, k, v and a kv bias row;
  `hm_inputs` / `hm_attention_against_plain`: the same for the head-major
  kernels (K4) on (B*H, N, 64) q, k, v;
  `compare_with_plain` / `check_against_plain`: the bounds that hold one
  against the other, and `planted_faults` / `hm_planted_faults`: wrong
  outputs those bounds must reject (`masked_kv_grad` checks that masked kv
  rows get zero dK/dV).
"""

from __future__ import annotations

import torch

from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.checkpoint import finetune_init_from_pretrain
from mofo_tpu_torch.train.finetune_step import make_finetune_step
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


def build_step(B: int, name: str = MODEL):
    """The MOFO pretrain step of model `name` (ViT-B by default) on CUDA at
    batch B. Returns (model, state, step_fn, generator, batch)."""
    cfg = PretrainConfig(model=name, batch_size=B, masking=MaskingConfig(
        mask_type="tube_bb"), motion_loss_weight=True)
    model = create_model(name, dtype=torch.bfloat16, seed=1)
    lr = schedules.cosine_schedule(1.5e-4, 1e-5, 800, 100, 40)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, tx, cfg, lr)
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
    """The BB-focused classifier of `cfg` (its fusing mode, classes, drop
    path and head init scale), compute dtype cfg.dtype."""
    kw = dict(img_size=cfg.input_size, all_frames=cfg.num_frames,
              num_classes=cfg.nb_classes, drop_path_rate=cfg.drop_path,
              init_scale=cfg.init_scale, fusing_method=cfg.fusing_mode,
              use_mean_pooling=cfg.use_mean_pooling)
    kw.update(overrides)
    return create_model(FINETUNE_MODEL, device=device,
                        dtype=getattr(torch, cfg.dtype), seed=seed, **kw)


def build_finetune_step(B: int):
    """The ViT-B BB-focused MCA finetune step on CUDA at batch B.
    Returns (model, state, step_fn, generator, batch, cfg)."""
    cfg = FinetuneConfig(batch_size=B, model=FINETUNE_MODEL)
    model = finetune_model(cfg)
    pretrain = create_model(MODEL, dtype=torch.bfloat16, seed=1)
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
    state = TrainState.create(model, tx)
    step = make_finetune_step(model, tx, cfg, lr, bb_focused=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_finetune_batch(B, gen, "cuda", cfg.nb_classes)
    return model, state, step, gen, batch, cfg


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


def hm_inputs(BH: int, N: int, dtype: torch.dtype, seed: int, device):
    """q, k, v (B*H, N, 64) contiguous, standard normal, for K4."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(BH, N, fa.HEAD_DIM, generator=g).to(dtype)
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
