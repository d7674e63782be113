"""The port's main path, built in one place for chip_smoke.py,
tools/profile_step.py and tests/test_torch_gpu.py.

- `build_step`: the ViT-B MOFO pretrain step of bench.py:119-157 (bf16,
  tube_bb masks, motion-weighted loss, AdamW with cosine schedules) on
  synthetic clips and boxes from a seed.
- `attention_against_plain`: the attention kernels (forward, dK/dV, dQ)
  and their plain PyTorch versions on the same qkv; `compare_with_plain` /
  `check_against_plain`: the bounds that hold one against the other, and
  `planted_faults`: two wrong outputs those bounds must reject.
"""

from __future__ import annotations

import torch

from mofo_tpu_torch.core.config import MaskingConfig, PretrainConfig
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.train import optim, schedules
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

MODEL = "pretrain_videomae_base_patch16_224"
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


def build_step(B: int):
    """The ViT-B MOFO pretrain step on CUDA at batch B.
    Returns (model, state, step_fn, generator, batch)."""
    cfg = PretrainConfig(batch_size=B, masking=MaskingConfig(
        mask_type="tube_bb"), motion_loss_weight=True)
    model = create_model(MODEL, dtype=torch.bfloat16, seed=1)
    lr = schedules.cosine_schedule(1.5e-4, 1e-5, 800, 100, 40)
    tx = optim.create_optimizer(dict(model.named_parameters()),
                                lr_schedule=lr, betas=(0.9, 0.95),
                                weight_decay=0.05)
    state = TrainState.create(model, tx)
    step = make_pretrain_step(model, tx, cfg, lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return model, state, step, gen, synthetic_batch(B, gen, "cuda")


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


def planted_faults(got: dict) -> dict:
    """Two wrong kernels' outputs that compare_with_plain must reject: dQ
    zeroed, and dK without its 1/log2(e) fix (bf16; in f32, dK times
    log2(e))."""
    dk = (got["dk"].float() * fa.LOG2E).to(got["dk"].dtype)
    return {"dq_zero": dict(got, dq=torch.zeros_like(got["dq"])),
            "dk_without_fix": dict(got, dk=dk)}
