"""The port's CUDA kernels on the card (`gpu` marker; each case skips when
no CUDA device is present).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(--noconftest skips tests/conftest.py, which sets up JAX.) The kernels are
held against their plain PyTorch versions with the bounds of
mofo_tpu_torch/tools/main_path.py (the ones chip_smoke.py uses), which the
CPU tests hold against the JAX package.
"""

import json

import numpy as np
import pytest
import torch

from mofo_tpu_torch.core.config import (
    FinetuneConfig,
    MaskingConfig,
    PretrainConfig,
)
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.ops import masking
from mofo_tpu_torch.cli import pretrain_mofo
from mofo_tpu_torch.tools.main_path import (
    VITS_MODEL,
    attention_against_plain,
    check_against_plain,
    compare_with_plain,
    finetune_model,
    hm_attention_against_plain,
    hm_inputs,
    hm_planted_faults,
    masked_kv_grad,
    mh_attention_against_plain,
    mh_inputs,
    planted_faults,
    synthetic_finetune_batch,
)
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.finetune_step import make_finetune_step
from mofo_tpu_torch.train.pretrain_step import make_pretrain_step
from mofo_tpu_torch.train.train_state import TrainState

pytestmark = pytest.mark.gpu
D = fa.HEAD_DIM
SCALE = D ** -0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, N, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, N, 3 * H * D, generator=g).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H", [(2, 160, 12), (1, 1568, 6), (2, 100, 2),
                                   (1, 64, 1)])
def test_kernels_match_plain(cuda, dtype, B, N, H):
    got, want = attention_against_plain(_qkv(B, N, H, dtype, cuda), H, SCALE)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_autograd_runs_the_kernels(cuda):
    x = _qkv(2, 100, 2, torch.float32, cuda, seed=1)
    qkv = x.clone().requires_grad_(True)
    fa.reset_launch_counts()
    (fa.flash_attention_qkv(qkv, scale=SCALE, num_heads=2) ** 2).sum() \
        .backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.QKV_KERNELS, 1)}
    ref = x.cpu().clone().requires_grad_(True)
    (fa.flash_attention_qkv(ref, scale=SCALE, num_heads=2) ** 2).sum() \
        .backward()
    np.testing.assert_allclose(qkv.grad.cpu().numpy(), ref.grad.numpy(),
                               atol=5e-4, rtol=0)


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        fa.qkv_attn_fwd(torch.zeros(1, 8, 3 * 2 * 32, device=cuda), 1.0, 2)
    with pytest.raises(ValueError, match="dtype"):
        fa.qkv_attn_fwd(torch.zeros(1, 8, 3 * D, device=cuda,
                                    dtype=torch.float16), 1.0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.qkv_attn_fwd(torch.zeros(1, 3 * D, 8, device=cuda).transpose(1, 2),
                        1.0, 1)


def test_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step of a small 64-dim-head model: loss and gradient norm on
    the card (kernels) against the CPU (plain versions). attn_impl="pallas"
    keeps the kernels at its 4 and 8 tokens: K1/K2 in the encoder (A = 128)
    and K4 in the decoder (A = 64)."""
    geo = dict(img_size=32, num_frames=4, encoder_embed_dim=128,
               encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=64,
               decoder_depth=1, decoder_num_heads=1,
               decoder_num_classes=1536, attn_impl="pallas")
    cfg = PretrainConfig(input_size=32, num_frames=4, batch_size=2,
                         dtype="float32", motion_loss_weight=True,
                         masking=MaskingConfig(mask_type="tube_bb",
                                               mask_ratio=0.5))
    gen = torch.Generator().manual_seed(3)
    clip = torch.randn(2, 4, 32, 32, 3, generator=gen)
    xy1 = torch.rand(2, 4, 2, generator=gen) * 12
    boxes = torch.cat([xy1, xy1 + 12], dim=-1)
    mask = masking.motion_tube_mask(boxes, temporal_positions=2,
                                    patches_per_side=2, mask_ratio=0.5,
                                    generator=gen)
    lr = np.full(2, 1e-3, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = create_model("pretrain_videomae_base_patch16_224",
                             device=dev, **geo)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {"clip": clip.to(dev), "boxes": boxes.to(dev)}, None,
                    0.5, mask=mask.to(dev))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert min(fa.launch_counts[k]
               for k in fa.QKV_KERNELS + fa.HM_KERNELS) >= 1
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D", [(10, 1568, 3, 256), (10, 1568, 12, 64),
                                     (4, 100, 1, 256), (4, 100, 2, 64)])
def test_mh_kernels_match_plain(cuda, dtype, B, N, H, D, bias):
    """K3 at chip_smoke.py's geometries (the MCA is 3 x 256): within the
    bounds, masked kv rows with zero dK/dV, planted faults rejected."""
    q, k, v, b = mh_inputs(B, N, H, D, dtype, 0, cuda, bias)
    got, want = mh_attention_against_plain(q, k, v, b, H, D ** -0.5)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    assert masked_kv_grad(got, b) == 0.0
    ignored = None
    if bias:
        ignored, _ = mh_attention_against_plain(q, k, v, None, H, D ** -0.5)
    for fault, outputs in planted_faults(got, ignored).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_mh_autograd_runs_the_kernels(cuda):
    q, k, v, b = mh_inputs(2, 100, 1, 256, torch.float32, 1, cuda)
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention_mh(*ts, scale=0.0625, num_heads=1, kv_bias=b)
     ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.MH_KERNELS, 1)}
    refs = [t.detach().cpu().clone().requires_grad_(True) for t in (q, k, v)]
    (fa.flash_attention_mh(*refs, scale=0.0625, num_heads=1,
                           kv_bias=b.cpu()) ** 2).sum().backward()
    for t, r in zip(ts, refs):
        np.testing.assert_allclose(t.grad.cpu().numpy(), r.grad.numpy(),
                                   atol=5e-4, rtol=0)


def test_mh_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.mh_attn_fwd(x, x, x, None, 1.0, 1)
    with pytest.raises(ValueError, match="dtype"):
        h = x.half()
        fa.mh_attn_fwd(h, h, h, None, 1.0, 2)
    with pytest.raises(ValueError, match="kv_bias"):
        fa.mh_attn_fwd(x, x, x, torch.zeros(1, 8, device=cuda,
                                            dtype=torch.bfloat16), 1.0, 2)
    with pytest.raises(ValueError, match="packed"):
        t = torch.zeros(8, 1, 128, device=cuda).transpose(0, 1)
        fa.mh_attn_fwd(x, t, x, None, 1.0, 2)


def test_bb_finetune_step_on_the_card_matches_the_cpu(cuda):
    """One f32 BB-focused MCA step of a small model (MCA 1 x 256): loss
    and gradient norm on the card (kernels) against the CPU. 128 tokens
    (16 frames at 64^2) keep the backbone on the flat K1/K2 route."""
    cfg = FinetuneConfig(batch_size=2, input_size=64, num_frames=16,
                         dtype="float32", drop_path=0.0, mixup=0.0,
                         cutmix=0.0)
    batch = synthetic_finetune_batch(2, torch.Generator().manual_seed(2),
                                     "cpu")
    batch = {"clip": batch["clip"][:, :, :64, :64],
             "boxes": batch["boxes"] / 3.5, "label": batch["label"]}
    lr = np.full(2, 1e-4, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = finetune_model(cfg, device=dev, depth=2, embed_dim=256,
                               num_heads=4, mca_num_heads=1)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr, layer_decay=0.75)
        step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                                  device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {k: v.to(dev) for k, v in batch.items()}, None)
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
        if dev == "cuda":
            assert min(fa.launch_counts[k]
                       for k in fa.QKV_KERNELS + fa.MH_KERNELS) >= 1
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N", [(32, 3, 1568), (2, 6, 1568), (4, 3, 100),
                                   (2, 6, 3136)])
def test_hm_kernels_match_plain(cuda, dtype, B, H, N):
    """K4 at chip_smoke.py's geometries (the ViT-S runner's decoder is
    B=32, H=3): within the bounds, planted faults rejected."""
    q, k, v = hm_inputs(B * H, N, dtype, 0, cuda)
    got, want = hm_attention_against_plain(q, k, v, SCALE)
    torch.cuda.synchronize()
    check_against_plain(got, want)
    for fault, outputs in hm_planted_faults(got).items():
        assert compare_with_plain(outputs, want)["beyond_bounds"], fault


def test_hm_autograd_runs_the_kernels(cuda):
    q, k, v = hm_inputs(6, 100, torch.float32, 1, cuda)
    ts = [t.reshape(2, 3, 100, D).clone().requires_grad_(True)
          for t in (q, k, v)]
    fa.reset_launch_counts()
    (fa.flash_attention(*ts, scale=SCALE) ** 2).sum().backward()
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_KERNELS, 1)}
    refs = [t.detach().cpu().clone().requires_grad_(True) for t in ts]
    (fa.flash_attention(*refs, scale=SCALE) ** 2).sum().backward()
    for t, r in zip(ts, refs):
        np.testing.assert_allclose(t.grad.cpu().numpy(), r.grad.numpy(),
                                   atol=5e-4, rtol=0)


def test_hm_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.hm_attn_fwd(x, x, x, 1.0)
    h = torch.zeros(2, 8, D, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.hm_attn_fwd(h, h, h, 1.0)
    x = torch.zeros(2, 8, D, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(8, 2, D, device=cuda).transpose(0, 1)
        fa.hm_attn_fwd(x, t, x, 1.0)


def test_vits_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step at ViT-S widths (384 / 6 heads, 192 / 3 heads), 2+1
    blocks, 8 frames at 112^2: the decoder runs K4 on 196 tokens."""
    geo = dict(img_size=112, num_frames=8, encoder_depth=2, decoder_depth=1)
    cfg = PretrainConfig(input_size=112, num_frames=8, batch_size=2,
                         dtype="float32", motion_loss_weight=True,
                         masking=MaskingConfig(mask_type="tube_bb"))
    gen = torch.Generator().manual_seed(4)
    clip = torch.randn(2, 8, 112, 112, 3, generator=gen)
    xy1 = torch.rand(2, 8, 2, generator=gen) * 50
    boxes = torch.cat([xy1, xy1 + 40], dim=-1)
    mask = masking.motion_tube_mask(boxes, temporal_positions=4,
                                    patches_per_side=7, generator=gen)
    lr = np.full(2, 1e-3, np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = create_model(VITS_MODEL, device=dev, **geo)
        named = dict(model.named_parameters())
        tx = optim.create_optimizer(named, lr_schedule=lr)
        step = make_pretrain_step(model, tx, cfg, lr, device=dev)
        fa.reset_launch_counts()
        _, m = step(TrainState.create(model, tx),
                    {"clip": clip.to(dev), "boxes": boxes.to(dev)}, None,
                    0.5, mask=mask.to(dev))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert fa.launch_counts == {**dict.fromkeys(fa.KERNELS, 0),
                                **dict.fromkeys(fa.HM_KERNELS, 1)}
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


def test_runner_saves_and_resumes_on_the_card(cuda, tmp_path):
    """The pretrain runner on the card, 2 epochs at once and 1 + 1 resumed
    from checkpoint-0: the same steps, checkpoints and losses."""
    argv = ["--model", VITS_MODEL, "--decoder_depth", "1", "--synthetic",
            "4", "--batch_size", "2", "--input_size", "112", "--num_frames",
            "8", "--epochs", "2", "--warmup_epochs", "0", "--save_ckpt_freq",
            "1", "--decode_height", "128", "--decode_width", "160",
            "--dtype", "float32"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    run = lambda out: pretrain_mofo.main(pretrain_mofo.get_args(  # noqa
        argv + ["--output_dir", str(out)], mofo_defaults=True))
    fa.reset_launch_counts()
    assert run(whole).step == 4
    assert fa.launch_counts["hm_attn_fwd"] == 4  # 1 decoder Block, 4 steps
    cut.mkdir()
    (cut / "checkpoint-0.pth").write_bytes(
        (whole / "checkpoint-0.pth").read_bytes())
    state = run(cut)
    assert state.step == 4 and state.opt_state.count == 4
    assert sorted(p.name for p in cut.glob("*.pth")) == [
        "checkpoint-0.pth", "checkpoint-1.pth"]
    logs = [[json.loads(line) for line in (d / "log.txt").read_text()
             .splitlines()] for d in (whole, cut)]
    assert [x["epoch"] for x in logs[1]] == [1]
    np.testing.assert_allclose(logs[1][0]["train_loss"],
                               logs[0][1]["train_loss"], rtol=1e-4)
