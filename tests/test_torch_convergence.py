"""The port's convergence A/B tools against mofo_tpu's.

- Both tools' synthetic streams are bit-equal to a transcription of
  tools/convergence_ab.py:103-116 and tools/convergence_ab_finetune.py:
  104-113.
- Three steps of each tool's arm loop (`run_curve`) at
  pretrain_videomae_tiny_debug (decoder depth 1) and vit_tiny_debug (32
  px, 4 frames), f32,
  attn_impl "xla", on the CPU, lie within STEP_RTOL of mofo_tpu's arm loop
  (the JAX tools' run_curve with the model, the geometry and B as
  arguments) from the same init (PRNGKey(1), carried across with
  params_from_jax): the JAX step's tube_bb masks (fold_in(PRNGKey(2),
  step), split(., 3)[0]) and mixup draws (the same key path, then
  split(., 2)) injected. Drop path is 0 in both: mofo_tpu's tool builds its
  model without cfg.drop_path, and JAX and torch draw different bits.
- chip_smoke.py's planted fault, the production arm's learning rate
  doubled (main_path.doubled_lr), moves a 50-step tiny curve past the max
  rel diff gate.
- gate_failures (mofo_tpu's gates, tests/test_tpu_kernels.py:338-409)
  passes the three TPU goldens and rejects four planted curves: the
  production arm offset by 3%, a flat arm, an improvement 10% off, an fp16
  arm 3% off.
- The card's recorded runs (tests/golden/torch_*_h100.json) pass the gates,
  the 500-step one and the finetune one too, and name the card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from mofo_tpu.core.config import MaskingConfig as JaxMaskingConfig
from mofo_tpu.core.config import PretrainConfig as JaxPretrainConfig
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import mixup as jax_mixup
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train import schedules as jax_schedules
from mofo_tpu.train.finetune_step import (
    make_finetune_step as jax_finetune_step,
)
from mofo_tpu.train.pretrain_step import generate_mask as jax_generate_mask
from mofo_tpu.train.pretrain_step import (
    make_pretrain_step as jax_pretrain_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.ops.mixup import MixupParams
from mofo_tpu_torch.tools import convergence_ab as CA
from mofo_tpu_torch.tools import convergence_ab_finetune as CF
from mofo_tpu_torch.tools.main_path import doubled_lr
from mofo_tpu_torch.train.checkpoint import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
STEP_RTOL = 1e-5
STEPS = 3
TINY = dict(size=32, frames=4)


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


# ----- the JAX tools' streams, transcribed --------------------------------


def _jax_pretrain_stream(steps, B, pool=None):
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(224), np.arange(224), indexing="ij")
    base = ((yy + xx) / 448.0).astype(np.float32)[None, None, :, :, None]
    pool = pool or min(steps, 32)
    clips = []
    for s in range(pool):
        noise = rng.randn(B, 16, 224, 224, 3).astype(np.float32) * 0.3
        shift = (np.arange(16) / 16.0).astype(np.float32)[
            None, :, None, None, None]
        clips.append(base + shift + noise)
    xy1 = rng.uniform(0, 96, (B, 16, 2)).astype(np.float32)
    wh = rng.uniform(48, 128, (B, 16, 2)).astype(np.float32)
    return clips, np.concatenate([xy1, xy1 + wh], axis=-1)


def _jax_finetune_stream(steps, B):
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.arange(224), np.arange(224), indexing="ij")
    base = ((yy + xx) / 448.0).astype(np.float32)[None, None, :, :, None]
    labels_np = rng.randint(0, 174, (B,)).astype(np.int32)
    shift = (labels_np / 174.0).astype(np.float32)[
        :, None, None, None, None]
    clips = []
    for s in range(steps):
        noise = rng.randn(B, 16, 224, 224, 3).astype(np.float32) * 0.3
        clips.append(base + shift + noise)
    return clips, labels_np


@pytest.mark.parametrize("steps,B,pool", [(2, 1, None), (40, 1, 1)])
def test_pretrain_stream_is_the_jax_tools(steps, B, pool):
    got = CA.synthetic_stream(steps, B, pool)
    want = _jax_pretrain_stream(steps, B, pool)
    assert len(got[0]) == len(want[0]) == (pool or min(steps, 32))
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])


def test_finetune_stream_is_the_jax_tools():
    clips, labels = CF.synthetic_stream(2, 2)
    want_clips, want_labels = _jax_finetune_stream(2, 2)
    np.testing.assert_array_equal(labels, want_labels)
    assert labels.dtype == np.int32
    for a, b in zip(clips, want_clips):
        np.testing.assert_array_equal(a, b)


# ----- the arm loops against mofo_tpu's -----------------------------------


def _pretrain_jax_arm(steps, clips, boxes):
    """tools/convergence_ab.py's run_curve at the tiny model and geometry,
    f32 and attn_impl "xla"; returns the init, the losses and the masks
    its step drew."""
    B = clips[0].shape[0]
    cfg = JaxPretrainConfig(batch_size=B, dtype="float32", input_size=32,
                            num_frames=4,
                            masking=JaxMaskingConfig(mask_type="tube_bb"),
                            motion_loss_weight=True)
    model = jax_create_model("pretrain_videomae_tiny_debug", img_size=32,
                             num_frames=4, decoder_depth=1,
                             dtype=jnp.float32, attn_impl="xla")
    vis0 = jnp.zeros((B, cfg.num_tokens - cfg.num_masked), jnp.int32)
    msk0 = jnp.zeros((B, cfg.num_masked), jnp.int32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(clips[0]), vis0,
                        msk0)["params"]
    init = jax.tree.map(np.asarray, params)
    lr = jax_schedules.cosine_schedule(1.5e-4, 0.0, 1, steps, 0)
    tx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                    betas=(0.9, 0.95), weight_decay=0.05)
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_pretrain_step(model, tx, cfg, lr))
    mask_fn = jax.jit(lambda key, batch: jax_generate_mask(key, batch, cfg))
    rng = jax.random.PRNGKey(2)
    losses, masks = [], []
    for s in range(steps):
        batch = {"clip": jnp.asarray(clips[s % len(clips)]),
                 "boxes": jnp.asarray(boxes)}
        key = jax.random.split(jax.random.fold_in(rng, s), 3)[0]
        masks.append(np.array(mask_fn(key, batch)))
        state, metrics = step(state, batch, rng, 0.5)
        losses.append(float(metrics["loss"]))
    return init, losses, masks


def test_pretrain_arm_loop_matches_mofo_tpu():
    clips, boxes = CA.synthetic_stream(STEPS, 2, **TINY)
    init, want, masks = _pretrain_jax_arm(STEPS, clips, boxes)
    got = CA.run_curve(
        "float32", "xla", STEPS, clips, boxes,
        model="pretrain_videomae_tiny_debug", device="cpu",
        model_kw=dict(img_size=32, num_frames=4, decoder_depth=1),
        cfg_kw=dict(input_size=32, num_frames=4),
        params=params_from_jax(init),
        masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(got["losses"], want, rtol=STEP_RTOL)
    assert want[-1] != want[0]


def _finetune_jax_arm(steps, clips, labels, nc):
    """tools/convergence_ab_finetune.py's run_curve at the tiny model and
    geometry, f32 and attn_impl "xla"; returns the init, the losses and
    the mixup draws its step made."""
    B = clips[0].shape[0]
    cfg = JaxFinetuneConfig(batch_size=B, nb_classes=nc, dtype="float32",
                            input_size=32, num_frames=4)
    model = jax_create_model("vit_tiny_debug", num_classes=nc, img_size=32,
                             all_frames=4, dtype=jnp.float32,
                             attn_impl="xla")
    params = model.init(jax.random.PRNGKey(1),
                        jnp.asarray(clips[0]))["params"]
    init = jax.tree.map(np.asarray, params)
    lr = jax_schedules.cosine_schedule(5e-4, 1e-6, 1, steps, 0)
    tx = jax_optim.create_optimizer(params, lr_schedule=lr,
                                    betas=(0.9, 0.999), weight_decay=0.05,
                                    layer_decay=0.75)
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_finetune_step(model, tx, cfg))
    jm = jax_mixup.Mixup(
        mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
        cutmix_minmax=cfg.cutmix_minmax, prob=cfg.mixup_prob,
        switch_prob=cfg.mixup_switch_prob, mode=cfg.mixup_mode,
        label_smoothing=cfg.smoothing, num_classes=nc)
    rng = jax.random.PRNGKey(2)
    losses, draws = [], []
    for s in range(steps):
        key = jax.random.split(jax.random.fold_in(rng, s), 3)[0]
        r_params, r_box = jax.random.split(key)
        lam, use_cutmix = jm._sample_params(r_params, 1)
        box = jax_mixup._rand_bbox(r_box, 32, 32, lam, 1)
        draws.append(MixupParams(np.asarray(lam), np.asarray(use_cutmix),
                                 tuple(np.asarray(c) for c in box)))
        state, metrics = step(state, {"clip": jnp.asarray(clips[s]),
                                      "label": jnp.asarray(labels)}, rng)
        losses.append(float(metrics["loss"]))
    return init, losses, draws


def test_finetune_arm_loop_matches_mofo_tpu():
    nc = 5
    clips, labels = CF.synthetic_stream(STEPS, 4, num_classes=nc, **TINY)
    init, want, draws = _finetune_jax_arm(STEPS, clips, labels, nc)
    got = CF.run_curve(
        "float32", "xla", STEPS, clips, labels, model="vit_tiny_debug",
        num_classes=nc, device="cpu",
        model_kw=dict(img_size=32, all_frames=4),
        cfg_kw=dict(input_size=32, num_frames=4, drop_path=0.0),
        params=params_from_jax(init), mixup_params=draws)
    np.testing.assert_allclose(got["losses"], want, rtol=STEP_RTOL)
    assert want[-1] != want[0]


def test_planted_lr_fault_moves_a_tiny_curve_past_the_bound():
    """chip_smoke.py's planted fault (main_path.doubled_lr in the
    production arm) must fail the max rel diff gate on a tiny curve."""
    clips, boxes = CA.synthetic_stream(50, 2, **TINY)
    kw = dict(model="pretrain_videomae_tiny_debug", device="cpu",
              model_kw=dict(img_size=32, num_frames=4, decoder_depth=1),
              cfg_kw=dict(input_size=32, num_frames=4))
    ref = CA.run_curve("float32", "xla", 50, clips, boxes, **kw)["losses"]
    with doubled_lr():
        bad = CA.run_curve("float32", "xla", 50, clips, boxes,
                           **kw)["losses"]
    failures = CA.gate_failures({"prod_losses": bad, "ref_losses": ref})
    assert any("max rel diff" in f for f in failures), failures


# ----- the gates ----------------------------------------------------------


@pytest.mark.parametrize("name", ["convergence_ab_v5e.json",
                                  "convergence_ab_500_v5e.json",
                                  "convergence_ft_v5e.json"])
def test_gates_accept_the_tpu_goldens(name):
    art = _golden(name)
    assert CA.gate_failures(art) == []
    np.testing.assert_allclose(
        CA.rel_curve(art["prod_losses"], art["ref_losses"]),
        art["max_rel_diff"], rtol=1e-6)


def _planted(kind):
    art = dict(_golden("convergence_ft_v5e.json"))
    ref = np.asarray(art["ref_losses"])
    if kind == "offset_3pct":
        art["prod_losses"] = list(ref * 1.03)
    elif kind == "flat":
        art["prod_losses"] = [float(ref[0])] * len(ref)
    elif kind == "improvement_10pct_off":
        art["prod_losses"] = list(ref[0] - 0.9 * (ref[0] - ref))
    elif kind == "fp16_3pct":
        art["fp16_losses"] = list(ref * 1.03)
    return art


@pytest.mark.parametrize("kind", ["offset_3pct", "flat",
                                  "improvement_10pct_off", "fp16_3pct"])
def test_gates_reject_planted_curves(kind):
    failures = CA.gate_failures(_planted(kind))
    gate = {"offset_3pct": "max rel diff", "flat": "did not train",
            "improvement_10pct_off": "improvements",
            "fp16_3pct": "fp16 max rel diff"}[kind]
    assert any(gate in f for f in failures), failures


# ----- the card's recorded runs -------------------------------------------


@pytest.mark.parametrize("name,steps", [
    ("torch_convergence_ab_h100.json", 50),
    ("torch_convergence_ab_500_h100.json", 500),
    ("torch_convergence_ft_h100.json", 50),
])
def test_recorded_card_runs_pass_the_gates(name, steps):
    art = _golden(name)
    assert art["steps"] == steps and art["batch"] == 16
    assert "H100" in art["device"] and " W" in art["device"]
    assert CA.gate_failures(art) == []
    assert len(art["prod_losses"]) == len(art["ref_losses"]) == steps
    if name.startswith("torch_convergence_ft"):
        assert len(art["fp16_losses"]) == steps
        assert art["fp16_max_rel_diff"] < CA.MAX_REL_DIFF


def test_recorded_overfit_run_reached_100():
    art = _golden("torch_overfit_real_h100.json")
    assert "H100" in art["device"] and " W" in art["device"]
    assert art["best_val_acc1"] >= 100.0
    assert (art["model"], art["dtype"], art["aa"], art["reprob"],
            art["epochs"], art["batch"], art["mixup"], art["cutmix"]) == (
        "vit_base_patch16_224", "bfloat16", "rand-m7-n1-mstd0.5-inc1",
        0.0, 60, 8, 0.0, 0.0)
    assert art["lr"] == pytest.approx(1e-3, rel=1e-12)
    assert len(art["val_acc1"]) == art["epochs_run"] == 60
    assert art["first_epoch_at_100"] is not None
