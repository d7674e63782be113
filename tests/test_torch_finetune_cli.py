"""The port's finetune runner against the JAX package: the dynamic loss
scale, the fp16 attention boundary and fp16 steps, the multi-view
aggregator and EK-100 marginalization, the loggers' weighted meters, the
optimizer's `trainable` mask, the named and pretrain checkpoints, and the
finetune CLIs end to end on the CPU (--device cpu), the counterpart of
tests/test_cli.py:79-111.

fp16 steps: the JAX step runs its interpret-mode kernels on bf16 operands
behind its fp16 boundary, the port its plain versions behind its own, and
the two packages' fp16 matmuls round differently, so the bounds are loss
and gradient norm within rel 1e-3, and at least 99% of the parameters
within 1e-6 of JAX's (all within 4 lr): about 1% of the entries have
gradients so small that AdamW's first update, g / (|g| + eps), turns the
fp16 roundings into up to lr.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.cli import finetune as jax_cli
from mofo_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from mofo_tpu.data import filelist as jax_filelist
from mofo_tpu.eval import multiview as jax_mv
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.train import loss_scale as jax_ls
from mofo_tpu.train import metrics as jax_metrics
from mofo_tpu.parallel import mesh as jax_mesh
from mofo_tpu.train import optim as jax_optim
from mofo_tpu.train.checkpoint import (
    import_torch_finetune,
    load_torch_checkpoint,
)
from mofo_tpu.train.finetune_step import (
    make_finetune_step as jax_finetune_step,
)
from mofo_tpu.train.train_state import TrainState as JaxTrainState
from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.cli import finetune_mofo
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.core.config import FinetuneConfig
from mofo_tpu_torch.data import pipeline
from mofo_tpu_torch.eval import multiview as mv
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import metrics as M
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.checkpoint import params_from_jax
from mofo_tpu_torch.train.finetune_step import make_finetune_step
from mofo_tpu_torch.train.loss_scale import DynamicLossScale, apply_if_finite
from mofo_tpu_torch.train.train_state import TrainState


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


BB = "vit_base_patch16_224_BB_focused"
NC = 7
GEO = dict(img_size=32, all_frames=4, embed_dim=128, depth=2, num_heads=2,
           num_classes=NC, init_scale=1.0, fusing_method="MCA",
           mca_num_heads=2)
TINY = ["--synthetic", "4", "--batch_size", "2", "--input_size", "32",
        "--num_frames", "4", "--nb_classes", "3", "--epochs", "1",
        "--warmup_epochs", "0", "--save_ckpt_freq", "1", "--decode_height",
        "48", "--decode_width", "64", "--aa", "rand-m7-n1-mstd0.5-inc1",
        "--dtype", "float32", "--drop_path", "0.0", "--device", "cpu"]
TINY_FINETUNE = ["--model", "vit_tiny_debug"] + TINY
TINY_MOFO = ["--model", "vit_tiny_debug_BB_focused"] + TINY


# --- the loss scale ------------------------------------------------------


def test_dynamic_loss_scale_matches_jax():
    """Scale and good-step count over a scripted pattern: growth after 128
    good steps (twice), backoffs down to the floor of 1."""
    pattern = ([True] * 130 + [False] + [True] * 127 + [True] * 3
               + [False] * 12 + [True] * 5)
    ours = DynamicLossScale.create()
    ref = jax_ls.DynamicLossScale.create()
    seen = set()
    for finite in pattern:
        ours = ours.update(finite)
        ref = ref.update(jnp.asarray(finite))
        assert ours.scale == float(ref.scale)
        assert ours.good_steps == int(ref.good_steps)
        seen.add(ours.scale)
    assert {256.0, 1.0, 128.0} <= seen and ours.scale == 1.0


def test_apply_if_finite_matches_jax():
    new = {"a": torch.ones(3), "b": torch.full((2, 2), 5.0)}
    old = {"a": torch.zeros(3), "b": torch.full((2, 2), -1.0)}
    for finite in (True, False, torch.tensor(False)):
        got = apply_if_finite(new, old, finite)
        want = jax_ls.apply_if_finite(
            {k: jnp.asarray(v.numpy()) for k, v in new.items()},
            {k: jnp.asarray(v.numpy()) for k, v in old.items()},
            jnp.asarray(bool(finite)))
        for k in new:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --- the aggregator, marginalization and meters --------------------------


def _views(seed=0):
    rng = np.random.RandomState(seed)
    rows = [(v, c, s) for v in range(5) for c in range(2) for s in range(3)]
    rows.append((2, 1, 0))  # a duplicated view: dropped before averaging
    logits = rng.randn(len(rows), 8) * 3
    labels = [v % 8 for v, _, _ in rows]
    return rows, logits, labels


def test_multiview_aggregator_matches_jax():
    rows, logits, labels = _views()
    ours, ref = mv.MultiViewAggregator(), jax_mv.MultiViewAggregator()
    for lo, hi in ((0, 7), (7, len(rows))):  # two eval batches
        part = rows[lo:hi]
        for agg in (ours, ref):
            agg.add([r[0] for r in part], [r[1] for r in part],
                    [r[2] for r in part], logits[lo:hi], labels[lo:hi])
    logits[-1] += 100.0  # the duplicate would decide video 2 if kept
    f_ours, l_ours = ours.merge_feats()
    f_ref, l_ref = ref.merge_feats()
    assert f_ours.keys() == f_ref.keys() and l_ours == l_ref
    for v in f_ours:
        np.testing.assert_array_equal(f_ours[v], f_ref[v])
    assert ours.finalize() == ref.finalize()
    np.testing.assert_array_equal(mv.softmax_np(logits),
                                  jax_mv.softmax_np(logits))
    assert mv.gather_across_processes(ours) is ours


def test_gather_across_processes_refuses_more_than_one(monkeypatch):
    """More than one process without a process group to gather over
    raises; the gather itself is held in tests/test_torch_ddp.py."""
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="process group"):
        mv.gather_across_processes(mv.MultiViewAggregator())


def test_marginalization_and_label_space_match_jax():
    pairs = [(0, 1), (2, 1), (10, 0), (2, 3), (0, 0), (1, 3)]
    assert mv.action_label_space(pairs) == jax_mv.action_label_space(pairs)
    _, mapping = mv.action_label_space(pairs)
    action_to_vn = sorted(((int(k.split(":")[0]), int(k.split(":")[1])), i)
                          for k, i in mapping.items())
    action_to_vn = [vn for vn, _ in sorted(action_to_vn, key=lambda t: t[1])]
    probs = mv.softmax_np(np.random.RandomState(1).randn(4, len(pairs)))
    for mode in ("verb", "noun"):
        ours = mv.get_marginal_indexes(action_to_vn, mode)
        ref = jax_mv.get_marginal_indexes(action_to_vn, mode)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mv.marginalize(probs, ours),
                                      jax_mv.marginalize(probs, ref))


def test_weighted_meters_match_jax():
    ours = M.MetricLogger(print_fn=lambda *a: None)
    ref = jax_metrics.MetricLogger(print_fn=lambda *a: None)
    for n, loss in ((10, 2.0), (3, 5.0), (0, 1.0)):  # 0: counted as 1
        ours.update_weighted(n, loss=loss, acc1=torch.tensor(loss * 10))
        ref.update_weighted(n, loss=loss, acc1=jnp.float32(loss * 10))
    assert ours.epoch_stats(sync=True) == ref.epoch_stats(sync=True)
    assert ours.epoch_stats()["loss"] == pytest.approx(36.0 / 14)


# --- the optimizer's trainable mask and the checkpoints ------------------


def _jax_pair(dtype=jnp.float32):
    jmodel = jax_create_model(BB, attn_impl="pallas", dtype=dtype, **GEO)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)),
                         jnp.zeros((1, 4, 4)))["params"]
    port = create_model(BB, device="cpu",
                        dtype=torch.float16 if dtype == jnp.float16
                        else torch.float32, **GEO)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, port


def test_only_finetune_last_matches_jax_and_freezes_the_backbone():
    """The CLI's head_only mask against the JAX CLI's (trainable(path,
    leaf), finetune.py:388-397) through two AdamW updates with clipping:
    frozen parameters get no moments and stay bit-equal."""
    _, params, model = _jax_pair()
    named = dict(model.named_parameters())
    head = {"head", "fc_norm", "soft_att_local", "soft_att_global"}

    def jax_trainable(path, leaf):
        names = jax_optim.path_names(path)
        return any(n in head or n.startswith(("local_MCA", "global_MCA"))
                   for n in names)

    lr = np.array([1e-3, 1e-3], np.float32)
    kw = dict(lr_schedule=lr, layer_decay=0.75, clip_grad=0.5)
    jtx = jax_optim.create_optimizer(params, trainable=jax_trainable, **kw)
    tx = optim.create_optimizer(named, trainable=FT.head_only, **kw)
    before = {n: p.detach().clone() for n, p in named.items()}
    rng = np.random.RandomState(0)
    jgrads = jax.tree.map(
        lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
    grads = params_from_jax(jgrads)
    jgrads = jax.tree.map(jnp.asarray, jgrads)
    state, jstate, jparams = tx.init(named), jtx.init(params), params
    for _ in range(2):
        tx.update(grads, state, named)
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
    ref = params_from_jax(jax.tree.map(np.asarray, jparams))
    trained = {n for n in named if FT.head_only(n, named[n])}
    assert set(state.mu) == trained and trained
    assert any(n.startswith("local_MCA") for n in trained)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
        assert torch.equal(p.detach(), before[n]) == (n not in trained), n
    with pytest.raises(ValueError, match="no parameters"):
        optim.create_optimizer(named, lr_schedule=lr,
                               trainable=lambda n, p: False)


def test_named_checkpoint_and_trained_subset_round_trip(tmp_path):
    model = create_model(BB, device="cpu", **GEO)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=np.ones(2, np.float32),
                                trainable=FT.head_only)
    state = TrainState.create(model, tx, loss_scale=DynamicLossScale(
        scale=32.0, good_steps=5))
    g = torch.Generator().manual_seed(1)
    tx.update({n: torch.randn(p.shape, generator=g)
               for n, p in named.items()}, state.opt_state, named)
    state.step = 1
    path = ckpt.save_checkpoint(str(tmp_path), model, state, 3,
                                name="checkpoint-best")
    assert path.endswith("checkpoint-best.pth")
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    saved = torch.load(path, weights_only=True)
    assert len(saved["optimizer"]["state"]) == len(state.opt_state.mu)
    fresh = create_model(BB, device="cpu", seed=9, **GEO)
    tx2 = optim.create_optimizer(dict(fresh.named_parameters()),
                                 lr_schedule=np.ones(2, np.float32),
                                 trainable=FT.head_only)
    restored = TrainState.create(fresh, tx2,
                                 loss_scale=DynamicLossScale.create())
    assert ckpt.load_checkpoint(path, fresh, restored) == 3
    assert restored.opt_state.count == 1 and restored.step == 1
    assert restored.loss_scale == DynamicLossScale(scale=32.0, good_steps=5)
    for n, t in state.opt_state.mu.items():
        assert torch.equal(restored.opt_state.mu[n], t)
    whole = TrainState.create(fresh, optim.create_optimizer(
        dict(fresh.named_parameters()), lr_schedule=np.ones(2, np.float32)))
    with pytest.raises(ValueError, match="moments of other parameters"):
        ckpt.load_checkpoint(path, fresh, whole)


def test_load_pretrain_encoder_reads_pth_and_refuses_orbax(tmp_path):
    pre = create_model("pretrain_videomae_tiny_debug", device="cpu", seed=4)
    torch.save({"model": pre.state_dict()}, tmp_path / "pre.pth")
    sd = ckpt.load_pretrain_encoder(str(tmp_path / "pre.pth"))
    model = create_model("vit_tiny_debug", device="cpu", img_size=224)
    copied = ckpt.finetune_init_from_pretrain(model, sd)
    assert "blocks.1.attn.qkv.weight" in copied
    assert torch.equal(model.blocks[1].attn.qkv.weight,
                       pre.encoder.blocks[1].attn.qkv.weight)
    (tmp_path / "checkpoint-799").mkdir()
    with pytest.raises(ValueError, match="JAX package's format"):
        ckpt.load_pretrain_encoder(str(tmp_path / "checkpoint-799"))


# --- fp16 ----------------------------------------------------------------


@pytest.mark.parametrize("route", ["qkv", "mh", "hm"])
def test_fp16_boundary_runs_bf16_and_returns_f16(route):
    """Each public entry point casts f16 operands to bf16 and the output
    back, inside autograd: the same numbers as the bf16 call, f16 output
    and f16 gradients (mofo_tpu's _f16_boundary)."""
    g = torch.Generator().manual_seed(0)
    if route == "qkv":
        shapes, call = [(2, 20, 3 * 128)], lambda x: fa.flash_attention_qkv(
            x, scale=0.125, num_heads=2)
    elif route == "mh":
        shapes = [(2, 20, 128)] * 3
        bias = torch.where(torch.rand(2, 20, generator=g) < 0.5, 0.0, -1e30)
        bias[:, 0] = 0.0
        call = lambda q, k, v: fa.flash_attention_mh(  # noqa: E731
            q, k, v, scale=0.125, num_heads=2, kv_bias=bias)
    else:
        shapes = [(2, 3, 20, 64)] * 3
        call = lambda q, k, v: fa.flash_attention(q, k, v,  # noqa: E731
                                                  scale=0.125)
    xs = [torch.randn(s, generator=g).half() for s in shapes]
    weight = torch.linspace(-1, 1, xs[0].shape[-1] // (3 if route == "qkv"
                                                      else 1))
    runs = {}
    for dtype in (torch.float16, torch.bfloat16):
        ins = [x.to(dtype).clone().requires_grad_(True) for x in xs]
        out = call(*ins).to(torch.float16)  # a no-op for the f16 call
        (out.float() * weight).sum().backward()
        runs[dtype] = (out.detach(), [t.grad for t in ins])
    out16, grads16 = runs[torch.float16]
    out_bf, grads_bf = runs[torch.bfloat16]
    assert call(*xs).dtype == torch.float16
    assert all(t.dtype == torch.float16 for t in grads16)
    assert torch.equal(out16, out_bf)
    for a, b in zip(grads16, grads_bf):
        assert torch.equal(a, b.to(torch.float16))


def _fp16_batch():
    rng = np.random.RandomState(0)
    boxes = np.zeros((4, 4, 4), np.float32)
    boxes[0] = [3.0, 5.0, 14.0, 12.0]
    boxes[1] = [100.0, 100.0, 120.0, 120.0]  # no in-box token
    boxes[2] = [0.0, 0.0, 32.0, 32.0]  # no out-box token
    boxes[3] = [10.0, 2.0, 30.0, 20.0]
    return {"clip": rng.randn(4, 4, 32, 32, 3).astype(np.float32),
            "label": np.array([1, 5, 0, 3], np.int32), "boxes": boxes}


def test_two_fp16_steps_and_a_skip_match_jax():
    """Two BB-focused MCA AdamW steps in fp16 under the loss scale against
    mofo_tpu's fp16 step (bounds in the module docstring), then a step with
    one clip scaled to inf, which both skip: the scale halves to 64, the
    parameters, moments and count stay as they were, the step advances."""
    kw = dict(input_size=32, num_frames=4, batch_size=4, nb_classes=NC,
              dtype="float16", drop_path=0.0, mixup=0.0, cutmix=0.0)
    jcfg, cfg = JaxFinetuneConfig(**kw), FinetuneConfig(**kw)
    jmodel, params, model = _jax_pair(jnp.float16)
    lr = np.array([5e-5, 4e-5, 3e-5], np.float32)
    okw = dict(lr_schedule=lr, betas=(0.9, 0.999), weight_decay=0.05,
               layer_decay=0.75, eps=1e-6)
    jtx = jax_optim.create_optimizer(params, **okw)
    jstate = JaxTrainState.create(params, jtx,
                                  loss_scale=jax_ls.DynamicLossScale.create())
    jstep = jax.jit(jax_finetune_step(jmodel, jtx, jcfg, lr, bb_focused=True))
    tx = optim.create_optimizer(dict(model.named_parameters()), **okw)
    state = TrainState.create(model, tx, loss_scale=DynamicLossScale.create())
    step = make_finetune_step(model, tx, cfg, lr, bb_focused=True,
                              device="cpu")
    batch = _fp16_batch()
    key = jax.random.PRNGKey(3)
    for s in range(3):
        if s == 2:  # a non-finite gradient
            batch["clip"][0] = np.inf
            kept = {n: p.detach().clone() for n, p in state.params.items()}
            moments = {n: t.clone() for n, t in state.opt_state.nu.items()}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, key)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, None)
        assert float(m["loss_scale"]) == float(jm["loss_scale"]) == (
            128.0 if s < 2 else 64.0)
        assert float(m["skipped"]) == float(jm["skipped"]) == float(s == 2)
        if s == 2:
            break
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        diff = torch.cat([(p - ref[n]).abs().flatten()
                          for n, p in model.state_dict().items()])
        assert (diff <= 1e-6).float().mean() >= 0.99
        assert diff.max() <= 4 * lr[0]
    assert state.step == 3 and state.opt_state.count == 2
    for n, p in state.params.items():
        assert torch.equal(p.detach(), kept[n]), n
        assert torch.equal(state.opt_state.nu[n], moments[n]), n


# --- the CLI -------------------------------------------------------------


def _run(argv, out=None, mofo=False):
    cli = finetune_mofo if mofo else FT
    extra = ["--output_dir", str(out)] if out is not None else []
    return cli.main(cli.get_args(argv + extra, bb_defaults=mofo))


def _log(out):
    return [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]


class TestFinetuneCLI:
    def test_full_cycle(self, tmp_path, capsys):
        state = _run(TINY_FINETUNE, tmp_path)
        assert state.step == 2  # 4 clips / batch 2
        assert (tmp_path / "checkpoint-0.pth").is_file()
        assert (tmp_path / "checkpoint-best.pth").is_file()
        text = capsys.readouterr().out
        assert text.count("Final test: Acc@1") == 1
        (line,) = _log(tmp_path)
        assert line["epoch"] == 0 and line["step"] == 2
        assert np.isfinite(line["train_loss"]) and "val_acc1" in line
        assert set(line["save_s"]) == {"checkpoint-0.pth",
                                       "checkpoint-best.pth"}

    def test_bb_focused_fp16_with_ema_and_repeated_augmentation(
            self, tmp_path, capsys):
        state = _run(TINY_MOFO + ["--dtype", "float16", "--model_ema",
                                  "--num_sample", "2"], tmp_path, mofo=True)
        assert state.step == 2 and state.loss_scale.scale == 128.0
        (line,) = _log(tmp_path)
        assert line["train_loss_scale"] == 128.0
        assert line["train_skipped"] == 0.0
        assert {"val_acc1", "val_ema_acc1", "val_ema_loss"} <= set(line)
        assert "Final test: Acc@1" in capsys.readouterr().out

    def test_eval_only(self):
        stats = _run(TINY_FINETUNE + ["--eval"])
        assert {"acc1", "acc5", "loss"} <= set(stats)

    def test_finetune_from_the_port_pretrain_checkpoint(self, tmp_path,
                                                        capsys):
        PT.main(PT.get_args([
            "--model", "pretrain_videomae_tiny_debug", "--decoder_depth",
            "1", "--synthetic", "2", "--batch_size", "2", "--input_size",
            "32", "--num_frames", "4", "--epochs", "1", "--warmup_epochs",
            "0", "--decode_height", "48", "--decode_width", "64", "--dtype",
            "float32", "--device", "cpu", "--output_dir",
            str(tmp_path / "pt")]))
        pre = tmp_path / "pt" / "checkpoint-0.pth"
        state = _run(TINY_FINETUNE + ["--finetune", str(pre)],
                     tmp_path / "ft")
        assert state.step == 2
        assert "initialized the backbone from" in capsys.readouterr().out

    def test_auto_resume_skips_done_epochs(self, tmp_path):
        _run(TINY_FINETUNE, tmp_path)
        state = _run(TINY_FINETUNE, tmp_path)
        assert len(_log(tmp_path)) == 1
        assert state.step == 2


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """A run cut after epoch 0 and resumed from checkpoint-0 takes the
    uninterrupted run's steps (augmentation, mixup and drop path follow
    (seed, step)): the same losses, the same weights."""
    argv = TINY_MOFO + ["--epochs", "2", "--drop_path", "0.1"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    _run(argv, whole, mofo=True)
    cut.mkdir()
    shutil.copy(whole / "checkpoint-0.pth", cut)
    _run(argv, cut, mofo=True)
    a = torch.load(whole / "checkpoint-1.pth", weights_only=True)
    b = torch.load(cut / "checkpoint-1.pth", weights_only=True)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["step"] == b["step"] == 4
    log_a, log_b = _log(whole), _log(cut)
    assert [x["epoch"] for x in log_b] == [1]
    assert log_b[0]["train_loss"] == log_a[1]["train_loss"]


def test_only_finetune_last_leaves_the_backbone_bit_equal(tmp_path):
    _run(TINY_MOFO + ["--only_finetune_last"], tmp_path, mofo=True)
    saved = torch.load(tmp_path / "checkpoint-0.pth",
                       weights_only=True)["model"]
    fresh = create_model("vit_tiny_debug_BB_focused", device="cpu",
                         img_size=32, all_frames=4, num_classes=3,
                         init_scale=0.001, fusing_method="MCA").state_dict()
    moved = {k for k in fresh if not torch.equal(saved[k], fresh[k])}
    assert moved and all(FT.head_only(k, None) for k in moved)
    assert not any(k.startswith("backbone.") for k in moved)


def test_best_checkpoint_loads_into_jax(tmp_path):
    """checkpoint-best.pth through mofo_tpu's import_torch_finetune gives
    JAX's classifier the port's weights: the same logits."""
    _run(TINY_FINETUNE, tmp_path)
    path = str(tmp_path / "checkpoint-best.pth")
    params = import_torch_finetune(load_torch_checkpoint(path))
    jmodel = jax_create_model("vit_tiny_debug", img_size=32, all_frames=4,
                              num_classes=3)
    clip = np.random.RandomState(0).randn(2, 4, 32, 32, 3).astype(np.float32)
    assert jax.tree.structure(params) == jax.tree.structure(jax.tree.map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                jnp.asarray(clip))["params"]))
    model = create_model("vit_tiny_debug", device="cpu", img_size=32,
                         all_frames=4, num_classes=3)
    model.load_state_dict(torch.load(path, weights_only=True)["model"])
    with torch.no_grad():
        got = model(torch.from_numpy(clip)).numpy()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_get_args_and_build_config_match_jax():
    argv = ["--epochs", "3", "--lr", "1e-3", "--opt_betas", "0.9", "0.98",
            "--dtype", "float16"]
    for bb in (False, True):
        ours = vars(FT.get_args(argv, bb_defaults=bb))
        ref = vars(jax_cli.get_args(argv, bb_defaults=bb))
        assert ours.pop("device") == "cuda"
        assert ours == ref
    cfg = FT.build_config(FT.get_args(argv))
    jcfg = jax_cli.build_config(jax_cli.get_args(argv))
    for field in ("model", "epochs", "dtype", "aa", "reprob", "mixup",
                  "test_num_segment", "test_num_crop", "fusing_mode"):
        assert getattr(cfg, field) == getattr(jcfg, field)
    assert str(cfg.optimizer) == str(jcfg.optimizer)


@pytest.mark.parametrize("flags,error,match", [
    (["--opt", "shampoo"], ValueError, "Unknown optimizer: shampoo"),
    (["--mesh_fsdp", "2"], ValueError,
     r"1 devices not divisible by fsdp\*model=2"),
])
def test_unported_flags_raise(flags, error, match, tmp_path):
    """Every --opt of mofo_tpu's zoo runs (tests/test_torch_second_order.py
    and test_torch_optim_zoo.py): an unknown name fails in the runner as
    mofo_tpu's create_optimizer fails; a mesh that mofo_tpu's
    MeshConfig.resolve refuses at the world size (an fsdp axis of 2 in one
    process) raises ValueError with its condition."""
    if flags[0] == "--opt":
        with pytest.raises(error, match=match):
            jax_optim.create_optimizer({"w": jnp.ones((2,))},
                                       lr_schedule=np.ones(1), opt=flags[1])
    else:  # mofo_tpu refuses the mesh in the same words
        with pytest.raises(AssertionError, match=match):
            jax_mesh.MeshConfig(fsdp=2).resolve(1)
    with pytest.raises(error, match=match):
        FT.main(FT.get_args(TINY_FINETUNE + flags + ["--output_dir",
                                                str(tmp_path)]))


@pytest.mark.parametrize("flags", [
    ["--data_path", "train.csv"],
    ["--data_path", "train.csv", "--bb_json", "bb.json"],
    ["--data_set", "EK100"],
])
def test_data_flags_fail_as_mofo_tpu_fails(flags, tmp_path, monkeypatch):
    """--data_path, --bb_json and --data_set EK100 are no longer refused:
    without their files they fail where and as mofo_tpu's readers fail."""
    monkeypatch.chdir(tmp_path)
    args = FT.get_args(flags + ["--device", "cpu"])
    if args.data_set == "EK100":
        def ref():
            jax_filelist.epic_action_space([args.data_path, args.val_path])
    elif args.bb_json:
        def ref():
            jax_filelist.MotionBoxIndex.from_file(args.bb_json)
    else:
        def ref():
            jax_filelist.read_setting_file(args.data_path)
    with pytest.raises(Exception) as want:
        ref()
    with pytest.raises(want.type) as got:
        FT.build_datasets(args, FT.build_config(args), False, print)
    assert str(got.value) == str(want.value)


def test_synthetic_test_set_is_the_plain_clips():
    """--synthetic tests the clips themselves, one view each, as mofo_tpu
    does (data.pipeline's test-mode datasets expand real clips' views)."""
    args = FT.get_args(TINY_FINETUNE)
    _, _, test, _, _ = FT.build_datasets(args, FT.build_config(args), False,
                                         print)
    assert isinstance(test, pipeline.SyntheticClipDataset) and len(test) == 4
    assert {int(test[i]["split_nb"]) for i in range(4)} == {0}
