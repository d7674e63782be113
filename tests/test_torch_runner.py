"""The port's pretrain runner: distributed helpers, loggers, checkpoints and
the CLI, against the JAX package where it has a counterpart.

A checkpoint the port writes loads into mofo_tpu through
load_torch_checkpoint + import_torch_pretrain and gives the same forward; a
run resumed from a checkpoint equals the uninterrupted run; the tiny_debug
CLI runs end to end on the CPU (--device cpu), the counterpart of
tests/test_cli.py:49-76.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.cli import pretrain as jax_cli
from mofo_tpu.data import filelist as jax_filelist
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.train import metrics as jax_metrics
from mofo_tpu.train.checkpoint import (
    import_torch_pretrain,
    load_torch_checkpoint,
)
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.core import distributed
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.train import checkpoint as ckpt
from mofo_tpu_torch.train import metrics as M
from mofo_tpu_torch.train import optim
from mofo_tpu_torch.train.train_state import TrainState

TINY_PRETRAIN = [
    "--model", "pretrain_videomae_tiny_debug",
    "--decoder_depth", "1",
    "--synthetic", "4",
    "--batch_size", "2",
    "--input_size", "32",
    "--num_frames", "4",
    "--epochs", "1",
    "--warmup_epochs", "0",
    "--save_ckpt_freq", "1",
    "--decode_height", "48",
    "--decode_width", "64",
    "--dtype", "float32",
    "--device", "cpu",
]


def _run(argv, out):
    return PT.main(PT.get_args(argv + ["--output_dir", str(out)]))


class TestPretrainCLI:
    def test_runs_and_checkpoints(self, tmp_path):
        state = _run(TINY_PRETRAIN, tmp_path)
        assert state.step == 2  # 4 clips / batch 2
        assert (tmp_path / "checkpoint-0.pth").is_file()
        stats = json.loads((tmp_path / "log.txt").read_text().splitlines()[-1])
        assert np.isfinite(stats["train_loss"]) and stats["epoch"] == 0
        assert stats["data_wait_s"] >= 0 and stats["step_s"] > 0

    def test_mofo_masking_path(self, tmp_path):
        state = _run(TINY_PRETRAIN + ["--mask_type", "tube_bb"], tmp_path)
        assert state.step == 2

    def test_auto_resume_skips_done_epochs(self, tmp_path):
        _run(TINY_PRETRAIN, tmp_path)
        # rerun with the same epochs: resumes past the end, no new steps
        state = _run(TINY_PRETRAIN, tmp_path)
        assert state.step == 2
        assert len((tmp_path / "log.txt").read_text().splitlines()) == 1


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """A run that stops after epoch 0 and resumes from checkpoint-0 takes
    the steps of the uninterrupted run: same losses, same weights."""
    argv = TINY_PRETRAIN + ["--epochs", "2", "--mask_type", "tube_bb"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    _run(argv, whole)
    cut.mkdir()
    shutil.copy(whole / "checkpoint-0.pth", cut)
    state = _run(argv, cut)
    assert state.step == 4 and state.opt_state.count == 4
    a = torch.load(whole / "checkpoint-1.pth", weights_only=True)
    b = torch.load(cut / "checkpoint-1.pth", weights_only=True)
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["state"][3]["step"] == 4
    log_a = [json.loads(x)
             for x in (whole / "log.txt").read_text().splitlines()]
    log_b = [json.loads(x)
             for x in (cut / "log.txt").read_text().splitlines()]
    assert log_b[0]["epoch"] == 1
    assert log_b[0]["train_loss"] == log_a[1]["train_loss"]


def test_get_args_and_build_config_match_jax():
    argv = ["--model", "pretrain_videomae_small_patch16_224", "--epochs",
            "3", "--mask_ratio", "0.8", "--opt_betas", "0.9", "0.999"]
    for mofo in (False, True):
        ours = vars(PT.get_args(argv, mofo_defaults=mofo))
        ref = vars(jax_cli.get_args(argv, mofo_defaults=mofo))
        assert ours.pop("device") == "cuda"
        assert ours == ref
        cfg = PT.build_config(PT.get_args(argv, mofo_defaults=mofo))
        jcfg = jax_cli.build_config(jax_cli.get_args(argv,
                                                     mofo_defaults=mofo))
        for field in ("model", "epochs", "batch_size", "dtype",
                      "motion_loss_weight", "masking", "input_size"):
            assert str(getattr(cfg, field)) == str(getattr(jcfg, field))
        assert cfg.optimizer.opt_betas == jcfg.optimizer.opt_betas


@pytest.mark.parametrize("flags,match", [
    (["--opt", "lamb"], "--opt lamb"),
    (["--mesh_fsdp", "2"], "a mesh"),
])
def test_unported_flags_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        PT.build_config(PT.get_args(flags))


def test_data_path_reads_the_setting_file_as_mofo_tpu_does(tmp_path):
    """--data_path is no longer refused: a missing file fails where and as
    mofo_tpu's read_setting_file fails."""
    path = str(tmp_path / "train.csv")
    with pytest.raises(RuntimeError) as ref:
        jax_filelist.read_setting_file(path)
    with pytest.raises(RuntimeError) as ours:
        PT.main(PT.get_args(TINY_PRETRAIN[:4] + TINY_PRETRAIN[6:]
                            + ["--data_path", path]))
    assert str(ours.value) == str(ref.value)


def test_distributed_is_one_process(monkeypatch, capsys):
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_main_process()
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    distributed.init_distributed_mode()
    assert "single process" in capsys.readouterr().out
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.launcher_world() == (0, 1)
    distributed.init_distributed_mode(verbose=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="2 processes"):
        distributed.init_distributed_mode()
    distributed.setup_printing()("shown")
    assert capsys.readouterr().out == "shown\n"


def test_loggers_match_jax(tmp_path):
    vals = [3.0, 1.0, 4.0, 1.0, 5.0]
    ours, ref = M.SmoothedValue(window_size=3), jax_metrics.SmoothedValue(
        window_size=3)
    for v in vals:
        ours.update(v, n=2)
        ref.update(v, n=2)
    for attr in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(ours, attr) == getattr(ref, attr)
    assert str(ours) == str(ref)

    lines = []
    logger = M.MetricLogger(print_fn=lines.append)
    seen = []
    for x in logger.log_every(range(5), 2, "Epoch: [0]"):
        seen.append(x)
        logger.update(loss=float(x), grad_norm=torch.tensor(2.0))
    assert seen == list(range(5))
    assert logger.epoch_stats() == {"loss": 2.0, "grad_norm": 2.0}
    assert logger.data_time.count == logger.iter_time.count == 5
    assert logger.iter_time.global_avg >= logger.data_time.global_avg
    assert [line.split(" eta")[0] for line in lines[:3]] == [
        "Epoch: [0] [0/5]", "Epoch: [0] [2/5]", "Epoch: [0] [4/5]"]
    assert "Total time" in lines[-1]

    M.JsonlLogger(str(tmp_path)).write({"epoch": 0, "train_loss": 1.5})
    M.JsonlLogger(str(tmp_path), enabled=False).write({"epoch": 9})
    M.JsonlLogger("").write({"epoch": 9})
    assert (tmp_path / "log.txt").read_text() == \
        '{"epoch": 0, "train_loss": 1.5}\n'
    tb = M.TensorboardLogger(None)
    tb.update(head="loss", step=1, loss=1.0)
    tb.flush()
    assert tb.writer is None


GEO = dict(img_size=32, num_frames=4, encoder_embed_dim=64, encoder_depth=2,
           encoder_num_heads=2, decoder_embed_dim=32, decoder_depth=1,
           decoder_num_heads=2, decoder_num_classes=1536)
NAME = "pretrain_videomae_base_patch16_224"


def _trained_state():
    model = create_model(NAME, device="cpu", seed=3, **GEO)
    named = dict(model.named_parameters())
    tx = optim.create_optimizer(named, lr_schedule=np.full(4, 1e-3,
                                                           np.float32))
    state = TrainState.create(model, tx)
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in named.items()}
    for _ in range(2):
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
    return model, state


def test_checkpoint_loads_into_jax_and_gives_the_same_forward(tmp_path):
    model, state = _trained_state()
    path = ckpt.save_checkpoint(str(tmp_path), model, state, epoch=7)
    assert os.path.basename(path) == "checkpoint-7.pth"
    params = import_torch_pretrain(load_torch_checkpoint(path))
    jmodel = jax_create_model(NAME, **GEO)
    clip = np.random.RandomState(0).randn(2, 4, 32, 32, 3).astype(np.float32)
    vis = np.array([[0, 2, 4, 6], [1, 3, 5, 7]], np.int32)
    msk = np.array([[1, 3, 5, 7], [0, 2, 4, 6]], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip),
                                   jnp.asarray(vis), jnp.asarray(msk)))
    with torch.no_grad():
        got = model(torch.from_numpy(clip), torch.from_numpy(vis),
                    torch.from_numpy(msk)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(clip), jnp.asarray(vis),
            jnp.asarray(msk))["params"]))


def test_checkpoint_restores_parameters_moments_step_and_epoch(tmp_path):
    model, state = _trained_state()
    ckpt.save_checkpoint(str(tmp_path), model, state, epoch=0)
    ckpt.save_checkpoint(str(tmp_path), model, state, epoch=12)
    (tmp_path / "checkpoint-3.pth").write_bytes(
        (tmp_path / "checkpoint-0.pth").read_bytes())
    assert ckpt.latest_checkpoint(str(tmp_path)) == (
        str(tmp_path / "checkpoint-12.pth"), 12)
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    fresh = create_model(NAME, device="cpu", seed=4, **GEO)
    tx = optim.create_optimizer(dict(fresh.named_parameters()),
                                lr_schedule=np.ones(2, np.float32))
    restored = TrainState.create(fresh, tx)
    assert ckpt.auto_resume(str(tmp_path), fresh, restored) == 12
    assert restored.step == 2 and restored.opt_state.count == 2
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p.detach()), n
        assert torch.equal(restored.opt_state.mu[n], state.opt_state.mu[n])
        assert torch.equal(restored.opt_state.nu[n], state.opt_state.nu[n])
    other = create_model(NAME, device="cpu", **dict(GEO, decoder_depth=2))
    with pytest.raises(ValueError, match="other parameters"):
        ckpt.load_checkpoint(str(tmp_path / "checkpoint-0.pth"), other,
                             TrainState.create(other, optim.create_optimizer(
                                 dict(other.named_parameters()),
                                 lr_schedule=np.ones(1, np.float32))))


def test_step_seed_depends_on_seed_and_step():
    seeds = {PT.step_seed(s, t) for s in range(3) for t in range(1000)}
    assert len(seeds) == 3000
