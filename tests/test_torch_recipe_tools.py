"""The loader's process workers, the throughput meter and the profiler
context, and the recipe tools (mofo_tpu_torch/tools/e2e_recipe.py,
overfit_real.py) against mofo_tpu's.

- PrefetchLoader(worker_mode="process") yields the batches that thread
  workers and mofo_tpu's process workers yield, on datasets with fixed
  draws (SyntheticClipDataset: sample i from RandomState(seed + i)); its
  forked workers start from the parent's np.random state, as mofo_tpu's do.
- ThroughputMeter equals mofo_tpu's; profile_trace writes a trace.
- The tools' video writers equal mofo_tpu's tools' (the bytes cv2 writes;
  the class patterns), overfit_real records the CLI's own parse of its
  flags, and e2e_recipe runs end to end with --device cpu (a few seconds).
- Every new tool asks for the card unless told --device cpu.
"""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from mofo_tpu.data import pipeline as jax_pipeline
from mofo_tpu.train import metrics as jax_metrics
from mofo_tpu_torch.data import pipeline as P
from mofo_tpu_torch.train import metrics as M
from mofo_tpu_torch.train import schedules


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """tools/<name>.py of mofo_tpu, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(loader):
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("drop_last,n", [(True, 12), (False, 10)])
def test_process_workers_equal_threads_and_mofo_tpu(drop_last, n):
    kw = dict(n=n, num_frames=2, decode_size=(24, 32), with_boxes=True)
    ds = P.SyntheticClipDataset(**kw)
    proc = _batches(P.PrefetchLoader(ds, 4, device="cpu", num_workers=3,
                                     worker_mode="process",
                                     drop_last=drop_last))
    thread = _batches(P.PrefetchLoader(ds, 4, device="cpu", num_workers=3,
                                       drop_last=drop_last))
    jax_ds = jax_pipeline.SyntheticClipDataset(**kw)
    ref = list(jax_pipeline.PrefetchLoader(
        jax_ds, 4, to_device=False, num_workers=3, worker_mode="process",
        drop_last=drop_last))
    assert len(proc) == len(thread) == len(ref) == (
        n // 4 if drop_last else math.ceil(n / 4))
    for a, b, c in zip(proc, thread, ref):
        assert set(a) == set(b) == set(c)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], np.asarray(c[k]))


class _GlobalDraws:
    """A sample is one draw of the process's np.random."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {"x": np.int64(np.random.randint(0, 2 ** 31))}


def test_process_workers_start_from_the_parents_np_random():
    np.random.seed(123)
    state = np.random.get_state()
    first = np.random.RandomState()
    first.set_state(state)
    draws = set(int(first.randint(0, 2 ** 31)) for _ in range(4))
    np.random.set_state(state)
    batch = _batches(P.PrefetchLoader(_GlobalDraws(), 4, device="cpu",
                                      num_workers=2,
                                      worker_mode="process"))[0]
    got = set(batch["x"].tolist())
    # each worker draws from its copy of the parent's state: the sample
    # each worker takes first is the parent's next draw
    assert got <= draws
    first.set_state(state)
    assert int(first.randint(0, 2 ** 31)) in got
    # the parent's own state did not move
    assert np.random.get_state()[1].tolist() == state[1].tolist()


def test_worker_mode_is_checked():
    with pytest.raises(ValueError, match="thread or process"):
        P.PrefetchLoader(P.SyntheticClipDataset(n=2), 1, device="cpu",
                         worker_mode="spawn")


def test_throughput_meter_equals_mofo_tpus():
    ours = M.ThroughputMeter(16, flops_per_step=3e12, peak_flops=9.9e14)
    ref = jax_metrics.ThroughputMeter(16, flops_per_step=3e12,
                                      peak_flops=9.9e14)
    bare, bare_ref = M.ThroughputMeter(8), jax_metrics.ThroughputMeter(8)
    rng = np.random.RandomState(0)
    for t in rng.uniform(0.02, 0.2, 70):  # past the window of 50
        for m in (ours, ref, bare, bare_ref):
            m.update(float(t))
        assert ours.clips_per_sec == ref.clips_per_sec
        assert ours.mfu == ref.mfu
    assert bare.mfu == bare_ref.mfu == 0.0
    assert bare.clips_per_sec == bare_ref.clips_per_sec


def test_profile_trace_writes_a_trace(tmp_path):
    with M.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_video_writers_equal_mofo_tpus_tools(tmp_path):
    from mofo_tpu_torch.tools import e2e_recipe, overfit_real

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        bench_input = _jax_tool("bench_input")
        jax_overfit = _jax_tool("overfit_real")
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    for d in ("ours", "ref"):
        (tmp_path / d).mkdir()
    ours = e2e_recipe.make_videos(str(tmp_path / "ours"), 2, frames=6,
                                  size=(64, 48))
    ref = bench_input.make_videos(str(tmp_path / "ref"), 2, frames=6,
                                  size=(64, 48))
    for a, b in zip(ours, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for cls in range(4):
        np.testing.assert_array_equal(
            overfit_real.class_pattern(cls, 96, 128,
                                       np.random.RandomState(cls)),
            jax_overfit.class_pattern(cls, 96, 128,
                                      np.random.RandomState(cls)))


def test_overfit_records_the_effective_flags():
    from mofo_tpu_torch.cli import finetune as FT
    from mofo_tpu_torch.tools import overfit_real

    argv = overfit_real.cli_args("list.txt", "out", epochs=60,
                                 warmup_epochs=5, batch=8, lr=1e-3,
                                 aa="rand-m7-n1-mstd0.5-inc1", reprob=0.0,
                                 device="cpu")
    eff = FT.get_args(argv)
    assert (eff.model, eff.aa, eff.reprob, eff.epochs, eff.batch_size,
            eff.mixup, eff.cutmix, eff.val_path, eff.dtype) == (
        "vit_base_patch16_224", "rand-m7-n1-mstd0.5-inc1", 0.0, 60, 8, 0.0,
        0.0, "list.txt", "bfloat16")
    # the CLI scales its --lr by batch / 256: the optimizer sees 1e-3
    assert schedules.scaled_lr(eff.lr, eff.batch_size) == pytest.approx(
        1e-3, rel=1e-12)


def test_e2e_recipe_on_the_cpu(tmp_path):
    from mofo_tpu_torch.tools import e2e_recipe

    out = tmp_path / "e2e.json"
    rec = e2e_recipe.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["device"] == "cpu"
    assert rec["pretrain_steps"] == 4  # 8 videos, B=4, 2 epochs
    assert math.isfinite(rec["pretrain_final_loss"])
    assert rec["finetune_init_tensors"] > 0
    assert rec["finetune_steps"] == 4
    last = rec["finetune_last_epoch"]
    assert last["epoch"] == 1 and math.isfinite(last["val_loss"])


@pytest.mark.parametrize("tool", ["parity_artifact", "convergence_ab",
                                  "convergence_ab_finetune", "e2e_recipe",
                                  "overfit_real"])
def test_tools_run_on_the_card_unless_told_cpu(tool, tmp_path):
    """Without --device each tool asks for CUDA, which this box lacks: it
    raises before it writes or draws anything."""
    import importlib

    mod = importlib.import_module(f"mofo_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "never.json")])
    assert not (tmp_path / "never.json").exists()
