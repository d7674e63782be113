"""The port's bench tools against tools/bench_finetune.py and
tools/bench_pretrain_model.py, on the CPU.

mofo_tpu_torch/tools/bench_finetune.py and bench_pretrain_model.py keep
the JAX tools' FLOP counts (equal here at every --model, --frames and
--img the tools take, and with --bb), their batch rules (the batches the
JAX tools run at every preset of chip_smoke.py's large_presets phase),
their step launches (every Block takes K1/K2; ViT-S's decoder K4), and
they refuse to run without a card unless --device cpu is given. One short
run of each on the CPU (one Block, 2 frames or B = 1) prints its JSON line
with no device metric in it.
"""

import importlib.util
import json
import os

import pytest
import torch

from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import bench_finetune as BF
from mofo_tpu_torch.tools import bench_pretrain_model as BP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model", ["small", "base", "large"])
@pytest.mark.parametrize("frames,img", [(16, 224), (32, 224), (16, 384),
                                        (16, 512), (2, 224)])
def test_finetune_flops_equal_the_jax_tools(model, frames, img):
    jax_tool = _jax_tool("bench_finetune")
    dim, depth, _ = BF.WIDTHS[model]
    n = BF.n_tokens(frames, img)
    assert n == frames // 2 * (img // 16) ** 2
    for B in (1, 7):
        assert BF.vit_b_cls_fwd_flops(B, 174, n, dim, depth) == \
            jax_tool.vit_b_cls_fwd_flops(B, 174, n, dim, depth)


def test_mca_flops_are_the_jax_tools():
    """The JAX tool adds the MCA block inline (tools/bench_finetune.py:
    140-146): 2 n d (d + 2 ahd + ahd + 8 d) + 4 n^2 ahd at d = 768, ahd =
    192."""
    n, d, ahd = 1568, 768, 192
    assert BF.mca_flops(n) == 2 * n * d * (d + 2 * ahd + ahd + 2 * 4 * d) \
        + 4 * n * n * ahd


@pytest.mark.parametrize("model", ["small", "base", "large"])
def test_pretrain_flops_equal_the_jax_tools(model):
    jax_tool = _jax_tool("bench_pretrain_model")
    assert BP.GEOM == jax_tool.GEOM
    for B in (1, 32):
        assert BP.pretrain_fwd_flops(B, *BP.GEOM[model]) == \
            jax_tool.pretrain_fwd_flops(B, *BP.GEOM[model])


# (flags, train B, eval B) of the JAX tool's rule: 24 and 48 clips over
# (frames / 16) (img / 224)^2 (dim / 768)
BATCHES = [
    ({}, 24, 48),
    ({"model": "large"}, 18, 36),
    ({"img": 384}, 8, 16),
    ({"frames": 32}, 12, 24),
    ({"model": "large", "img": 384}, 6, 12),
    ({"model": "large", "img": 512}, 3, 6),
    ({"model": "small"}, 48, 96),
]


@pytest.mark.parametrize("flags,train,ev", BATCHES)
def test_batch_rule_gives_the_jax_tools_batches(flags, train, ev,
                                                monkeypatch):
    monkeypatch.delenv("MOFO_BENCH_BATCH", raising=False)
    kw = {"frames": 16, "img": 224, "model": "base", **flags}
    assert BF.default_batch(False, **kw) == train
    assert BF.default_batch(True, **kw) == ev
    monkeypatch.setenv("MOFO_BENCH_BATCH", "5")
    assert BF.default_batch(False, **kw) == 5


def test_pretrain_batches_are_the_jax_tools():
    assert BP.DEFAULT_BATCH == {"small": 128, "base": 80, "large": 32}


def test_launches_a_step_follow_the_blocks():
    want = dict.fromkeys(fa.KERNELS, 0)
    assert BF.step_launches(24, False, False) == {
        **want, **dict.fromkeys(fa.QKV_KERNELS, 24)}
    assert BF.step_launches(12, True, True) == {
        **want, "qkv_attn_fwd": 12, "mh_attn_fwd": 1}
    assert BP.step_launches("large", 24, 4) == {
        **want, **dict.fromkeys(fa.QKV_KERNELS, 28)}
    assert BP.step_launches("small", 12, 4) == {
        **want, **dict.fromkeys(fa.QKV_KERNELS, 12),
        **dict.fromkeys(fa.HM_KERNELS, 4)}


@pytest.mark.parametrize("tool", [BF, BP])
def test_the_tools_refuse_the_cpu_unless_asked(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tool.parse_args([])
    assert tool.parse_args(["--device", "cpu"]).device == "cpu"


def test_finetune_tool_runs_on_the_cpu(capsys):
    rec = BF.main(["--frames", "2", "--depth", "1", "--batch", "2",
                   "--steps", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        rec
    extra = rec["extra"]
    assert rec["unit"] == "clips/s" and extra["batch"] == 2
    assert extra["tokens"] == 196 and extra["device"] == "cpu"
    assert extra["mfu"] is None and extra["peak_mem_gib"] is None
    assert extra["launches_per_step"] == dict.fromkeys(fa.QKV_KERNELS, 1)


def test_pretrain_tool_runs_on_the_cpu(capsys):
    rec = BP.main(["--model", "base", "--encoder_depth", "1",
                   "--decoder_depth", "1", "--batch", "1", "--steps", "1",
                   "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        rec
    assert rec["metric"] == "clips/sec/card ViT-B MOFO pretrain"
    assert rec["extra"]["mfu"] is None
    assert rec["extra"]["launches_per_step"] == dict.fromkeys(
        fa.QKV_KERNELS, 2)
