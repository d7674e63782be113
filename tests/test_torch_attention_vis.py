"""The port's cli/attention_vis.py against mofo_tpu's, on the CPU.

- token_saliency_grad, token_saliency_gradcam (Grad-CAM and Grad-CAM++,
  both target layers) and token_saliency_rollout at tests/test_saliency.py's
  geometry (img 32, 4 frames, width 32, depth 2, 2 heads), f32, the same
  weights (params_from_jax), rtol 1e-4;
- main with --device cpu on a cv2-written 48x64 mp4 against mofo_tpu's main
  with the same .pth weights, for every method (gradcam++ with a box JSON):
  the frames handed to cv2.imwrite within 1 uint8 level, as
  tests/test_torch_factory_cli.py holds vis;
- an orbax directory is refused.
"""

import contextlib
import io

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.cli import attention_vis as j_vis
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu_torch.cli import attention_vis as vis
from mofo_tpu_torch.factory import bbox
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.train.checkpoint import params_from_jax

KW = dict(img_size=32, all_frames=4, embed_dim=32, depth=2, num_heads=2,
          num_classes=5, init_scale=1.0)
VIT = "vit_base_patch16_224"
RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port model with the same weights, the
    clips as numpy)."""
    clips = np.random.RandomState(0).randn(2, 4, 32, 32, 3).astype(
        np.float32)
    jmodel = jax_create_model(VIT, **KW)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(clips))["params"]
    params = jax.tree.map(np.asarray, params)
    port = create_model(VIT, device="cpu", **KW)
    port.load_state_dict(params_from_jax(params), strict=True)
    port.eval()
    return jmodel, params, port, clips


def _close(ours, ref):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (2, 2, 2, 2)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(ours, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("target", [-1, 3])
def test_grad_saliency_matches_jax(pair, target):
    jmodel, params, port, clips = pair
    _close(vis.token_saliency_grad(port, torch.from_numpy(clips), target),
           j_vis.token_saliency_grad(jmodel, params, jnp.asarray(clips),
                                     target))


@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("layer,target", [(0, 2), (1, -1)])
def test_gradcam_matches_jax(pair, layer, target, plus):
    jmodel, params, port, clips = pair
    _close(vis.token_saliency_gradcam(port, torch.from_numpy(clips), target,
                                      layer, plus=plus),
           j_vis.token_saliency_gradcam(jmodel, params, jnp.asarray(clips),
                                        target, layer, plus=plus))
    # the hook is gone: the model runs as before
    assert not port.blocks[layer].norm1._forward_hooks


def test_rollout_matches_jax(pair):
    _, params, port, clips = pair
    ours = vis.token_saliency_rollout(
        dict(KW), port.state_dict(), torch.from_numpy(clips),
        lambda **kw: create_model(VIT, device="cpu", **kw))
    ref = j_vis.token_saliency_rollout(
        dict(KW), params, jnp.asarray(clips),
        lambda **kw: jax_create_model(VIT, **kw))
    _close(ours, ref)


def _write_video(path, n=6, seed=0):
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 120, (48, 64, 3)).astype(np.uint8)
    fg = rng.randint(130, 256, (16, 16, 3)).astype(np.uint8)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    for i in range(n):
        frame = bg.copy()
        frame[10 + i:26 + i, 8 + 3 * i:24 + 3 * i] = fg
        w.write(frame)
    w.release()


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


ARGS = ["--model", "vit_tiny_debug", "--input_size", "32", "--num_frames",
        "4", "--nb_classes", "5", "--layer", "0"]


@pytest.mark.parametrize("method", ["grad", "rollout", "gradcam",
                                    "gradcam++"])
def test_main_matches_jax(method, tmp_path, monkeypatch):
    video = tmp_path / "clip.mp4"
    _write_video(video)
    pth = tmp_path / "ft.pth"
    model = create_model("vit_tiny_debug", device="cpu", seed=4,
                         img_size=32, all_frames=4, num_classes=5,
                         init_scale=1.0)
    torch.save({"model": model.state_dict()}, pth)
    extra = ["--method", method]
    if method == "gradcam++":
        boxes = [(2 + i, 3, 20 + i, 30) for i in range(6)]
        bbox.write_bbox_json(str(tmp_path / "bb.json"), {"clip": boxes})
        extra += ["--bb_json", str(tmp_path / "bb.json")]
    written = {}

    def imwrite(path, img):
        written[path] = np.array(img)
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    common = ["--video", str(video), "--model_path", str(pth)] + ARGS + extra
    sal = _quiet(vis.main, vis.get_args(
        common + ["--save_path", str(tmp_path / "ours"), "--device", "cpu"]))
    _quiet(j_vis.main, j_vis.get_args(
        common + ["--save_path", str(tmp_path / "ref")]))
    # scaled by max + 1e-9
    assert sal.shape == (2, 2, 2) and sal.max() == pytest.approx(1.0, abs=1e-3)
    names = [f"saliency_{i:02d}.jpg" for i in range(4)]
    assert sorted(written) == sorted(
        str(tmp_path / d / n) for d in ("ours", "ref") for n in names)
    for n in names:
        a = written[str(tmp_path / "ours" / n)].astype(np.int16)
        b = written[str(tmp_path / "ref" / n)].astype(np.int16)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, n


def test_main_refuses_an_orbax_directory(tmp_path):
    video = tmp_path / "clip.mp4"
    _write_video(video)
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        _quiet(vis.main, vis.get_args(
            ["--video", str(video), "--save_path", str(tmp_path / "out"),
             "--model_path", str(tmp_path / "ckpt"), "--device", "cpu"]
            + ARGS))
