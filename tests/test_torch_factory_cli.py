"""The port's factory and tool CLIs against mofo_tpu's, on the CPU.

- motion_factory on cv2-written 64x64 mp4 files of a moving textured
  square (8 frames; the port decodes through its VideoReader and computes
  a video's pairs in one batched TV-L1 call, mofo_tpu one call per pair):
  the same boxes in the JSON, with and without the clip union, and the same
  "SKIP" for a video that fails. A box may move by at most BOX_PX pixels
  per coordinate where a uint8 map level flips;
- epic_preprocess (cut --dry_run, hoa) and download (the plans, item for
  item, and --dry-run's lines) give mofo_tpu's outputs;
- patchify / unpatchify / unnormalize_clip equal mofo_tpu's;
- vis on pretrain_videomae_tiny_debug (32 px, 4 frames) with the same
  weights (a port .pth that mofo_tpu loads through import_torch_pretrain)
  and the same mask (mofo_tpu.ops.masking.tube_mask and the port's patched
  to return it): the frames handed to cv2.imwrite within 1 uint8 level;
- without a GPU, motion_factory and vis raise at their default device.
"""

import contextlib
import io
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.cli import download as j_download
from mofo_tpu.cli import epic_preprocess as j_epic_preprocess
from mofo_tpu.cli import motion_factory as j_motion_factory
from mofo_tpu.cli import vis as j_vis
from mofo_tpu.ops import masking as j_masking
from mofo_tpu.ops import patchify as j_patchify
from mofo_tpu_torch.cli import download, epic_preprocess, motion_factory, vis
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.ops import masking, patchify


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


BOX_PX = 2  # per coordinate, where a uint8 motion-map level flips
SIDE = 64


def _write_square_video(path, n=8, seed=0, step=(3, 2)):
    """A textured square moving by `step` px a frame over a textured
    background, n frames of SIDE x SIDE, mp4v."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 120, (SIDE, SIDE, 3)).astype(np.uint8)
    fg = rng.randint(130, 256, (20, 20, 3)).astype(np.uint8)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (SIDE, SIDE))
    for i in range(n):
        frame = bg.copy()
        x, y = 10 + step[0] * i, 12 + step[1] * i
        frame[y:y + 20, x:x + 20] = fg
        w.write(frame)
    w.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("factory")
    paths = [root / "sq0.mp4", root / "sq1.mp4"]
    _write_square_video(paths[0], seed=0)
    _write_square_video(paths[1], n=6, seed=1, step=(-2, 1))
    (root / "broken.mp4").write_bytes(b"\0" * 64)  # decodes as nothing
    lst = root / "list.csv"
    lst.write_text("".join(f"{p} 0\n" for p in paths)
                   + f"{root / 'broken.mp4'} 0\n")
    return root, lst


def _boxes_of(path):
    with open(path) as f:
        return {k: [tuple(lab["labels"][0]["box2d"][c]
                          for c in ("x1", "y1", "x2", "y2")) for lab in v]
                for k, v in json.load(f).items()}


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


@pytest.mark.parametrize("flags", [[], ["--no_clip_union"],
                                   ["--flow_backend", "dis"]],
                         ids=["union", "per_frame", "dis"])
def test_motion_factory_matches_jax(videos, tmp_path, flags):
    root, lst = videos
    common = ["--data_path", str(lst)] + flags
    ours, text = _quiet(motion_factory.main, motion_factory.get_args(
        common + ["--output", str(tmp_path / "ours.json"), "--device",
                  "cpu"]))
    _, ref_text = _quiet(j_motion_factory.main, j_motion_factory.get_args(
        common + ["--output", str(tmp_path / "ref.json")]))
    got, want = _boxes_of(tmp_path / "ours.json"), _boxes_of(
        tmp_path / "ref.json")
    assert sorted(got) == sorted(want) == ["sq0", "sq1"]
    for key in want:
        assert len(got[key]) == len(want[key]) == (8 if key == "sq0" else 6)
        d = np.abs(np.subtract(got[key], want[key]))
        assert d.max() <= BOX_PX, (key, got[key], want[key])
    # the broken file is skipped by both, and reported
    assert [ln.split(":")[0] for ln in text.splitlines()
            if ln.startswith("SKIP")] == ["SKIP broken"]
    assert [ln.split(":")[0] for ln in ref_text.splitlines()
            if ln.startswith("SKIP")] == ["SKIP broken"]
    assert list(ours["skipped"]) == ["broken"]
    assert set(ours["seconds"]["sq0"]) == {"decode", "flow", "maps", "boxes",
                                           "write"}
    assert ours["boxes"] == {k: [tuple(b) for b in v]
                             for k, v in got.items()}


def test_motion_factory_flows_are_float32_pairs_of_one_call(videos,
                                                            monkeypatch):
    """A video's pairs go through one tvl1_flow_batch call, and the maps
    get float32 (ndimage.convolve keeps its input's dtype)."""
    root, _ = videos
    calls, dtypes = [], []
    real_batch = motion_factory.flow.tvl1_flow_batch
    real_maps = motion_factory.motion_maps.motion_magnitude_frames_np

    def batch(frames, **kw):
        calls.append(frames.shape)
        return real_batch(frames, **kw)

    def maps(imgs, window):
        dtypes.extend({im.dtype for im in imgs})
        return real_maps(imgs, window=window)

    monkeypatch.setattr(motion_factory.flow, "tvl1_flow_batch", batch)
    monkeypatch.setattr(motion_factory.motion_maps,
                        "motion_magnitude_frames_np", maps)
    args = motion_factory.get_args(["--data_path", str(root / "sq0.mp4"),
                                    "--output", "unused", "--device", "cpu"])
    boxes, seconds = motion_factory.process_video(
        str(root / "sq0.mp4"), args, torch.device("cpu"))
    assert calls == [(8, SIDE, SIDE, 3)]
    assert set(dtypes) == {np.dtype(np.float32)}
    assert len(boxes) == 8 and all(s >= 0 for s in seconds.values())


def test_motion_factory_writes_motion_map_videos(videos, tmp_path):
    root, _ = videos
    _quiet(motion_factory.main, motion_factory.get_args([
        "--data_path", str(root / "sq1.mp4"), "--output",
        str(tmp_path / "bb.json"), "--flow_backend", "farneback",
        "--motion_map_dir", str(tmp_path / "maps"), "--device", "cpu"]))
    cap = cv2.VideoCapture(str(tmp_path / "maps" / "sq1.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5  # one map per flow pair of the 6-frame video


def test_factory_and_vis_raise_without_a_gpu(videos, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot show")
    root, lst = videos
    with pytest.raises(RuntimeError, match="no CUDA device"):
        motion_factory.main(motion_factory.get_args(
            ["--data_path", str(lst), "--output", str(tmp_path / "x.json")]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vis.main(vis.get_args(["--img_path", str(root / "sq0.mp4"),
                               "--save_path", str(tmp_path / "v")]))


# ---------------------------------------------------------------------------
# epic_preprocess and download
# ---------------------------------------------------------------------------


def _epic_fixture(root):
    import csv

    vid_dir = root / "P01" / "rgb_frames" / "P01_01"
    vid_dir.mkdir(parents=True)
    for k in range(8):
        cv2.imwrite(str(vid_dir / "frame_{:010d}.jpg".format(k + 1)),
                    np.full((32, 48, 3), k * 10 + 5, np.uint8))
    fields = ["participant_id", "video_id", "start_frame", "stop_frame"]
    with open(root / "EPIC_100_train.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerow(dict(zip(fields, ["P01", "P01_01", 0, 2])))
        w.writerow(dict(zip(fields, ["P01", "P01_01", 4, 6])))
        w.writerow(dict(zip(fields, ["P01", "P01_01", 5, 99])))
    hoa = root / "hand-objects" / "P01"
    hoa.mkdir(parents=True)
    with open(hoa / "P01_01.pkl", "wb") as f:
        import pickle

        pickle.dump([{"hands": [[k, k, k + 10, k + 10]],
                      "objects": [[k + 1, k + 1, k + 5, k + 5]]}
                     for k in range(8)], f)
    return root / "EPIC_100_train.csv"


@pytest.mark.parametrize("cmd", ["cut", "hoa"])
def test_epic_preprocess_matches_jax(tmp_path, cmd):
    csv_path = _epic_fixture(tmp_path)
    out = {}
    for name, mod in (("ours", epic_preprocess), ("ref", j_epic_preprocess)):
        if cmd == "cut":
            argv = ["cut", "--csv", str(csv_path), "--frames_root",
                    str(tmp_path), "--out", str(tmp_path / name),
                    "--dry_run"]
        else:
            argv = ["hoa", "--csv", str(csv_path), "--annot_root",
                    str(tmp_path / "hand-objects"), "--out",
                    str(tmp_path / name), "--merged_json",
                    str(tmp_path / f"{name}.json")]
        counts, text = _quiet(mod.main, mod.get_args(argv))
        files = sorted(p.name for p in (tmp_path / name).glob("*")) \
            if (tmp_path / name).exists() else []
        merged = (tmp_path / f"{name}.json").read_text() \
            if cmd == "hoa" else None
        out[name] = (counts, text, files, merged)
    assert out["ours"] == out["ref"]
    assert out["ours"][0] == ({"planned": 2, "missing": 1} if cmd == "cut"
                              else {"ok": 3})


def test_download_plans_equal_jax(tmp_path):
    assert download.plan_ssv2(str(tmp_path)) == [
        download.Item(**vars(i)) for i in j_download.plan_ssv2(str(tmp_path))]
    kw = dict(what=["videos", "rgb_frames", "flow_frames", "hand_masks",
                    "masks"],
              splits={"P01_01": "test"},
              md5={"videos/test/P01/P01_01.MP4": "abc"},
              errata={"P01/videos/P01_101.MP4": "https://mirror/x.MP4"})
    ours = download.plan_epic(["P01_01", "P01_101", "P02_03"], str(tmp_path),
                              **kw)
    ref = j_download.plan_epic(["P01_01", "P01_101", "P02_03"],
                               str(tmp_path), **kw)
    assert [i.as_json() for i in ours] == [i.as_json() for i in ref]
    assert len(ours) == 15
    assert download.SSV2_ASSEMBLY == j_download.SSV2_ASSEMBLY


@pytest.mark.parametrize("argv", [
    ["ssv2", "--dry-run"],
    ["epic", "--dry-run", "--video-ids", "P01_01", "P01_101", "P03_04",
     "--what", "videos", "masks", "--participants", "P01"],
    ["epic", "--dry-run"],
], ids=["ssv2", "epic", "epic_no_ids"])
def test_download_dry_run_equals_jax(tmp_path, capsys, argv):
    argv = argv[:1] + ["--output", str(tmp_path)] + argv[1:]
    rc = download.main(argv)
    ours = capsys.readouterr()
    assert rc == j_download.main(argv)
    ref = capsys.readouterr()
    assert (ours.out, ours.err) == (ref.out, ref.err)
    assert rc == (2 if argv[-1] == "--dry-run" and argv[0] == "epic" else 0)


# ---------------------------------------------------------------------------
# patchify and vis
# ---------------------------------------------------------------------------


def test_patchify_helpers_equal_jax():
    x = np.random.RandomState(0).randn(2, 4, 32, 48, 3).astype(np.float32)
    ours = patchify.patchify(torch.from_numpy(x), 16, 2)
    ref = np.asarray(j_patchify.patchify(jnp.asarray(x), 16, 2))
    np.testing.assert_array_equal(ours.numpy(), ref)
    back = patchify.unpatchify(ours, 2, 2, 3, 16, 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_patchify.unpatchify(jnp.asarray(ref), 2,
                                                       2, 3, 16, 2)))
    np.testing.assert_allclose(
        patchify.unnormalize_clip(torch.from_numpy(x)).numpy(),
        np.asarray(j_patchify.unnormalize_clip(jnp.asarray(x))), atol=1e-6,
        rtol=0)


VIS_ARGS = ["--model", "pretrain_videomae_tiny_debug", "--decoder_depth",
            "1", "--input_size", "32", "--num_frames", "4", "--seed", "3"]


def test_vis_matches_jax(videos, tmp_path, monkeypatch):
    root, _ = videos
    pth = tmp_path / "pre.pth"
    model = create_model("pretrain_videomae_tiny_debug", device="cpu",
                         seed=4, decoder_depth=1, num_frames=4, img_size=32)
    torch.save({"model": model.state_dict()}, pth)
    # 2 temporal positions x 4 patches a frame, 3 masked a frame (0.9)
    frame_mask = np.array([True, False, True, True])
    mask = np.tile(frame_mask, 2)[None]
    monkeypatch.setattr(j_masking, "tube_mask",
                        lambda *a, **k: jnp.asarray(mask))
    monkeypatch.setattr(masking, "tube_mask",
                        lambda *a, **k: torch.from_numpy(mask))
    written = {}

    def imwrite(path, img):
        written[path] = np.array(img)
        return True

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    common = ["--img_path", str(root / "sq0.mp4"), "--model_path", str(pth)]
    recon, _ = _quiet(vis.main, vis.get_args(
        common + VIS_ARGS + ["--save_path", str(tmp_path / "ours"),
                             "--device", "cpu"]))
    _quiet(j_vis.main, j_vis.get_args(
        common + VIS_ARGS + ["--save_path", str(tmp_path / "ref")]))
    names = [f"{k}_img{i}.jpg" for k in ("ori", "rec", "mask")
             for i in range(4)]
    assert sorted(written) == sorted(
        [str(tmp_path / d / n) for d in ("ours", "ref") for n in names])
    for n in names:
        a = written[str(tmp_path / "ours" / n)].astype(np.int16)
        b = written[str(tmp_path / "ref" / n)].astype(np.int16)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, n
    # the masked patches hold the prediction in "rec", 0.5 in "mask"
    masked = np.flatnonzero(mask[0])
    assert torch.all(recon["mask"][0, masked] == 0.5)
    assert not torch.equal(recon["rec"][0, masked], recon["ori"][0, masked])
    visible = np.flatnonzero(~mask[0])
    assert torch.equal(recon["rec"][0, visible], recon["ori"][0, visible])


def test_vis_refuses_an_orbax_directory(videos, tmp_path):
    root, _ = videos
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        _quiet(vis.main, vis.get_args(
            ["--img_path", str(root / "sq0.mp4"), "--save_path",
             str(tmp_path / "out"), "--model_path", str(tmp_path / "ckpt"),
             "--device", "cpu"] + VIS_ARGS))
