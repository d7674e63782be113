"""The port's offline factory modules against mofo_tpu's, on the CPU.

- TV-L1 (factory/flow.py) against mofo_tpu's on the shifted pairs of
  tests/test_factory.py: 64x64 with the defaults (4 scales, 8 warps, 100
  iterations; the pyramid 64, 32, 16, 16 takes the min-16 clamp and a level
  without a rescale) and a non-square odd 50x70 with fewer iterations, max
  |d| <= 1e-3 px and p99 <= 1e-4; the antialiased pyramid resize within
  1e-6 of jax.image.resize; a batch of pairs equal to each pair alone; grey
  and colour, uint8 and float inputs; the cv2 backends equal;
- motion maps: the tensor motion_boundary / motion_sts within 1e-5 of the
  _jax versions, the numpy copies equal to mofo_tpu's;
- boxes, the JSON writer, annot and epic_segments: the copies give
  mofo_tpu's outputs on the same inputs (the fixtures of
  tests/test_epic_preprocess.py);
- without a GPU the flow entry points raise when `device` is left at its
  default.
"""

import csv
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mofo_tpu.factory import annot as j_annot
from mofo_tpu.factory import bbox as j_bbox
from mofo_tpu.factory import epic_segments as j_es
from mofo_tpu.factory import flow as j_flow
from mofo_tpu.factory import motion_maps as j_mm
from mofo_tpu_torch.factory import annot, bbox, epic_segments, flow
from mofo_tpu_torch.factory import motion_maps as mm

FLOW_MAX = 1e-3
FLOW_P99 = 1e-4


def _shifted_pair(shift=(3, 0), H=64, W=64, seed=0):
    """tests/test_factory.py's pair: a smoothed random texture and the same
    texture shifted by `shift` (dx, dy) pixels."""
    rng = np.random.RandomState(seed)
    base = rng.rand(H + 16, W + 16).astype(np.float32)
    base = gaussian_filter(base, 2.0) * 255
    a = base[8:8 + H, 8:8 + W]
    b = base[8 - shift[1]:8 - shift[1] + H, 8 - shift[0]:8 - shift[0] + W]
    return a, b


def _assert_flow_close(ours, ref):
    d = np.abs(np.asarray(ours) - np.asarray(ref))
    assert d.max() <= FLOW_MAX and np.percentile(d, 99) <= FLOW_P99, (
        d.max(), np.percentile(d, 99))


@pytest.mark.parametrize("shift,H,W,seed,kw", [
    ((3, 0), 64, 64, 0, {}),
    ((0, 2), 64, 64, 1, {}),
    ((2, 1), 50, 70, 2, {"n_iters": 20}),
], ids=["64x64_dx3", "64x64_dy2", "50x70_odd"])
def test_tvl1_matches_jax(shift, H, W, seed, kw):
    a, b = _shifted_pair(shift, H, W, seed)
    ref = np.asarray(j_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b), **kw))
    ours = flow.tvl1_flow(a, b, device="cpu", **kw)
    assert ours.shape == (H, W, 2) and ours.dtype == torch.float32
    _assert_flow_close(ours.numpy(), ref)


def test_tvl1_colour_uint8_matches_jax():
    rng = np.random.RandomState(3)
    base = (gaussian_filter(rng.rand(44, 52, 3), (2, 2, 0)) * 255).astype(
        np.uint8)
    a, b = base[4:40, 4:44], base[3:39, 6:46]
    kw = dict(n_scales=3, n_warps=3, n_iters=15)
    ref = np.asarray(j_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b), **kw))
    _assert_flow_close(flow.tvl1_flow(a, b, device="cpu", **kw).numpy(), ref)


@pytest.mark.parametrize("src,dst", [
    ((64, 64), (32, 32)), ((240, 320), (120, 160)), ((240, 320), (30, 40)),
    ((224, 224), (112, 112)), ((101, 77), (51, 39)), ((16, 16), (16, 18)),
    ((25, 35), (50, 70)), ((50, 70), (50, 70)),
])
def test_pyramid_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(sum(src)).rand(*src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    ours = flow._resize2d(torch.from_numpy(x)[None], dst)[0].numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_pyramid_shapes_take_the_min_16_clamp():
    """64x64 runs at 64, 32, 16, 16: the last two levels share a shape, so
    the flow passes between them without a rescale (JAX :163-172)."""
    seen = []
    real = flow._tvl1_level

    def spy(I0, I1, u, v, **kw):
        seen.append(tuple(I0.shape[1:]))
        return real(I0, I1, u, v, **kw)

    a, b = _shifted_pair()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flow, "_tvl1_level", spy)
        flow.tvl1_flow(a, b, device="cpu", n_warps=1, n_iters=1)
    assert seen == [(16, 16), (16, 16), (32, 32), (64, 64)]


def test_batched_pairs_equal_each_pair_alone():
    """tvl1_flow_batch (one call, all pairs through every level together)
    gives each pair the flow that a call on that pair alone gives."""
    rng = np.random.RandomState(5)
    base = gaussian_filter(rng.rand(60, 70), 2.0) * 255
    frames = np.stack([base[i:i + 40, 2 * i:2 * i + 48] for i in range(4)])
    kw = dict(n_warps=2, n_iters=10)
    batch = flow.tvl1_flow_batch(frames, device="cpu", **kw)
    assert batch.shape == (3, 40, 48, 2)
    for i in range(3):
        one = flow.tvl1_flow(frames[i], frames[i + 1], device="cpu", **kw)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), atol=1e-6,
                                   rtol=0)
    pairs = flow.tvl1_flow(frames[:-1], frames[1:], device="cpu", **kw)
    np.testing.assert_array_equal(pairs.numpy(), batch.numpy())
    ref = np.asarray(j_flow.tvl1_flow_batch(jnp.asarray(frames), **kw))
    _assert_flow_close(batch.numpy(), ref)


@pytest.mark.parametrize("backend", ["dis", "farneback"])
def test_cv2_backends_equal_jax(backend):
    a, b = _shifted_pair(shift=(3, 0))
    a, b = a.astype(np.uint8), b.astype(np.uint8)
    np.testing.assert_array_equal(
        flow.compute_flow(a, b, backend=backend),
        j_flow.compute_flow(a, b, backend=backend))


def test_compute_flow_tvl1_on_the_cpu_matches_jax():
    a, b = _shifted_pair(shift=(0, 2), H=32, W=40, seed=4)
    got = flow.compute_flow(a, b, backend="tvl1", device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (32, 40, 2)
    _assert_flow_close(got, np.asarray(j_flow.tvl1_flow(jnp.asarray(a),
                                                        jnp.asarray(b))))
    with pytest.raises(ValueError):
        flow.compute_flow(a, b, backend="brox", device="cpu")


def test_flow_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot show")
    a, b = _shifted_pair(H=16, W=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.tvl1_flow(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.tvl1_flow_batch(np.stack([a, b]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.compute_flow(a, b)


# ---------------------------------------------------------------------------
# Motion maps
# ---------------------------------------------------------------------------


def _flow_images(T=6, H=32, W=40, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(H, W) * 2).astype(dtype) for _ in range(T)]


@pytest.mark.parametrize("T,H,W", [(4, 32, 32), (7, 24, 40), (1, 3, 3)])
def test_motion_boundary_matches_jax(T, H, W):
    imgs = np.stack(_flow_images(T, H, W, seed=T))
    ref = np.asarray(j_mm.motion_boundary_jax(jnp.asarray(imgs)))
    ours = mm.motion_boundary(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    # and the numpy transcription (scipy's border) agrees with both
    mb_x, mb_y = j_mm.compute_motion_boundary_np(list(imgs))
    np.testing.assert_allclose(ours, np.stack([mb_x, mb_y]), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("size,input_size", [(8, 32), (4, 32), (7, 30)])
def test_motion_sts_matches_jax(size, input_size):
    imgs = np.stack(_flow_images(4, input_size, input_size, seed=size))
    ref = np.asarray(j_mm.motion_sts_jax(jnp.asarray(imgs), size=size,
                                         input_size=input_size))
    ours = mm.motion_sts(torch.from_numpy(imgs), size, input_size).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_numpy_motion_maps_equal_jax_packages():
    imgs = _flow_images(9, 32, 40, seed=2)
    for window in (4, 8):
        ours = mm.motion_magnitude_frames_np(imgs, window=window)
        ref = j_mm.motion_magnitude_frames_np(imgs, window=window)
        assert len(ours) == len(ref) == 9
        for o, r in zip(ours, ref):
            assert o.dtype == np.uint8
            np.testing.assert_array_equal(o, r)
    sq = [im[:, :32].astype(np.float64) for im in imgs[:4]]
    np.testing.assert_array_equal(mm.motion_sts_np(sq, 8, 32),
                                  j_mm.motion_sts_np(sq, 8, 32))
    np.testing.assert_array_equal(mm.zero_boundary_np(imgs[0]),
                                  j_mm.zero_boundary_np(imgs[0]))
    np.testing.assert_array_equal(mm.downsample_np(sq[0], 4, 32),
                                  j_mm.downsample_np(sq[0], 4, 32))


# ---------------------------------------------------------------------------
# Boxes, JSON, annot
# ---------------------------------------------------------------------------


def _blob_maps(T=6, H=96, W=128, seed=0):
    """A moving blob over noise; frame 3 empty (the borrow-forward and the
    previous-box fallback run)."""
    rng = np.random.RandomState(seed)
    maps = []
    for t in range(T):
        m = (rng.rand(H, W) * 40).astype(np.uint8)
        if t != 3:
            x = 30 + 4 * t
            m[40:70, x:x + 30] = 255
        maps.append(m)
    return maps


@pytest.mark.parametrize("kind", ["blob", "empty", "two_blobs", "rgb"])
@pytest.mark.parametrize("clip_union", [True, False])
def test_extract_boxes_equal_jax(kind, clip_union):
    if kind == "blob":
        maps = _blob_maps()
    elif kind == "empty":
        maps = [np.zeros((64, 80), np.uint8)] * 4
    elif kind == "two_blobs":
        maps = _blob_maps(seed=1)
        for t, m in enumerate(maps):
            m[5:20, 100 - 2 * t:120 - 2 * t] = 200
    else:
        maps = [np.repeat(m[..., None], 3, -1) for m in _blob_maps(seed=2)]
    ours = bbox.extract_boxes(maps, clip_union=clip_union)
    assert ours == j_bbox.extract_boxes(maps, clip_union=clip_union)
    assert bbox.bbox_area_ratio(ours, *maps[0].shape[:2]) == \
        j_bbox.bbox_area_ratio(ours, *maps[0].shape[:2])


def test_bbox_json_equal_jax(tmp_path):
    per_video = {"v0": bbox.extract_boxes(_blob_maps()),
                 "v1": [(1, 2, 30, 40)] * 3}
    bbox.write_bbox_json(str(tmp_path / "ours" / "bb.json"), per_video)
    j_bbox.write_bbox_json(str(tmp_path / "ref" / "bb.json"), per_video)
    assert (tmp_path / "ours" / "bb.json").read_bytes() == \
        (tmp_path / "ref" / "bb.json").read_bytes()
    assert bbox.boxes_to_labels(per_video["v1"]) == \
        j_bbox.boxes_to_labels(per_video["v1"])


def test_annot_equal_jax(tmp_path):
    for t in ("Pushing [something] from left to right",
              "Putting [something] into [something]"):
        assert annot.clean_ssv2_template(t) == j_annot.clean_ssv2_template(t)
    labels = {"Pushing something": 17, "Putting something into something": 3}
    split = [{"id": "42", "template": "Pushing [something]"},
             {"id": "7", "template": "Putting [something] into [something]"}]
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    (tmp_path / "train.json").write_text(json.dumps(split))
    (tmp_path / "videos").mkdir()
    (tmp_path / "videos" / "7.mp4").write_bytes(b"\0")
    for require in (False, True):
        args = (str(tmp_path / "labels.json"), str(tmp_path / "train.json"),
                str(tmp_path / "videos"), require)
        assert annot.build_ssv2_list(*args) == j_annot.build_ssv2_list(*args)
    entries = annot.build_ssv2_list(*args[:3], False)
    annot.write_setting_file(str(tmp_path / "a" / "l.csv"), entries)
    j_annot.write_setting_file(str(tmp_path / "b" / "l.csv"), entries)
    assert (tmp_path / "a" / "l.csv").read_text() == \
        (tmp_path / "b" / "l.csv").read_text()


def _epic_csv(path, rows):
    fields = ["narration_id", "participant_id", "video_id",
              "narration_timestamp", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame", "narration", "verb", "verb_class",
              "noun", "noun_class", "all_nouns", "all_noun_classes"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow({**{k: "" for k in fields}, **r})


@pytest.mark.parametrize("classtype", ["verb", "noun", "action"])
def test_epic_lists_equal_jax(tmp_path, classtype):
    def row(i, verb, noun):
        return {"narration_id": f"P01_01_{i}", "participant_id": "P01",
                "video_id": "P01_01", "narration_timestamp": "00:00:01.00",
                "start_timestamp": "00:00:01.00",
                "stop_timestamp": "00:00:02.50", "start_frame": 1,
                "stop_frame": 60, "narration": "x", "verb": "v",
                "verb_class": verb, "noun": "n", "noun_class": noun,
                "all_nouns": "['n']", "all_noun_classes": f"[{noun}]"}

    _epic_csv(tmp_path / "train.csv", [row(i, i % 3, (2 * i) % 5)
                                       for i in range(6)])
    _epic_csv(tmp_path / "val.csv", [row(i, (i + 1) % 3, i % 5)
                                     for i in range(4)])
    args = (str(tmp_path / "train.csv"), str(tmp_path / "val.csv"), "/ek",
            classtype)
    assert annot.build_epic_lists(*args) == j_annot.build_epic_lists(*args)


# ---------------------------------------------------------------------------
# epic_segments on tests/test_epic_preprocess.py's fixtures
# ---------------------------------------------------------------------------


def _frames_fixture(root, n_frames=8):
    import cv2

    vid_dir = root / "P01" / "rgb_frames" / "P01_01"
    vid_dir.mkdir(parents=True)
    for k in range(n_frames):
        img = np.full((32, 48, 3), k * 10 + 5, np.uint8)
        cv2.imwrite(str(vid_dir / "frame_{:010d}.jpg".format(k + 1)), img)
    _epic_csv(root / "EPIC_100_train.csv", [
        {"participant_id": "P01", "video_id": "P01_01", "start_frame": 0,
         "stop_frame": 2},
        {"participant_id": "P01", "video_id": "P01_01", "start_frame": 4,
         "stop_frame": 6},
        {"participant_id": "P01", "video_id": "P01_01", "start_frame": 5,
         "stop_frame": 99},
    ])
    return root / "EPIC_100_train.csv"


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    return np.stack(frames)


def test_cut_action_segments_equal_jax(tmp_path):
    csv_path = _frames_fixture(tmp_path)
    assert epic_segments.read_epic_rows(str(csv_path)) == \
        j_es.read_epic_rows(str(csv_path))
    for dry in (True, False):
        ours = epic_segments.cut_action_segments(
            str(csv_path), str(tmp_path), str(tmp_path / "ours"),
            dry_run=dry)
        ref = j_es.cut_action_segments(
            str(csv_path), str(tmp_path), str(tmp_path / "ref"),
            dry_run=dry)
        assert ours == ref
    assert ours == {"ok": 2, "missing": 1}
    for i in range(2):
        np.testing.assert_array_equal(
            _read_video(tmp_path / "ours" / f"video_{i}.MP4"),
            _read_video(tmp_path / "ref" / f"video_{i}.MP4"))
    # resume: every written segment exists
    assert epic_segments.cut_action_segments(
        str(csv_path), str(tmp_path), str(tmp_path / "ours"),
        limit=2) == {"exists": 2}


def test_cut_action_segments_in_worker_processes(tmp_path):
    csv_path = _frames_fixture(tmp_path)
    got = epic_segments.cut_action_segments(
        str(csv_path), str(tmp_path), str(tmp_path / "out"), workers=2)
    assert got == {"ok": 2, "missing": 1}
    assert len(_read_video(tmp_path / "out" / "video_1.MP4")) == 3


class _Bbox:
    def __init__(self, left, top, right, bottom):
        self.left, self.top, self.right, self.bottom = left, top, right, \
            bottom


class _Det:
    def __init__(self, box):
        self.bbox = box


class _FrameDet:
    """Duck-typed FrameDetections (what epic_kitchens unpickles)."""

    def __init__(self, hands, objects):
        self.hands = [_Det(_Bbox(*h)) for h in hands]
        self.objects = [_Det(_Bbox(*o)) for o in objects]


@pytest.mark.parametrize("schema", ["dict", "object"])
def test_convert_hoa_equal_jax(tmp_path, schema):
    frames = []
    for k in range(6):
        hands = [[k, k, k + 10, k + 10]]
        objects = [[k + 1, k + 1, k + 5, k + 5]] if k % 2 == 0 else []
        frames.append({"hands": hands, "objects": objects}
                      if schema == "dict" else _FrameDet(hands, objects))
    annot_dir = tmp_path / "hand-objects" / "P01"
    annot_dir.mkdir(parents=True)
    with open(annot_dir / "P01_01.pkl", "wb") as f:
        pickle.dump(frames, f)
    _epic_csv(tmp_path / "c.csv", [
        {"participant_id": "P01", "video_id": "P01_01", "start_frame": 1,
         "stop_frame": 4},
        {"participant_id": "P02", "video_id": "P02_01", "start_frame": 0,
         "stop_frame": 2},
    ])
    out = {}
    for name, mod in (("ours", epic_segments), ("ref", j_es)):
        counts = mod.convert_hoa_detections(
            str(tmp_path / "c.csv"), str(tmp_path / "hand-objects"),
            str(tmp_path / name), merged_json=str(tmp_path / f"{name}.json"))
        out[name] = (counts,
                     (tmp_path / name / "detection_0.json").read_bytes(),
                     (tmp_path / f"{name}.json").read_bytes())
    assert out["ours"] == out["ref"]
    assert out["ours"][0] == {"ok": 1, "missing": 1}
    assert epic_segments.union_box([]) == j_es.union_box([])
    assert epic_segments.union_box([[1, 2, 3, 4], [0, 5, 9, 2]]) == \
        j_es.union_box([[1, 2, 3, 4], [0, 5, 9, 2]])
