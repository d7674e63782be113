"""The port's real-data path against the JAX package, on small mp4 files that
cv2 writes here (64x48, 12-40 frames).

filelist and sampling are copies and must equal mofo_tpu's functions over a
grid of inputs, the samplers both with a passed RandomState and with the
global np.random (whose call sequence is the contract). The port's
VideoReader must decode mofo_tpu's frames bit for bit. The datasets must
return mofo_tpu's samples after the same np.random.seed: uint8 frames, ids,
labels and boxes all exact. The loader's thread workers must equal the
serial fetch, and boxes read from a JSON must come out of the crop as
mofo_tpu's do on the same decoded frames.
"""

import contextlib
import io
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.data import epic as jax_epic
from mofo_tpu.data import filelist as jax_filelist
from mofo_tpu.data import pipeline as jax_pipeline
from mofo_tpu.data import sampling as jax_sampling
from mofo_tpu.data import video_reader as jax_video_reader
from mofo_tpu.ops import augment as jax_augment
from mofo_tpu.ops import image as jax_image
from mofo_tpu_torch.data import epic, filelist, pipeline, sampling
from mofo_tpu_torch.data import video_reader
from mofo_tpu_torch.ops import augment
from mofo_tpu_torch.tools.main_path import MemoryReader, frame_ids

FRAMES = {"a": 40, "b": 12, "c": 23, "d": 33}  # video name -> frame count
W, H = 64, 48


def _write_video(path, n, seed):
    rng = np.random.RandomState(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    for i in range(n):
        frame = np.roll(base, 3 * i, axis=1)
        frame[: 4 + i % 9] = (i * 7) % 255  # a band that changes per frame
        w.write(frame)
    w.release()


def _box_json(names):
    """One box per frame (some frames without a label, one video absent)."""
    rng = np.random.RandomState(3)
    data = {}
    for name in names:
        frames = []
        for i in range(FRAMES[name]):
            if i % 5 == 4:
                frames.append({"labels": []})
                continue
            x1, y1 = rng.randint(0, W // 2), rng.randint(0, H // 2)
            frames.append({"labels": [{"box2d": {
                "x1": float(x1), "y1": float(y1),
                "x2": float(x1 + rng.randint(4, W // 2)),
                "y2": float(y1 + rng.randint(4, H // 2))},
                "gt_annotation": "motion"}]})
        data[name] = frames
    return data


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Videos a-d, a setting file over them (one entry missing, one too
    small), a box JSON, and an EPIC_100-shaped root with its two CSVs."""
    root = tmp_path_factory.mktemp("clips")
    paths = {}
    for seed, (name, n) in enumerate(FRAMES.items()):
        paths[name] = str(root / f"{name}.mp4")
        _write_video(paths[name], n, seed)
    (root / "tiny.mp4").write_bytes(b"\0" * 100)
    good = [f"{paths[n]} {FRAMES[n]} {i}" for i, n in enumerate(FRAMES)]
    (root / "list.csv").write_text("\n".join(good) + "\n")
    (root / "bad.csv").write_text("\n".join(
        [good[0], f"{root / 'missing.mp4'} 9 5", f"{root / 'tiny.mp4'} 3 6",
         good[1]]) + "\n")
    (root / "boxes.json").write_text(json.dumps(_box_json(["a", "b", "c"])))
    # EPIC: row i -> <root>/epic/<split>/video_<i>.mp4
    header = ("narration_id,participant_id,video_id,narration_timestamp,"
              "start_timestamp,stop_timestamp,start_frame,stop_frame,"
              "narration,verb,verb_class,noun,noun_class,all_nouns,"
              "all_noun_classes")
    vn = {"train": [(3, 10), (1, 2), (10, 2), (1, 2)],
          "validation": [(2, 0), (3, 10), (1, 7)]}
    for split, pairs in vn.items():
        rows = [header]
        for i, (verb, noun) in enumerate(pairs):
            os.makedirs(root / "epic" / split, exist_ok=True)
            _write_video(str(root / "epic" / split / f"video_{i}.mp4"),
                         12 + 7 * i, 10 + i)
            rows.append(f"P01_{i},P01,P01_1{i},00:00:0{i}.00,00:00:0{i}.50,"
                        f"00:01:{i}2.25,{i},{i + 40},take thing,take,{verb},"
                        f"thing,{noun},\"['thing']\",[{noun}]")
        (root / f"EPIC_100_{split}.csv").write_text("\n".join(rows) + "\n")
    return root


def _same_samples(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- filelist ------------------------------------------------------------


def test_read_setting_file_equals_jax(videos, tmp_path):
    for name in ("list.csv", "bad.csv"):
        path = str(videos / name)
        assert ([(e.path, e.label) for e in filelist.read_setting_file(path)]
                == [(e.path, e.label)
                    for e in jax_filelist.read_setting_file(path)])
    (tmp_path / "two.txt").write_text("x.mp4 3\ny.mp4 12 7\n\n")
    assert [(e.path, e.label) for e in filelist.read_setting_file(
        str(tmp_path / "two.txt"))] == [("x.mp4", 3), ("y.mp4", 7)]
    with pytest.raises(RuntimeError, match="Setting file .* doesn't exist"):
        filelist.read_setting_file(str(tmp_path / "none.csv"))
    (tmp_path / "one.txt").write_text("lonely.mp4\n")
    with pytest.raises(RuntimeError, match="format is not correct"):
        filelist.read_setting_file(str(tmp_path / "one.txt"))


def test_epic_csv_and_action_space_equal_jax(videos):
    csvs = [str(videos / f"EPIC_100_{s}.csv")
            for s in ("train", "validation")]
    for path in csvs:
        got, want = filelist.read_epic_csv(path), jax_filelist.read_epic_csv(
            path)
        assert [vars(e) for e in got] == [vars(e) for e in want]
    assert filelist.epic_action_space(csvs) == jax_filelist.epic_action_space(
        csvs)
    vn_list, mapping, _ = filelist.epic_action_space(csvs)
    # sorted as strings: '0' sorts before ':'
    assert vn_list[:3] == ["10:2", "1:2", "1:7"]
    assert mapping["10:2"] == 0
    for s in ("00:00:01.50", "01:02:03.25", "10:00:00.0"):
        assert filelist.datetime2sec(s) == jax_filelist.datetime2sec(s)


def test_motion_box_index_equals_jax(videos):
    path = str(videos / "boxes.json")
    ours = filelist.MotionBoxIndex.from_file(path)
    ref = jax_filelist.MotionBoxIndex.from_file(path)
    assert filelist.MotionBoxIndex.video_key("/x/y/a.b.mp4") == "a.b"
    assert ours.video_key("/x/a.mp4") == ref.video_key("/x/a.mp4")
    for key in ("a", "b", "d"):  # d has no boxes: every frame empty
        for ids in ([0, 4, 9, 11], list(range(12)), [-1, 500, 3]):
            got = ours.get(key, ids)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref.get(key, ids))
            np.testing.assert_array_equal(ours.union_box(key, ids),
                                          ref.union_box(key, ids))
    np.testing.assert_array_equal(ours.get("d", [0, 1]),
                                  np.tile([0, 0, 1, 1], (2, 1)))


# --- sampling ------------------------------------------------------------

DURATIONS = [1, 5, 16, 17, 31, 32, 33, 40, 64, 65, 100, 301]


def _samplers(n):
    """(name, port call, reference call), each taking rng=."""
    both = []
    for mod in (sampling, jax_sampling):
        both.append([
            ("tsn", lambda rng, m=mod: m.tsn_frame_ids(n, rng=rng)),
            ("tsn_jitter_segments", lambda rng, m=mod: m.tsn_frame_ids(
                n, num_segments=2, skip_length=8, new_step=4,
                temporal_jitter=True, rng=rng)),
            ("dense_train", lambda rng, m=mod: m.dense_train_indices(
                n, rng=rng)),
            ("dense_train_segments", lambda rng, m=mod: m.dense_train_indices(
                n, clip_len=8, frame_sample_rate=2, num_segment=2,
                sample_rate_scale=2, rng=rng)),
            ("uniform_train", lambda rng, m=mod: m.uniform_train_indices(
                n, rng=rng)),
            ("timestamp", lambda rng, m=mod: m.timestamp_frame_ids(
                3, 3 + n, rng=rng)),
            ("timestamp_centres", lambda rng, m=mod: m.timestamp_frame_ids(
                0, n, num_segments=8, jitter=False, rng=rng)),
            ("dense_test", lambda rng, m=mod: m.dense_test_indices(n)),
            ("dense_test_short", lambda rng, m=mod: m.dense_test_indices(
                n, clip_len=4, frame_sample_rate=3)),
            ("uniform_test", lambda rng, m=mod: m.uniform_test_indices(n)),
            ("uniform_test_3", lambda rng, m=mod: m.uniform_test_indices(
                n, num_segment=4, test_num_segment=3)),
        ])
    return [(a[0], a[1], b[1]) for a, b in zip(*both)]


@pytest.mark.parametrize("n", DURATIONS)
def test_samplers_equal_jax_with_a_passed_random_state(n):
    for seed in (0, 1, 7):
        for name, ours, ref in _samplers(n):
            if n < 2 and name.startswith("timestamp_centres"):
                continue
            got = ours(np.random.RandomState(seed))
            want = ref(np.random.RandomState(seed))
            assert got.dtype == want.dtype == np.int64, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n", DURATIONS)
def test_samplers_equal_jax_on_the_global_rng(n):
    """The same draws from np.random, and the global state left where
    mofo_tpu leaves it (the next draw is the same)."""
    for seed in (0, 3):
        for name, ours, ref in _samplers(n):
            np.random.seed(seed)
            got = ours(None)
            after = np.random.randint(1 << 30)
            np.random.seed(seed)
            want = ref(None)
            assert np.random.randint(1 << 30) == after, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n", [20, 32, 40, 100])
def test_tsn_pin_seed_reseeds_the_global_rng(n):
    np.random.seed(123)
    got = sampling.tsn_frame_ids(n, pin_seed=True,
                                 rng=np.random.RandomState(5))
    after = np.random.rand()
    np.random.seed(456)
    want = jax_sampling.tsn_frame_ids(n, pin_seed=True)
    np.testing.assert_array_equal(got, want)
    assert np.random.rand() == after  # both left the state at seed(10)+draw


# --- the video reader ----------------------------------------------------


def test_native_library_loads_where_it_lies():
    assert video_reader.native_available()
    assert video_reader._LIB_PATH == os.path.abspath(
        jax_video_reader._LIB_PATH)


@pytest.mark.parametrize("backend", ["native", "opencv", "auto"])
def test_video_reader_frames_equal_jax(videos, backend):
    ids = [0, 3, 17, 17, 39, 5]
    path = str(videos / "a.mp4")
    with video_reader.VideoReader(path, backend=backend) as ours, \
            jax_video_reader.VideoReader(path, backend=backend) as ref:
        assert ours.backend == ref.backend
        assert len(ours) == len(ref) == 40
        assert ours.frame_size == ref.frame_size == (H, W)
        assert ours.get_avg_fps() == ref.get_avg_fps()
        got, want = ours.get_batch(ids), ref.get_batch(ids)
    assert got.dtype == np.uint8 and got.shape == (6, H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_scaled_decode_equals_jax(videos):
    path = str(videos / "c.mp4")
    with video_reader.VideoReader(path, width=32, height=24) as ours, \
            jax_video_reader.VideoReader(path, width=32, height=24) as ref:
        assert ours.frame_size == (24, 32)
        np.testing.assert_array_equal(ours.get_batch([0, 22, 1]),
                                      ref.get_batch([0, 22, 1]))


def test_reader_errors_are_the_references(videos):
    with pytest.raises(FileNotFoundError):
        video_reader.VideoReader(str(videos / "missing.mp4"))
    with video_reader.VideoReader(str(videos / "b.mp4"),
                                  backend="native") as vr:
        with pytest.raises(RuntimeError, match="native decode failed"):
            vr.get_batch([999])
    with pytest.raises(RuntimeError, match="native decoder failed"):
        video_reader.VideoReader(str(videos / "tiny.mp4"), backend="native")
    with pytest.raises(RuntimeError, match="opencv failed to open"):
        video_reader.VideoReader(str(videos / "tiny.mp4"), backend="opencv")


def test_without_the_library_auto_falls_back_to_cv2(videos, monkeypatch):
    """A library that does not load leaves the reader where mofo_tpu's
    failed build leaves it: native unavailable, auto through cv2."""
    monkeypatch.setattr(video_reader, "_LIB_PATH", str(videos / "none.so"))
    monkeypatch.setattr(video_reader, "_lib", None)
    monkeypatch.setattr(video_reader, "_lib_checked", False)
    assert not video_reader.native_available()
    with video_reader.VideoReader(str(videos / "d.mp4")) as vr:
        assert vr.backend == "opencv" and len(vr) == 33
        frames = vr.get_batch([2, 30])
    with jax_video_reader.VideoReader(str(videos / "d.mp4"),
                                      backend="opencv") as ref:
        np.testing.assert_array_equal(frames, ref.get_batch([2, 30]))
    with pytest.raises(RuntimeError, match="library unavailable"):
        video_reader.VideoReader(str(videos / "d.mp4"), backend="native")


# --- the datasets --------------------------------------------------------


def _pairs(videos, name="list.csv"):
    path = str(videos / name)
    return filelist.read_setting_file(path), jax_filelist.read_setting_file(
        path)


def _boxes(videos):
    path = str(videos / "boxes.json")
    return (filelist.MotionBoxIndex.from_file(path),
            jax_filelist.MotionBoxIndex.from_file(path))


def _check_dataset(ours, ref, seeds=(0, 5)):
    assert len(ours) == len(ref)
    for seed in seeds:
        np.random.seed(seed)
        got = [ours[i] for i in range(len(ours))]
        np.random.seed(seed)
        want = [ref[i] for i in range(len(ref))]
        for g, w in zip(got, want):
            _same_samples(g, w)
    return got


@pytest.mark.parametrize("sampling_rate,pin_seed", [(2, False), (4, False),
                                                    (2, True)])
def test_pretrain_dataset_equals_jax(videos, sampling_rate, pin_seed):
    entries, ref_entries = _pairs(videos)
    boxes, ref_boxes = _boxes(videos)
    kw = dict(num_frames=8, sampling_rate=sampling_rate, decode_size=(24, 32),
              pin_seed=pin_seed)
    got = _check_dataset(
        pipeline.PretrainClipDataset(entries, boxes=boxes, **kw),
        jax_pipeline.PretrainClipDataset(ref_entries, boxes=ref_boxes, **kw))
    assert got[0]["clip"].shape == (8, 24, 32, 3)
    assert got[0]["boxes"].shape == (8, 4)
    np.testing.assert_array_equal(got[3]["boxes"],  # d: no boxes
                                  np.tile([0, 0, 1, 1], (8, 1)))
    plain = pipeline.PretrainClipDataset(entries, **kw)[0]
    assert set(plain) == {"clip"}


@pytest.mark.parametrize("sampler", ["dense", "uniform"])
@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_finetune_dataset_equals_jax(videos, mode, sampler):
    entries, ref_entries = _pairs(videos)
    boxes, ref_boxes = _boxes(videos)
    kw = dict(mode=mode, sampler=sampler, num_frames=8, frame_sample_rate=2,
              decode_size=(H, W), test_num_segment=2, test_num_crop=3)
    got = _check_dataset(
        pipeline.FinetuneClipDataset(entries, boxes=boxes, **kw),
        jax_pipeline.FinetuneClipDataset(ref_entries, boxes=ref_boxes, **kw))
    n = len(entries) * (6 if mode == "test" else 1)
    assert len(got) == n
    # dense validation returns the whole strided enumeration (40 frames at
    # stride 2 -> 20), as mofo_tpu's does; every other mode one clip
    t = 20 if (mode, sampler) == ("validation", "dense") else 8
    assert got[0]["clip"].shape == (t, H, W, 3)


def test_test_mode_views_are_entry_major(videos):
    entries, _ = _pairs(videos)
    ds = pipeline.FinetuneClipDataset(entries, mode="test", num_frames=4,
                                      decode_size=(24, 32),
                                      test_num_segment=2, test_num_crop=3)
    tags = [tuple(int(ds[i][k]) for k in ("video_idx", "chunk_nb",
                                          "split_nb")) for i in range(len(ds))]
    assert tags == pipeline.expand_views(4, 2, 3)
    assert tags[:7] == [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0),
                        (0, 1, 1), (0, 1, 2), (1, 0, 0)]
    assert [int(ds[i]["label"]) for i in (0, 6, 23)] == [0, 1, 3]
    # the chunk picks another temporal window, the split keeps the frames
    np.testing.assert_array_equal(ds[0]["clip"], ds[2]["clip"])
    assert not np.array_equal(ds[0]["clip"], ds[3]["clip"])


@pytest.mark.parametrize("classtype", ["verb", "noun", "action"])
@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_epic_dataset_equals_jax(videos, mode, classtype):
    csvs = [str(videos / f"EPIC_100_{s}.csv")
            for s in ("train", "validation")]
    _, mapping, _ = filelist.epic_action_space(csvs)
    split = "train" if mode == "train" else "validation"
    csv = csvs[0] if mode == "train" else csvs[1]
    kw = dict(video_root=str(videos / "epic"), split=split, mode=mode,
              classtype=classtype, action_mapping=mapping, num_frames=8,
              decode_size=(24, 32))
    got = _check_dataset(
        epic.EpicClipDataset(filelist.read_epic_csv(csv), **kw),
        jax_epic.EpicClipDataset(jax_filelist.read_epic_csv(csv), **kw))
    if classtype == "action":
        assert int(got[0]["label"]) == mapping[
            "2:0" if mode != "train" else "3:10"]
    with pytest.raises(ValueError, match="needs action_mapping"):
        epic.EpicClipDataset([], "r", "train", classtype="action")


def test_a_bad_entry_is_resampled_as_mofo_tpu_does(videos):
    """Entries 1 (missing) and 2 (under 1 KB) are resampled from np.random:
    the same substitutes, the same printed lines, the same samples."""
    entries, ref_entries = _pairs(videos, "bad.csv")
    kw = dict(mode="validation", num_frames=4, decode_size=(24, 32))
    ours = pipeline.FinetuneClipDataset(entries, **kw)
    ref = jax_pipeline.FinetuneClipDataset(ref_entries, **kw)
    for seed in (0, 1, 2):
        outs = []
        for ds in (ours, ref):
            text = io.StringIO()
            np.random.seed(seed)
            with contextlib.redirect_stdout(text):
                samples = [ds[i] for i in range(4)]
            outs.append((samples, text.getvalue()))
        for g, w in zip(outs[0][0], outs[1][0]):
            _same_samples(g, w)
        assert outs[0][1] == outs[1][1]
        assert outs[0][1].count("not loadable; resampling index") >= 2
    assert pipeline._entry_loadable(entries[0].path)
    assert not pipeline._entry_loadable(entries[1].path)
    assert not pipeline._entry_loadable(entries[2].path)


def test_the_reader_field_reaches_every_open(videos):
    entries, _ = _pairs(videos)
    ds = pipeline.PretrainClipDataset(entries, num_frames=4, sampling_rate=1,
                                      decode_size=(6, 8),
                                      reader=MemoryReader)
    np.random.seed(0)
    sample = ds[1]
    assert sample["clip"].shape == (4, 6, 8, 3)
    np.random.seed(0)
    ids = sampling.tsn_frame_ids(len(MemoryReader(entries[1].path)),
                                 skip_length=4, new_step=1, rng=np.random)
    np.testing.assert_array_equal(frame_ids(sample["clip"]), ids)
    assert pipeline._entry_loadable(entries[1].path, MemoryReader)


def test_memory_reader_frames_have_no_flat_patch():
    """MemoryReader's gradient and square both carry a texture, so no 16 x
    16 window of a frame, the square's included, is flat: the bf16
    normalized targets of a near-flat patch blow up (ROADMAP Queue 3), and
    the checks on the card hold the bf16 pretrain loss on these frames
    against f32."""
    for name in ("v0.mp4", "v7.mp4", "video_3.mp4"):
        video = MemoryReader(name, width=320, height=256)
        frames = video.get_batch([0, 2, len(video) - 1]).astype(np.float32)
        x1, y1, x2, y2 = video.box(2)
        assert frames[1, y1:y2, x1:x2].min() < 255
        windows = frames[:, :256, :320].reshape(3, 16, 16, 20, 16, 3)
        assert windows.std(axis=(2, 4)).min() > 10


@pytest.mark.parametrize("make", ["validation", "test", "pretrain_pinned",
                                  "array_reader"])
def test_thread_workers_equal_the_serial_fetch(videos, make):
    """Deterministic datasets (their ids draw nothing, or reseed): thread
    workers give the serial fetch's batches, the padded last one too."""
    entries, _ = _pairs(videos)
    boxes, _ = _boxes(videos)
    ds = {
        "validation": lambda: pipeline.FinetuneClipDataset(
            entries, mode="validation", num_frames=4, decode_size=(24, 32),
            boxes=boxes),
        "test": lambda: pipeline.FinetuneClipDataset(
            entries[:2], mode="test", sampler="dense", num_frames=4,
            decode_size=(24, 32)),
        "pretrain_pinned": lambda: pipeline.PretrainClipDataset(
            entries, num_frames=4, decode_size=(24, 32), boxes=boxes,
            pin_seed=True),
        "array_reader": lambda: pipeline.FinetuneClipDataset(
            entries, mode="validation", num_frames=4, decode_size=(6, 8),
            reader=MemoryReader),
    }[make]()
    serial = list(pipeline.PrefetchLoader(ds, 3, device="cpu",
                                          drop_last=False))
    pooled = list(pipeline.PrefetchLoader(ds, 3, device="cpu",
                                          drop_last=False, num_workers=2))
    assert len(serial) == len(pooled) == -(-len(ds) // 3)
    for a, b in zip(serial, pooled):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_thread_workers_draw_from_the_one_global_rng(videos):
    """The threads share the process's np.random, as the serial fetch does:
    after a seed, the two samples of a one-entry dataset listed twice are
    the first and the second draw, in the order the threads took them."""
    entries, _ = _pairs(videos)
    ds = pipeline.FinetuneClipDataset(entries[:1] * 2, mode="train",
                                      num_frames=8, decode_size=(6, 8),
                                      reader=MemoryReader)
    np.random.seed(11)
    first, second = ds[0]["clip"], ds[0]["clip"]
    assert not np.array_equal(first, second)
    np.random.seed(11)
    (batch,) = list(pipeline.PrefetchLoader(ds, 2, device="cpu",
                                            num_workers=2))
    rows = [r.numpy() for r in batch["clip"]]
    assert any(all(np.array_equal(r, w) for r, w in zip(rows, want))
               for want in ((first, second), (second, first)))


def test_boxes_from_a_json_map_through_the_crop_as_in_jax(videos):
    """Boxes stay in decode space in the dataset; pretrain_augment maps
    them through the crop on the decoded frames as mofo_tpu does."""
    entries, ref_entries = _pairs(videos)
    boxes, ref_boxes = _boxes(videos)
    kw = dict(num_frames=4, sampling_rate=2, decode_size=(H, W))
    np.random.seed(2)
    ours = pipeline.collate([pipeline.PretrainClipDataset(
        entries, boxes=boxes, **kw)[i] for i in range(3)])
    np.random.seed(2)
    ref = jax_pipeline.collate([jax_pipeline.PretrainClipDataset(
        ref_entries, boxes=ref_boxes, **kw)[i] for i in range(3)])
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    key = jax.random.PRNGKey(4)
    want, want_boxes = jax_augment.pretrain_augment(
        key, jnp.asarray(ref["clip"]), out_size=32,
        boxes=jnp.asarray(ref["boxes"]))
    n_pairs = len(jax_image._msc_size_pairs(H, 32))
    r_pair, r_off = jax.random.split(key)
    got, got_boxes = augment.pretrain_augment(
        None, torch.from_numpy(ours["clip"]), out_size=32,
        boxes=torch.from_numpy(ours["boxes"]),
        pair_idx=torch.from_numpy(np.array(jax.random.randint(
            r_pair, (3,), 0, n_pairs))),
        off_idx=torch.from_numpy(np.array(jax.random.randint(
            r_off, (3,), 0, 13))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(want_boxes))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_near_flat_patch_targets_match_mofo_tpu(dtype):
    """A white patch with three greyer pixels, as a saturated region of a
    real clip gives: the normalized targets equal mofo_tpu's in both dtypes.
    In bf16 both packages sum bf16-rounded squares, so the variance cancels
    to 0 while the deviations do not, and the targets reach ~3e4 where f32
    gives ~13 (ROADMAP Queue 3: a reference behaviour, matched)."""
    from mofo_tpu.ops import patchify as jax_patchify
    from mofo_tpu_torch.core import constants
    from mofo_tpu_torch.ops import patchify

    pix = np.ones((512, 3))
    pix[:3] = 0.97
    row = ((pix - np.array(constants.IMAGENET_DEFAULT_MEAN))
           / np.array(constants.IMAGENET_DEFAULT_STD)).reshape(1, 1, 1536)
    row = row.astype(np.float32)
    got = patchify.normalize_patch_rows(
        torch.from_numpy(row).to(getattr(torch, dtype)),
        compute_dtype=getattr(torch, dtype)).float().numpy()
    want = np.asarray(jax_patchify.normalize_patch_rows(
        jnp.asarray(row).astype(dtype), compute_dtype=getattr(jnp, dtype)),
        np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 1e4 if dtype == "bfloat16" else np.abs(
        got).max() < 20
