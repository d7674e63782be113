"""The port's runners and tools on real clips, with --device cpu and the tiny
models, against the JAX package: small mp4 files that cv2 writes here (64x48,
12-16 frames), setting files, a motion-box JSON and EPIC_100-shaped CSVs.

- pretrain_mofo with --data_path --bb_json, its dataset equal to the one
  mofo_tpu's CLI builds from the same flags; tube_bb without --bb_json
  exits, a missing setting file fails as mofo_tpu's reader fails;
- finetune: the sampler per --data_set (dense for Kinetics-400, UCF101 and
  HMDB51, uniform otherwise), the --val_path / --test_path fallbacks, the
  SSV2 BB-focused and the Kinetics runs end to end, the BB-focused model
  without --bb_json exiting, EK-100 with --classtype action and its
  marginalized line;
- the final test on --synthetic clips: one view per clip, mofo_tpu's views,
  per-view logits within 1e-5 (f32), Acc@1 and Acc@5;
- feature_extract's features within 1e-5 of mofo_tpu's on the same .pth;
- bb_stats and data_clean: mofo_tpu's outputs.
"""

import contextlib
import io
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from mofo_tpu.cli import bb_stats as jax_bb_stats
from mofo_tpu.cli import data_clean as jax_data_clean
from mofo_tpu.cli import feature_extract as jax_feature_extract
from mofo_tpu.cli import finetune as jax_finetune
from mofo_tpu.data import filelist as jax_filelist
from mofo_tpu.data import pipeline as jax_pipeline
from mofo_tpu.eval import multiview as jax_mv
from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.parallel import mesh as jax_mesh
from mofo_tpu.train.checkpoint import import_torch_finetune
from mofo_tpu_torch.cli import bb_stats, data_clean, feature_extract
from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.data.epic import EpicClipDataset
from mofo_tpu_torch.data.video_reader import VideoReader
from mofo_tpu_torch.models import create_model

W, H = 64, 48
FRAMES = [12, 14, 16, 13, 15, 16]  # at most 16: a dense validation clip of
# 4 frames at stride 4 (the whole stride enumeration) stays 4 frames long
COMMON = ["--input_size", "32", "--num_frames", "4", "--batch_size", "2",
          "--epochs", "1", "--warmup_epochs", "0", "--decode_height",
          str(H), "--decode_width", str(W), "--dtype", "float32",
          "--device", "cpu"]
PRETRAIN = ["--model", "pretrain_videomae_tiny_debug", "--decoder_depth",
            "1"] + COMMON
FINETUNE = ["--nb_classes", "3", "--aa", "rand-m7-n1-mstd0.5-inc1",
            "--drop_path", "0.0", "--test_num_crop", "3"] + COMMON


def _write_video(path, n, seed):
    rng = np.random.RandomState(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (W, H))
    base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    for i in range(n):
        frame = np.roll(base, 2 * i, axis=1)
        frame[: 3 + i % 7] = (i * 11) % 255
        w.write(frame)
    w.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six videos, train / val / test setting files over them, a box JSON
    with one box per frame, an EPIC_100 root with its two CSVs."""
    root = tmp_path_factory.mktemp("real")
    paths = []
    for i, n in enumerate(FRAMES):
        paths.append(root / f"v{i}.mp4")
        _write_video(paths[-1], n, i)
    lines = [f"{p} {n} {i % 3}" for i, (p, n) in enumerate(zip(paths,
                                                              FRAMES))]
    (root / "train.csv").write_text("\n".join(lines) + "\n")
    (root / "val.csv").write_text("\n".join(lines[:4]) + "\n")
    (root / "test.csv").write_text("\n".join(lines[4:]) + "\n")
    rng = np.random.RandomState(1)
    boxes = {}
    for i, n in enumerate(FRAMES):
        frames = []
        for _ in range(n):
            x1, y1 = rng.randint(0, W // 2), rng.randint(0, H // 2)
            frames.append({"labels": [{"box2d": {
                "x1": float(x1), "y1": float(y1),
                "x2": float(x1 + rng.randint(6, W // 2)),
                "y2": float(y1 + rng.randint(6, H // 2))},
                "gt_annotation": "motion"}]})
        boxes[f"v{i}"] = frames
    (root / "Unsupervised_BB_SSV2_train.json").write_text(json.dumps(boxes))
    header = ("narration_id,participant_id,video_id,narration_timestamp,"
              "start_timestamp,stop_timestamp,start_frame,stop_frame,"
              "narration,verb,verb_class,noun,noun_class,all_nouns,"
              "all_noun_classes")
    vn = {"train": [(0, 1), (2, 0), (1, 1), (0, 0)],
          "validation": [(2, 0), (0, 1), (1, 2)]}
    for split, pairs in vn.items():
        rows = [header]
        os.makedirs(root / "epic" / split)
        for i, (verb, noun) in enumerate(pairs):
            _write_video(root / "epic" / split / f"video_{i}.mp4", 12 + i,
                         20 + i)
            rows.append(f"P01_{i},P01,P01_10{i},00:00:01.00,00:00:01.00,"
                        f"00:00:02.00,1,30,cut it,cut,{verb},it,{noun},"
                        f"\"['it']\",[{noun}]")
        (root / f"EPIC_100_{split}.csv").write_text("\n".join(rows) + "\n")
    return root


def _same_samples(ours, ref, seed=0):
    assert len(ours) == len(ref)
    np.random.seed(seed)
    got = [ours[i] for i in range(len(ours))]
    np.random.seed(seed)
    want = [ref[i] for i in range(len(ref))]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _lines(text, prefix):
    return [x for x in text.splitlines() if x.startswith(prefix)]


# --- pretraining ---------------------------------------------------------


def test_pretrain_cli_reads_the_setting_file_and_the_boxes(data, tmp_path,
                                                           capsys):
    argv = PRETRAIN + ["--data_path", str(data / "train.csv"), "--bb_json",
                       str(data / "Unsupervised_BB_SSV2_train.json")]
    args = PT.get_args(argv, mofo_defaults=True)
    ds = PT.build_dataset(args, PT.build_config(args))
    # the dataset mofo_tpu/cli/pretrain.py:174-189 builds from these flags
    ref = jax_pipeline.PretrainClipDataset(
        entries=jax_filelist.read_setting_file(str(data / "train.csv")),
        num_frames=4, sampling_rate=2, decode_size=(H, W),
        boxes=jax_filelist.MotionBoxIndex.from_file(
            str(data / "Unsupervised_BB_SSV2_train.json")))
    assert ds.boxes is not None and ds.sampling_rate == 2
    _same_samples(ds, ref)
    state = PT.main(PT.get_args(argv + ["--output_dir", str(tmp_path)],
                                mofo_defaults=True))
    assert state.step == 3  # 6 clips at B=2
    (line,) = [json.loads(x) for x in
               (tmp_path / "log.txt").read_text().splitlines()]
    assert line["epoch"] == 0 and np.isfinite(line["train_loss"])
    assert "tube_bb" in capsys.readouterr().out


def test_tube_bb_without_bb_json_exits_as_mofo_tpu_does(data):
    args = PT.get_args(PRETRAIN + ["--data_path", str(data / "train.csv")],
                       mofo_defaults=True)
    with pytest.raises(SystemExit, match="tube_bb requires --bb_json"):
        PT.main(args)
    # tube masks need no boxes: the dataset carries none
    args = PT.get_args(PRETRAIN + ["--data_path", str(data / "train.csv")])
    ds = PT.build_dataset(args, PT.build_config(args))
    assert ds.boxes is None and set(ds[0]) == {"clip"}


def test_a_missing_setting_file_fails_as_mofo_tpu_does(tmp_path):
    path = str(tmp_path / "train.csv")
    with pytest.raises(RuntimeError) as ref:
        jax_filelist.read_setting_file(path)
    with pytest.raises(RuntimeError) as ours:
        PT.main(PT.get_args(PRETRAIN + ["--data_path", path]))
    assert str(ours.value) == str(ref.value)
    assert "Setting file" in str(ours.value)


# --- finetuning ----------------------------------------------------------


def _ft_args(data, *flags, bb=False):
    return FT.get_args(FINETUNE + list(flags), bb_defaults=bb)


@pytest.mark.parametrize("data_set,sampler", [
    ("SSV2", "uniform"), ("Kinetics-400", "dense"), ("UCF101", "dense"),
    ("HMDB51", "dense")])
def test_the_sampler_follows_the_data_set_as_in_mofo_tpu(data, data_set,
                                                         sampler):
    """Each dataset as mofo_tpu/cli/finetune.py:236-322 builds it from the
    same flags: the same samples; validation falls back to the train list,
    test to validation."""
    args = _ft_args(data, "--data_set", data_set, "--data_path",
                    str(data / "train.csv"), "--val_path",
                    str(data / "val.csv"), "--sampling_rate", "3")
    train, val, test, _, action_to_vn = FT.build_datasets(
        args, FT.build_config(args), False, print)
    assert action_to_vn is None
    assert [d.mode for d in (train, val, test)] == ["train", "validation",
                                                    "test"]
    ref_entries = {n: jax_filelist.read_setting_file(str(data / n))
                   for n in ("train.csv", "val.csv")}
    for ds, mode, name in ((train, "train", "train.csv"),
                           (val, "validation", "val.csv"),
                           (test, "test", "val.csv")):
        assert ds.sampler == sampler and ds.frame_sample_rate == 3
        ref = jax_pipeline.FinetuneClipDataset(
            entries=ref_entries[name], mode=mode, sampler=sampler,
            num_frames=4, frame_sample_rate=3, decode_size=(H, W))
        _same_samples(ds, ref, seed=4)
    args = _ft_args(data, "--data_set", data_set, "--data_path",
                    str(data / "train.csv"))
    _, val, test, _, _ = FT.build_datasets(args, FT.build_config(args),
                                           False, print)
    assert len(val) == 6 and len(test) == 36


def _count_eval_calls(monkeypatch):
    calls = []
    make = FT.make_eval_step

    def counting(*a, **k):
        fn = make(*a, **k)

        def eval_fn(batch):
            calls.append(int(batch["clip"].shape[0]))
            return fn(batch)
        return eval_fn

    monkeypatch.setattr(FT, "make_eval_step", counting)
    return calls


def test_ssv2_bb_focused_run_on_real_clips(data, tmp_path, capsys,
                                           monkeypatch):
    """The BB-focused runner on the clips and their boxes; the final test
    over the test list's 2 x 3 entry-major views: one eval call per spatial
    window present in a batch."""
    calls = _count_eval_calls(monkeypatch)
    args = _ft_args(
        data, "--model", "vit_tiny_debug_BB_focused", "--data_path",
        str(data / "train.csv"), "--val_path", str(data / "val.csv"),
        "--test_path", str(data / "test.csv"), "--bb_json",
        str(data / "Unsupervised_BB_SSV2_train.json"), "--output_dir",
        str(tmp_path), bb=True)
    state = FT.main(args)
    assert state.step == 3
    text = capsys.readouterr().out
    assert len(_lines(text, "Final test: Acc@1")) == 1
    # validation: 4 clips at B=2; test: 12 views at B=2, entry-major, so
    # each batch holds two spatial windows
    assert calls == [2, 2] + [1] * 12
    (line,) = [json.loads(x) for x in
               (tmp_path / "log.txt").read_text().splitlines()]
    assert np.isfinite(line["train_loss"]) and "val_acc1" in line


def test_kinetics_run_on_real_clips(data, capsys):
    FT.main(_ft_args(data, "--model", "vit_tiny_debug", "--data_set",
                     "Kinetics-400", "--data_path", str(data / "train.csv"),
                     "--test_path", str(data / "test.csv")))
    assert len(_lines(capsys.readouterr().out, "Final test: Acc@1")) == 1


def test_bb_focused_without_bb_json_exits_unless_synthetic(data):
    args = _ft_args(data, "--data_path", str(data / "train.csv"), bb=True)
    with pytest.raises(SystemExit, match="BB-focused model requires"):
        FT.build_datasets(args, FT.build_config(args), True, print)
    args = _ft_args(data, "--synthetic", "3", bb=True)
    train, _, _, _, _ = FT.build_datasets(args, FT.build_config(args), True,
                                          print)
    assert "boxes" in train[0]


def _ek_args(data, classtype, *flags):
    return _ft_args(data, "--model", "vit_tiny_debug", "--data_set", "EK100",
                    "--data_path", str(data / "EPIC_100_train.csv"),
                    "--val_path", str(data / "EPIC_100_validation.csv"),
                    "--data_root", str(data / "epic"), "--classtype",
                    classtype, *flags)


def test_ek100_datasets_equal_mofo_tpus(data):
    args = _ek_args(data, "noun")
    cfg = FT.build_config(args)
    train, val, test, cfg2, action_to_vn = FT.build_datasets(args, cfg,
                                                             False, print)
    assert cfg2 is cfg and action_to_vn is not None
    for ds, split, mode in ((train, "train", "train"),
                            (val, "validation", "validation"),
                            (test, "validation", "test")):
        assert isinstance(ds, EpicClipDataset) and ds.classtype == "noun"
        assert (ds.split, ds.mode) == (split, mode)
    args = _ek_args(data, "action")
    _, _, _, cfg, action_to_vn = FT.build_datasets(
        args, FT.build_config(args), False, print)
    csvs = [str(data / f"EPIC_100_{s}.csv") for s in ("train", "validation")]
    vn_list, _, ref_vn = jax_filelist.epic_action_space(csvs)
    assert cfg.nb_classes == len(vn_list) == 5
    assert action_to_vn == ref_vn


def test_ek100_action_run_prints_the_marginalized_accuracies(
        data, capsys, monkeypatch):
    """The printed verb / noun accuracies are mofo_tpu's marginalization
    (eval/multiview.py) of the same view scores."""
    kept = []
    monkeypatch.setattr(FT, "gather_across_processes",
                        lambda agg: kept.append(agg) or agg)
    FT.main(_ek_args(data, "action"))
    text = capsys.readouterr().out
    assert "nb_classes -> 5 (EK action space)" in text
    (line,) = _lines(text, "Final test (EK marginalized): ")
    csvs = [str(data / f"EPIC_100_{s}.csv") for s in ("train", "validation")]
    _, _, action_to_vn = jax_filelist.epic_action_space(csvs)
    feats, labels = kept[0].merge_feats()
    assert len(feats) == 3  # the validation videos, 6 views each
    probs = np.stack([feats[v] for v in feats])
    lab = np.array([labels[v] for v in feats])
    want = []
    for col, mode in enumerate(("verb", "noun")):
        marg = jax_mv.marginalize(
            probs, jax_mv.get_marginal_indexes(action_to_vn, mode))
        true = np.array([action_to_vn[a][col] for a in lab])
        want.append(float(np.mean(np.argmax(marg, 1) == true)) * 100.0)
    assert line == (f"Final test (EK marginalized): verb {want[0]:.2f} "
                    f"noun {want[1]:.2f}")
    # a verb label space has no action classes to marginalize
    FT.main(_ek_args(data, "verb"))
    assert not _lines(capsys.readouterr().out, "Final test (EK")


# --- the synthetic final test (the repaired fault) -----------------------


def test_synthetic_final_test_scores_one_view_per_clip_as_mofo_tpu(
        monkeypatch):
    """On --synthetic clips mofo_tpu tests the plain clips, one view each
    through window 0 (mofo_tpu/cli/finetune.py:257-260). The port's
    final_test on the same weights and clips: the same views, per-view
    logits within 1e-5 (f32), the same Acc@1 and Acc@5."""
    argv = ["--model", "vit_tiny_debug", "--synthetic", "5",
            "--batch_size", "2", "--input_size", "32", "--num_frames", "4",
            "--nb_classes", "3", "--decode_height", "48", "--decode_width",
            "64", "--dtype", "float32"]
    args = FT.get_args(argv + ["--device", "cpu"])
    cfg = FT.build_config(args)
    _, _, test_ds, cfg, _ = FT.build_datasets(args, cfg, False, print)
    model = create_model("vit_tiny_debug", device="cpu", img_size=32,
                         all_frames=4, num_classes=3, init_scale=1.0, seed=3)
    kept = {}
    monkeypatch.setattr(FT, "gather_across_processes",
                        lambda agg: kept.setdefault("port", agg))
    monkeypatch.setattr(jax_mv, "gather_across_processes",
                        lambda agg: kept.setdefault("jax", agg))
    ours = FT.final_test(model, test_ds, cfg, False, print,
                         torch.device("cpu"))

    jargs = jax_finetune.get_args(argv)
    jcfg = jax_finetune.build_config(jargs)
    jmodel = jax_create_model("vit_tiny_debug", img_size=32, all_frames=4,
                              num_classes=3)
    params = import_torch_finetune({"model": model.state_dict()})
    ref_ds = jax_pipeline.SyntheticClipDataset(
        n=5, num_frames=4, decode_size=(48, 64), num_classes=3)
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(1, 1, 1),
                               jax.devices()[:1])
    ref = jax_finetune.final_test(jmodel, params, ref_ds, jcfg, mesh, False,
                                  print, 2)
    rows = {k: sorted(agg._rows, key=lambda r: (int(r[0]), r[1], r[2]))
            for k, agg in kept.items()}
    assert len(rows["port"]) == len(rows["jax"]) == 5
    for a, b in zip(rows["port"], rows["jax"]):
        assert (int(a[0]), a[1], a[2], a[4]) == (int(b[0]), b[1], b[2], b[4])
        assert (a[1], a[2]) == (0, 0)
        np.testing.assert_allclose(a[3], b[3], atol=1e-5, rtol=0)
    assert ours == pytest.approx(ref, abs=1e-9)


# --- feature extraction --------------------------------------------------


@pytest.mark.parametrize("batch_size", [2, 3])
def test_feature_extract_equals_mofo_tpu(data, tmp_path, batch_size):
    """The same .pth (a port classifier checkpoint) through both: features
    within 1e-5. mofo_tpu keeps the rows that pad the last batch; the port
    writes one row per video, mofo_tpu's first rows."""
    model = create_model("vit_tiny_debug", device="cpu", img_size=32,
                         all_frames=4, num_classes=3, seed=5)
    pth = tmp_path / "ft.pth"
    torch.save({"model": model.state_dict()}, pth)
    argv = ["--data_path", str(data / "val.csv"), "--model_path", str(pth),
            "--model", "vit_tiny_debug", "--input_size", "32",
            "--num_frames", "4", "--batch_size", str(batch_size)]
    ours = feature_extract.main(feature_extract.get_args(
        argv + ["--output", str(tmp_path / "a.npy"), "--device", "cpu"]))
    ref = jax_feature_extract.main(jax_feature_extract.get_args(
        argv + ["--output", str(tmp_path / "b.npy")]))
    assert ours.shape == (4, 64)
    assert ref.shape[0] == -(-4 // batch_size) * batch_size
    np.testing.assert_allclose(ours, ref[:4], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), ours)
    # one video file in place of a list
    one = feature_extract.main(feature_extract.get_args(
        argv[2:] + ["--data_path", str(data / "v1.mp4"), "--output",
                    str(tmp_path / "c.npy"), "--device", "cpu"]))
    np.testing.assert_allclose(one[0], ours[1], atol=1e-6, rtol=0)


def test_feature_extract_reads_pth_only(tmp_path, data):
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(ValueError, match="orbax"):
        feature_extract.main(feature_extract.get_args([
            "--data_path", str(data / "val.csv"), "--model_path",
            str(tmp_path / "orbax"), "--model", "vit_tiny_debug",
            "--input_size", "32", "--num_frames", "4", "--device", "cpu"]))


def test_as_encoder_strips_the_references_prefixes():
    sd = {"backbone.blocks.0.norm1.weight": 1, "encoder.norm.bias": 2,
          "fc_norm.weight": 3}
    assert feature_extract.as_encoder(sd) == {
        "encoder.blocks.0.norm1.weight": 1, "encoder.norm.bias": 2,
        "encoder.fc_norm.weight": 3}


# --- the data tools ------------------------------------------------------


def _quiet(fn, *a):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = fn(*a)
    return out, text.getvalue()


def test_bb_stats_equals_mofo_tpu(data):
    argv = ["--bb_json", str(data / "Unsupervised_BB_SSV2_train.json"),
            "--height", str(H), "--width", str(W)]
    ours = _quiet(bb_stats.main, bb_stats.get_args(argv))
    ref = _quiet(jax_bb_stats.main, jax_bb_stats.get_args(argv))
    assert ours == ref
    assert ours[0][0] > 0 and len(ours[0][1]) == 6


def test_data_clean_equals_mofo_tpu(data, tmp_path):
    """--validate_only over good, tiny and garbage files, then the re-encode
    to a 24-pixel short side: the same counts, lines and decoded frames."""
    src = tmp_path / "src"
    src.mkdir()
    for i in (0, 1):
        (src / f"v{i}.mp4").write_bytes((data / f"v{i}.mp4").read_bytes())
    (src / "tiny.mp4").write_bytes(b"\0" * 64)
    (src / "junk.avi").write_bytes(os.urandom(4096))
    (src / "notes.txt").write_text("not a video")
    outs = []
    for mod, dst in ((data_clean, "ours"), (jax_data_clean, "ref")):
        checked = _quiet(mod.main, mod.get_args(["--src_dir", str(src),
                                                 "--validate_only"]))
        made = _quiet(mod.main, mod.get_args([
            "--src_dir", str(src), "--dst_dir", str(tmp_path / dst),
            "--short_side", "24"]))
        outs.append((checked, made))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0][0][0] == 2
    (good, bad), text = outs[0][1]
    assert (good, len(bad)) == (2, 2) and text.count("BAD ") == 2
    assert outs[1][1][0][0] == good
    assert sorted(outs[1][1][0][1]) == sorted(bad)
    for i in (0, 1):
        with VideoReader(str(tmp_path / "ours" / f"v{i}.mp4")) as a, \
                VideoReader(str(tmp_path / "ref" / f"v{i}.mp4")) as b:
            assert a.frame_size == (24, 32) and len(a) == len(b) == FRAMES[i]
            np.testing.assert_array_equal(a.get_batch(range(len(a))),
                                          b.get_batch(range(len(b))))
    assert data_clean.validate(str(tmp_path / "ours" / "v0.mp4"))
    assert not data_clean.validate(str(src / "junk.avi"))
