"""The runners with W = 2 processes on the CPU (gloo), spawned as
tests/torch_ddp_worker.py: cli.pretrain_mofo (2 epochs, then auto-resumed
for a third) and cli.finetune_mofo (validation and the final multi-view
test). Rank 0 alone prints, writes log.txt and saves; the loss lines equal
one process at twice the batch fed the same global batches (its sampler
yields the two ranks' batches side by side). And the mesh flags: resolved
as mofo_tpu resolves them, refused where it refuses them.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from mofo_tpu_torch.cli import finetune as FT
from mofo_tpu_torch.cli import finetune_mofo, pretrain_mofo
from mofo_tpu_torch.cli import pretrain as PT
from mofo_tpu_torch.data import pipeline as P


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


WORLD = 2
B = 2  # per rank
SHARDED = P.ShardedSampler


def _log(out: str) -> list:
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


class _GlobalOrder(SHARDED):
    """One process's sampler that yields, batch by batch, the WORLD ranks'
    batches of B side by side: the global batches G' of the ranks' run."""

    def indices(self) -> np.ndarray:
        shards = []
        for r in range(WORLD):
            s = SHARDED(self.n, r, WORLD, self.shuffle, self.seed)
            s.set_epoch(self.epoch)
            shards.append(s.indices())
        return np.concatenate([shard[b * B:(b + 1) * B]
                               for b in range(len(shards[0]) // B)
                               for shard in shards])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli"))
    W.wait(W.spawn("cli", WORLD, out))
    return out, [torch.load(os.path.join(out, f"cli-{r}.pt"))
                 for r in range(WORLD)]


def _one_process(monkeypatch, argv, cli, **defaults):
    monkeypatch.setattr(P, "ShardedSampler", _GlobalOrder)
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(cli.get_args(argv, **defaults))


def test_pretrain_runner_two_ranks(ranks, tmp_path, monkeypatch):
    out, printed = ranks
    pt = os.path.join(out, "pt")
    log = _log(pt)
    assert [line["epoch"] for line in log] == [0, 1, 2]
    assert sorted(os.listdir(pt)) == [f"checkpoint-{e}.pth"
                                      for e in range(3)] + ["log.txt"]
    assert "Epoch: [1]" in printed[0]["pretrain"]
    assert printed[0]["resume"].count("auto-resumed at epoch 2") == 1
    assert all(text == "" for text in printed[1].values())
    ckpt = torch.load(os.path.join(pt, "checkpoint-2.pth"),
                      weights_only=True)
    assert ckpt["step"] == 6
    assert not any(n.startswith("module.") for n in ckpt["model"])
    one = str(tmp_path / "one")
    _one_process(monkeypatch, W.pretrain_argv(one, WORLD * B),
                 pretrain_mofo, mofo_defaults=True)
    want = _log(one)
    np.testing.assert_allclose([x["train_loss"] for x in log[:2]],
                               [x["train_loss"] for x in want], rtol=1e-6)
    np.testing.assert_allclose([x["train_grad_norm"] for x in log[:2]],
                               [x["train_grad_norm"] for x in want],
                               rtol=1e-6)
    assert [x["train_lr"] for x in log[:2]] == [x["train_lr"] for x in want]


def test_finetune_runner_two_ranks(ranks, tmp_path, monkeypatch):
    out, printed = ranks
    ft = os.path.join(out, "ft")
    log = _log(ft)
    assert [line["epoch"] for line in log] == [0, 1]
    assert sorted(os.listdir(ft)) == ["checkpoint-1.pth",
                                      "checkpoint-best.pth", "log.txt"]
    assert printed[0]["finetune"].count("Final test: Acc@1") == 1
    assert printed[1]["finetune"] == ""
    one = str(tmp_path / "one")
    _one_process(monkeypatch, W.finetune_argv(one, WORLD * B),
                 finetune_mofo, bb_defaults=True)
    want = _log(one)
    for key in ("train_loss", "train_grad_norm", "val_loss"):
        np.testing.assert_allclose([x[key] for x in log],
                                   [x[key] for x in want], rtol=1e-6,
                                   err_msg=key)
    for key in ("val_acc1", "val_acc5", "step"):
        assert [x[key] for x in log] == [x[key] for x in want], key


@pytest.mark.parametrize("cli", [PT, FT])
@pytest.mark.parametrize("flags,world,error,match", [
    (["--mesh_fsdp", "2"], 2, None, (1, 2, 1)),
    (["--mesh_model", "2"], 1, ValueError,
     r"1 devices not divisible by fsdp\*model=2"),
    (["--mesh_data", "2"], 1, ValueError, "--mesh_data 2 with 1"),
    (["--mesh_data", "1"], 2, ValueError, "--mesh_data 1 with 2"),
    (["--mesh_data", "2"], 2, None, None),
    (["--mesh_data", "-1"], 3, None, None),
])
def test_mesh_flags(cli, flags, world, error, match):
    """The --mesh_* flags resolve as mofo_tpu's MeshConfig.resolve at the
    world size (`match` the resolved shape where they do), and raise
    ValueError with its condition where it refuses them."""
    args = cli.get_args(flags)
    if error is None:
        assert cli.build_config(args, world).batch_size == args.batch_size
        if match is not None:
            assert PT.resolve_mesh(args, world) == match
        return
    with pytest.raises(error, match=match):
        cli.build_config(args, world)
