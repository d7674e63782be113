"""The factory's TV-L1 under a memory budget, on the CPU.

- cli.motion_factory.video_flows splits a video's pairs into consecutive
  chunks of at most pairs_per_call(H, W, budget) pairs, one batched
  tvl1_flow_batch call a chunk: under a budget of 2 pairs (3 chunks of a
  6-frame video) the flows are bit-equal to the one-call path, and
  process_video gives the same boxes;
- (slow) one 256 x 320 pair with a rigid shift against mofo_tpu's
  tvl1_flow, within tests/test_torch_factory.py's 1e-3 px max and 1e-4 p99:
  the factory's working size, held on rigid motion. It takes minutes on one
  CPU core, so Tier-1, which deselects `slow`, does not run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mofo_tpu.factory import flow as j_flow
from mofo_tpu_torch.cli import motion_factory
from mofo_tpu_torch.factory import flow


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


H, W = 32, 40


def _clip(n=6, seed=5):
    """n colour uint8 frames of a smoothed texture moving (2, 1) px a
    frame."""
    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(H + 2 * n, W + 2 * n, 3), (2, 2, 0))
    frames = np.stack([base[i:i + H, 2 * i:2 * i + W] for i in range(n)])
    return (frames * 255).astype(np.uint8)


def _args():
    return motion_factory.get_args(["--data_path", "unused.mp4", "--output",
                                    "unused", "--device", "cpu"])


def test_pairs_per_call_follows_the_budget():
    pair = motion_factory.PAIR_BYTES_PER_PIXEL * H * W
    assert motion_factory.pairs_per_call(H, W, 3 * pair) == 3
    assert motion_factory.pairs_per_call(H, W, 3 * pair + pair - 1) == 3
    assert motion_factory.pairs_per_call(H, W, 0) == 1  # never below one
    assert motion_factory.flow_budget(torch.device("cpu")) == \
        motion_factory.CPU_FLOW_BUDGET
    # 1080p under the host's cap: 3 pairs a call
    assert motion_factory.pairs_per_call(
        1080, 1920, motion_factory.CPU_FLOW_BUDGET) == 3


def test_chunked_flows_equal_one_call(monkeypatch):
    frames = _clip()
    calls = []
    real = flow.tvl1_flow_batch

    def batch(x, **kw):
        calls.append(len(x))
        return real(x, **kw)

    monkeypatch.setattr(motion_factory.flow, "tvl1_flow_batch", batch)
    one = motion_factory.video_flows(frames, _args(), torch.device("cpu"))
    assert calls == [6]
    calls.clear()
    budget = 2 * motion_factory.PAIR_BYTES_PER_PIXEL * H * W
    chunked = motion_factory.video_flows(frames, _args(),
                                         torch.device("cpu"), budget=budget)
    assert calls == [3, 3, 2]  # the frames of pairs 0-1, 2-3 and 4
    assert chunked.shape == (5, H, W, 2) and chunked.dtype == np.float32
    np.testing.assert_array_equal(chunked, one)


def test_chunked_video_gives_the_same_boxes(monkeypatch):
    frames = _clip()

    class Reader:
        def __init__(self, path):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __len__(self):
            return len(frames)

        def get_batch(self, ids):
            return frames[ids]

    dev = torch.device("cpu")
    want, _ = motion_factory.process_video("v.mp4", _args(), dev, Reader)
    pair = motion_factory.PAIR_BYTES_PER_PIXEL * H * W
    monkeypatch.setattr(motion_factory, "flow_budget", lambda d: 2 * pair)
    got, _ = motion_factory.process_video("v.mp4", _args(), dev, Reader)
    assert len(got) == 6 and got == want


@pytest.mark.slow
def test_rigid_shift_at_256x320_matches_jax():
    rng = np.random.RandomState(11)
    base = gaussian_filter(rng.rand(256 + 16, 320 + 16).astype(np.float32),
                           2.0) * 255
    dx, dy = 3, 2
    a = base[8:8 + 256, 8:8 + 320]
    b = base[8 - dy:8 - dy + 256, 8 - dx:8 - dx + 320]
    ref = np.asarray(j_flow.tvl1_flow(jnp.asarray(a), jnp.asarray(b)))
    ours = flow.tvl1_flow(a, b, device="cpu").numpy()
    d = np.abs(ours - ref)
    assert d.max() <= 1e-3 and np.percentile(d, 99) <= 1e-4, (
        d.max(), np.percentile(d, 99))
    # rigid motion: the interior's flow is the shift
    inner = ours[32:-32, 32:-32]
    assert np.median(inner[..., 0]) == pytest.approx(dx, abs=0.1)
    assert np.median(inner[..., 1]) == pytest.approx(dy, abs=0.1)
