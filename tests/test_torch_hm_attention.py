"""The port's head-major flash attention (K4) and the attention routing
against the JAX package.

On the CPU, mofo_tpu_torch.ops.flash_attention.flash_attention runs the
plain PyTorch versions of its CUDA kernels (hm_attn_fwd, hm_attn_bwd_prep,
hm_attn_bwd_dkv, hm_attn_bwd_dq); here they are held against
mofo_tpu.ops.flash_attention.flash_attention(..., interpret=True), which
runs the TPU kernel K4 (_fwd_kernel, _dq_kernel, _dkv_kernel), forward and
the gradients of sum(out^2). models.layers.Attention picks the flat K1/K2
route or the head-major route (K4 from 128 tokens) from the shapes alone;
a narrow ViT-S-shaped model (1 x 64 decoder heads on 196 tokens) is held
against the JAX model with the same weights. The CUDA kernels themselves
are held against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofo_tpu.models import create_model as jax_create_model
from mofo_tpu.ops import masking as jax_masking
from mofo_tpu.ops.flash_attention import flash_attention as jax_flash
from mofo_tpu_torch.models import create_model
from mofo_tpu_torch.models.layers import Block
from mofo_tpu_torch.ops import attention as attn
from mofo_tpu_torch.ops import flash_attention as fa
from mofo_tpu_torch.tools import main_path
from mofo_tpu_torch.train.checkpoint import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's workers share the
    machine's cores, and torch's own pool in each of them oversubscribes
    them (tests/test_torch_mesh_zoo.py's fixture)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


B, H, D = 2, 3, 64
SCALE = D ** -0.5


def _inputs(N, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, N, D).astype(np.float32) for _ in range(3)]


def _jax_run(x, dtype, scale=SCALE):
    def loss(q, k, v):
        out = jax_flash(q, k, v, scale=scale, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    args = [jnp.asarray(a).astype(dtype) for a in x]
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(out), [f32(g) for g in grads]


def _port_run(x, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in x]
    out = fa.flash_attention(*ts, scale=SCALE)
    (out.float() ** 2).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("N", [16, 37, 128, 200])
def test_f32_matches_tpu_kernel(N):
    x = _inputs(N)
    j_out, j_grads = _jax_run(x, jnp.float32)
    p_out, p_grads = _port_run(x, torch.float32)
    np.testing.assert_allclose(p_out, j_out, atol=2e-5, rtol=0)
    for p, j in zip(p_grads, j_grads):
        np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("N", [16, 37, 128, 200])
def test_bf16_matches_tpu_kernel(N):
    # each output within 2^-6 of its max|ref| (two bf16 ulps at the largest
    # entry) and within the 3e-2 of tests/test_tpu_kernels.py:251-254
    x = _inputs(N, seed=1)
    j_out, j_grads = _jax_run(x, jnp.bfloat16)
    p_out, p_grads = _port_run(x, torch.bfloat16)
    for p, j in zip([p_out] + p_grads, [j_out] + j_grads):
        assert np.abs(p - j).max() <= 2.0 ** -6 * np.abs(j).max()
        np.testing.assert_allclose(p, j, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32])
def test_head_dims_16_and_32_match_tpu_kernel(hd, dtype):
    """K4's plain versions at the tiny presets' head dims (BH = 2, N = 130,
    past one 128-row tile) against the interpret-mode TPU K4, forward and
    the gradients of sum(out^2), at the bounds of the D = 64 cases."""
    rng = np.random.RandomState(hd)
    x = [rng.randn(1, 2, 130, hd).astype(np.float32) for _ in range(3)]
    scale = hd ** -0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j_out, j_grads = _jax_run(x, jdt, scale)
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in x]
    out = fa.flash_attention(*ts, scale=scale)
    (out.float() ** 2).sum().backward()
    p_out = out.detach().float().numpy()
    p_grads = [t.grad.float().numpy() for t in ts]
    for p, j, atol in zip([p_out] + p_grads, [j_out] + j_grads,
                          [2e-5, 1e-4, 1e-4, 1e-4]):
        if dtype == torch.float32:
            np.testing.assert_allclose(p, j, atol=atol, rtol=0)
        else:
            assert np.abs(p - j).max() <= 2.0 ** -6 * np.abs(j).max()
            np.testing.assert_allclose(p, j, atol=3e-2, rtol=3e-2)


def _prep_route(x, dtype, scale):
    """The backward as the bf16 kernels split it, in plain versions: the
    forward, dout = d sum(out^2) / d out, the prep pass, then dQ, dK and dV
    from its outputs. Returns (whole, split): attention_hm_bwd_plain's
    gradients and the split route's."""
    q, k, v = (torch.from_numpy(a).to(dtype).reshape(B * H, -1, D)
               for a in x)
    out, lse = fa.attention_hm_fwd_plain(q, k, v, scale)
    dout = (2 * out.float()).to(dtype)
    delta, qs, ks = fa.hm_attn_bwd_prep(q, k, out, dout, scale)
    assert (ks is None) == (scale == SCALE)  # 0.125 is a power of two
    assert delta.dtype == torch.float32 and delta.shape == q.shape[:2]
    return (fa.attention_hm_bwd_plain(q, k, v, out, lse, dout, scale),
            fa.attention_hm_bwd_from_prep_plain(k, v, lse, dout, delta, qs,
                                                ks, scale))


@pytest.mark.parametrize("N", [16, 37, 128])
@pytest.mark.parametrize("scale", [SCALE, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prep_route_equals_the_plain_backward(dtype, scale, N):
    """The prep pass and the backward from its outputs give the whole plain
    backward bit for bit, also where dQ scales its accumulator."""
    whole, split = _prep_route(_inputs(N, seed=2), dtype, scale)
    for w, s in zip(whole, split):
        assert torch.equal(w, s)


@pytest.mark.parametrize("N", [16, 37, 128])
@pytest.mark.parametrize("scale", [SCALE, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prep_route_matches_tpu_kernel(dtype, scale, N):
    """The split backward against the interpret-mode TPU K4 backward, to the
    tolerances of the two tests above."""
    x = _inputs(N, seed=2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, j_grads = _jax_run(x, jdt, scale)
    _, split = _prep_route(x, dtype, scale)
    for p, j in zip(split, j_grads):
        p = p.float().reshape(j.shape).numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)
        else:
            assert np.abs(p - j).max() <= 2.0 ** -6 * np.abs(j).max()
            np.testing.assert_allclose(p, j, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_runs_the_plain_versions_on_cpu(dtype):
    q, k, v = main_path.hm_inputs(6, 37, dtype, 3, "cpu")
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*(t.reshape(2, 3, 37, D) for t in ts),
                             scale=SCALE).reshape(6, 37, D)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                       ).to(dtype)
    out.backward(dout)
    p_out, lse = fa.attention_hm_fwd_plain(q, k, v, SCALE)
    grads = fa.attention_hm_bwd_plain(q, k, v, p_out, lse, dout, SCALE)
    assert torch.equal(out.detach(), p_out)
    for t, g in zip(ts, grads):
        assert torch.equal(t.grad, g)
    assert lse.shape == (6, 37) and lse.dtype == torch.float32


def test_lse_is_a_natural_log_in_bf16_too():
    """K4 keeps its LSE in natural-log units in bf16, where K1 works in
    base 2 and stores log2 units."""
    q, k, v = main_path.hm_inputs(1, 50, torch.bfloat16, 7, "cpu")
    _, lse = fa.attention_hm_fwd_plain(q, k, v, SCALE)
    s = (q * torch.tensor(SCALE, dtype=torch.bfloat16)).float() @ \
        k.float().transpose(-1, -2)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=0)
    _, k1_lse = fa.attention_qkv_fwd_plain(torch.cat([q, k, v], -1), SCALE,
                                           1)
    torch.testing.assert_close(k1_lse[:, 0], lse * fa.LOG2E, rtol=1e-2,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bounds_reject_planted_faults(dtype):
    """The bounds that hold the K4 kernels against their plain versions on
    the card pass the plain versions themselves (the CPU route) and reject
    a zeroed dQ and an LSE in log2 units."""
    q, k, v = main_path.hm_inputs(4, 100, dtype, 6, "cpu")
    got, want = main_path.hm_attention_against_plain(q, k, v, SCALE)
    res = main_path.check_against_plain(got, want)
    assert set(res["max_abs_err"].values()) == {0.0}
    faults = main_path.hm_planted_faults(got)
    assert set(faults) == {"dq_zero", "lse_log2"}
    for outputs in faults.values():
        with pytest.raises(AssertionError, match="beyond the bounds"):
            main_path.check_against_plain(outputs, want)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    # the launchers take a head dim that is its own width only
    # (flash_attention pads 48 to 64 and 264 to 320 first); 320 is one
    x = torch.zeros(2, 8, 264)
    with pytest.raises(ValueError, match="head dim 264 .* pad it to 320"):
        fa._check_hm(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_hm(torch.zeros(2, 8, 320))
    x = torch.zeros(2, 8, 48)
    with pytest.raises(ValueError, match="head dim 48 has no kernel"):
        fa._check_hm(x)
    x = torch.zeros(2, 8, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check_hm(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.hm_attn_bwd_dq(x, x, x, x, x[..., 0], x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.hm_attn_bwd_dkv(x, x, x, x, x[..., 0], x, x, x, 1.0,
                           prep=(x[..., 0], x, None))
    with pytest.raises(ValueError, match="share one"):
        fa.flash_attention(torch.zeros(1, 2, 8, D), torch.zeros(1, 2, 9, D),
                           torch.zeros(1, 2, 9, D), scale=1.0)
    assert fa.HM_KERNELS == ("hm_attn_fwd", "hm_attn_bwd_prep",
                             "hm_attn_bwd_dkv", "hm_attn_bwd_dq")
    assert fa.HM_F32_KERNELS == ("hm_attn_fwd", "hm_attn_bwd_dkv",
                                 "hm_attn_bwd_dq")
    assert set(fa.HM_KERNELS) <= set(fa.launch_counts)


def _record_routes(monkeypatch):
    """Counts the calls of each attention route of models.layers."""
    from mofo_tpu_torch.models import layers

    calls = {"flat": 0, "k4": 0, "xla": 0}

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(layers, "flash_attention_qkv",
                        wrap("flat", layers.flash_attention_qkv))
    monkeypatch.setattr(attn, "flash_attention",
                        wrap("k4", attn.flash_attention))
    monkeypatch.setattr(attn, "xla_attention",
                        wrap("xla", attn.xla_attention))
    return calls


@pytest.mark.parametrize("heads,N,route", [
    (3, 100, "xla"), (3, 196, "k4"),   # A = 192: head-major
    (2, 100, "xla"), (2, 196, "flat"),  # A = 128: flat from 128 tokens
])
def test_block_route_depends_on_shapes_only(monkeypatch, heads, N, route):
    calls = _record_routes(monkeypatch)
    blk = Block(64 * heads, heads, qkv_bias=True,
                generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, N, 64 * heads, generator=torch.Generator()
                    .manual_seed(1))
    blk(x).sum().backward()
    assert blk.attn.uses_flat(N) == (route == "flat")
    assert calls == {r: int(r == route) for r in ("flat", "k4", "xla")}


def test_attn_impl_forces_a_route(monkeypatch):
    calls = _record_routes(monkeypatch)
    x = torch.randn(1, 20, 192, generator=torch.Generator().manual_seed(1))
    Block(192, 3, attn_impl="pallas")(x)
    Block(128, 2, attn_impl="pallas")(x[..., :128])
    Block(128, 2, attn_impl="xla")(torch.cat([x] * 7, 1)[..., :128])
    assert calls == {"flat": 1, "k4": 1, "xla": 1}
    with pytest.raises(ValueError, match="attn_impl"):
        Block(64, 1, attn_impl="flash")


# A narrow ViT-S-shaped model: 2 x 64 encoder heads (A = 128, flat once
# N >= 128) on the 20 visible tokens, 1 x 64 decoder heads (A = 64, the
# head-major route) on all 196 tokens of 8 frames at 112^2.
NAME = "pretrain_videomae_small_patch16_224"
VITS_GEO = dict(img_size=112, num_frames=8, encoder_embed_dim=128,
                encoder_depth=2, encoder_num_heads=2, decoder_embed_dim=64,
                decoder_depth=2, decoder_num_heads=1,
                decoder_num_classes=1536)


@pytest.mark.parametrize("jax_impl,port_impl,routes", [
    # JAX off a TPU runs XLA attention under "auto"; the port's "auto" takes
    # the routes a TPU takes: XLA math in the encoder, K4 in the decoder
    ("xla", "auto", {"flat": 0, "k4": 2, "xla": 2}),
    # both run the kernels: K1/K2 in the encoder, K4 in the decoder (JAX in
    # interpret mode)
    ("pallas", "pallas", {"flat": 2, "k4": 2, "xla": 0}),
])
def test_vits_shaped_model_matches_jax(monkeypatch, jax_impl, port_impl,
                                       routes):
    jmodel = jax_create_model(NAME, attn_impl=jax_impl, **VITS_GEO)
    clip = np.random.RandomState(0).randn(2, 8, 112, 112, 3).astype(
        np.float32)
    mask = jax_masking.tube_mask(jax.random.PRNGKey(0), 2,
                                 temporal_positions=4, patches_per_frame=49,
                                 mask_ratio=0.9)
    vis, msk = jax_masking.mask_to_indices(mask, 4 * 44)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(clip), vis,
                         msk)["params"]
    want = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                            jnp.asarray(clip), vis, msk))
    port = create_model(NAME, device="cpu", attn_impl=port_impl, **VITS_GEO)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    calls = _record_routes(monkeypatch)
    with torch.no_grad():
        got = port(torch.from_numpy(clip), torch.from_numpy(np.array(vis)),
                   torch.from_numpy(np.array(msk))).numpy()
    assert calls == routes
    assert vis.shape[1] == 20 and got.shape == (2, 176, 1536)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
