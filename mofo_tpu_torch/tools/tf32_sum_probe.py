"""Probes how the card's tensor cores sum f32 (TF32) products, and what that
does to the one-column row of the f32 column-split backward at head dim
1024 (tests/test_torch_gpu.py's test_mh_above_256 at N = 65):

    python -m mofo_tpu_torch.tools.tf32_sum_probe [--model] [--out f.json]

Part 1 builds a one-k-step kernel (one wgmma m64n64k8 .tf32 of
csrc/wgmma_tf32.cuh, d = c + sum of 8 products) with nvcc into
mofo_tpu_torch/build/ and feeds it TF32 values whose exact sums tell the
rounding apart: 1 + 0.75 ulp (round to nearest gives 1 + ulp, truncation
1), [1, -1, 2^-k] (the bits kept below the largest addend's leading bit),
c = 1 with [-1, 2^-k] (whether c shares that window), [1, -1, -3 *
2^-m] (the cut's direction). Part 2 runs K3 on mh_inputs(2, N, 1, 1024,
seed 1024 + N) through main_path.mh_attention_against_plain and reports,
for the one unmasked kv row j of sample 0, the kernels' and the plain
version's dK against float64 (signed, at the plain version's largest
error), and the row rule's verdict (main_path.f32_rows_beyond). One JSON
line; the card's name and power limit in it. No card: exit 2.

--model runs on the CPU instead: part 1's rules as a numpy model
(model_sum) driving the column-split backward's dP walk (dp_walk in
csrc/wgmma_tf32_split.cuh) over that row at N = 65 on the plain forward's
out, as the kernel runs it and as two variants would: each k-step's chain
started at its share -delta / (D / 8) with hi.hi first ("centred"), and
that with the split's dropped lo.lo term added ("centred_lolo"). It
reports each walk's error in dS against float64, beside the split's own
(the three products summed exactly) and delta's (fa.mh_delta's f32 sum).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include "wgmma_tf32.cuh"
namespace {
__global__ void probe(const float* a, const float* b, const float* c,
                      float* d) {
  extern __shared__ unsigned char raw[];
  float* sA = reinterpret_cast<float*>(smem_1024(raw));
  float* sB = sA + 64 * 32;
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) {
    const int r = i / 32, k = i % 32;
    sA[kmaj_index<64, 32>(r, k)] = k < 8 ? a[r * 8 + k] : 0.f;
    sB[kmaj_index<64, 32>(r, k)] = k < 8 ? b[r * 8 + k] : 0.f;
  }
  fence_proxy_async();
  __syncthreads();
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  float acc[8][4];
  for (int nt = 0; nt < 8; ++nt)
    for (int i = 0; i < 4; ++i)
      acc[nt][i] = c[(16 * w + g + 8 * (i >> 1)) * 64 + 8 * nt + 2 * t +
                     (i & 1)];
  wgmma_fence();
  wgmma_tf32_ss(acc, desc_k8<64, 32>(sA, 0), desc_k8<64, 32>(sB, 0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  for (int nt = 0; nt < 8; ++nt)
    for (int i = 0; i < 4; ++i)
      d[(16 * w + g + 8 * (i >> 1)) * 64 + 8 * nt + 2 * t + (i & 1)] =
          acc[nt][i];
}
}  // namespace
extern "C" int tf32_sum_probe(const void* a, const void* b, const void* c,
                              void* d) {
  const size_t smem = 1024 + 2 * 64 * 32 * 4;
  if (int e = max_smem((const void*)probe, smem)) return e;
  probe<<<1, 128, smem>>>((const float*)a, (const float*)b,
                          (const float*)c, (float*)d);
  if (cudaError_t e = cudaDeviceSynchronize()) return (int)e;
  return (int)cudaGetLastError();
}
"""


def _library():
    from mofo_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tf32_sum_probe.cu"
    lib = _build.BUILD_DIR / "tf32_sum_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    probe = ctypes.CDLL(str(lib)).tf32_sum_probe
    probe.argtypes = [ctypes.c_void_p] * 4
    return probe


def sums(probe, rows) -> list:
    """d = c + sum of the products for each row (c, [a_k, ...]): a_k times
    1, each row's sum in its own accumulator row."""
    import torch

    out = []
    for start in range(0, len(rows), 64):
        a, c = torch.zeros(64, 8), torch.zeros(64, 64)
        b = torch.zeros(64, 8)
        b[0] = 1.0
        chunk = rows[start:start + 64]
        for r, (cv, prods) in enumerate(chunk):
            c[r, 0] = cv
            a[r, :len(prods)] = torch.tensor(prods)
        a, b, c = a.cuda(), b.cuda(), c.cuda()
        d = torch.empty_like(c)
        if probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr()):
            raise RuntimeError("the probe kernel failed")
        out += d[:len(chunk), 0].cpu().double().tolist()
    return out


def accumulation(probe) -> dict:
    ulp = 2.0 ** -23
    ks, ms = range(20, 30), range(22, 30)
    return {
        "one_plus_0.75ulp": sums(probe, [(0.0, [1.0, 0.75 * ulp])])[0] - 1,
        "minus_one_minus_0.75ulp": sums(
            probe, [(0.0, [-1.0, -0.75 * ulp])])[0] + 1,
        "window": dict(zip(ks, sums(probe, [(0.0, [1.0, -1.0, 2.0 ** -k])
                                            for k in ks]))),
        "window_with_c": dict(zip(ks, sums(probe, [(1.0, [-1.0, 2.0 ** -k])
                                                   for k in ks]))),
        "minus_3_times_2^-m_over_2^-m": {
            m: v / 2.0 ** -m for m, v in zip(ms, sums(
                probe, [(0.0, [1.0, -1.0, -3 * 2.0 ** -m]) for m in ms]))},
    }


def one_column_row(N: int, D: int = 1024) -> dict:
    import torch

    from mofo_tpu_torch.ops import flash_attention as fa
    from mofo_tpu_torch.tools import main_path as M

    q, k, v, b = M.mh_inputs(2, N, 1, D, torch.float32, D + N, "cuda")
    got, want = M.mh_attention_against_plain(q, k, v, b, 1, D ** -0.5)
    torch.cuda.synchronize()
    j = N // 2
    x = want["exact"]["dk"][0, j].double().cuda()
    kernel, plain = got["dk"][0, j].double() - x, want["dk"][0, j].double() - x
    d = int(plain.abs().argmax())
    # dK's row j is dS^T's row j (constant over the sample's q rows, P = 1)
    # times the column sums of q * q_scale
    c = float(q[0, :, d].double().sum()) * fa._rounded(D ** -0.5,
                                                      torch.float32)
    held = M.f32_rows_beyond(got["dk"], want["dk"], want["exact"]["dk"],
                             M.F32_ATOL["dk"],
                             want["loose_rows"]["dk"])
    return {"N": N, "D": D, "kernel_dk_err": kernel[d].item(),
            "plain_dk_err": plain[d].item(),
            "kernel_ds_err": kernel[d].item() / c,
            "plain_ds_err": plain[d].item() / c,
            "kernel_vs_plain": (got["dk"] - want["dk"]).abs().max().item(),
            "rows_beyond": held["beyond"],
            "rows_held_to_f64": held["held_to_f64"]}


def model_sum(c, a, b):
    """One k-step as part 1 finds the tensor cores sum it, in numpy: d = c +
    sum_k a_k b_k for c (R, C) and TF32 a (R, 8), b (C, 8); the products
    exact, every addend cut toward zero to 26 bits below the largest
    addend's leading bit, the sum exact, then cut toward zero to f32."""
    import numpy as np

    terms = np.concatenate(
        [np.asarray(c, np.float64)[..., None],
         a.astype(np.float64)[:, None, :] * b.astype(np.float64)[None]], -1)
    _, e = np.frexp(np.abs(terms).max(-1, keepdims=True))
    quantum = np.ldexp(1.0, e - 26)
    s = (np.trunc(terms / quantum) * quantum).sum(-1)
    f = s.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(s),
                    np.nextafter(f, np.float32(0)), f)


def _tf32(x):
    import numpy as np

    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def model_walk(a, b, delta, variant: str):
    """dp_walk over model_sum: a (R, D), b (C, D) f32, delta (C,) f32; the
    kernel's walk ("kernel": each k-step's chain from 0, lo.hi, hi.lo,
    then hi.hi; dp from -delta) or a variant ("centred", "centred_lolo")."""
    import numpy as np

    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    steps = a.shape[-1] // 8
    share = (delta * np.float32(1 / steps)).astype(np.float32)
    start = -delta if variant == "kernel" else \
        (steps * share.astype(np.float64) - delta).astype(np.float32)
    dp = np.broadcast_to(start, (a.shape[0], b.shape[0])).astype(np.float32)
    carry = np.zeros_like(dp)
    for c in range(0, a.shape[-1], 64):
        part = carry
        for k in range(c, c + 64, 8):
            ks = slice(k, k + 8)
            if variant == "kernel":
                f = model_sum(np.zeros_like(dp), al[:, ks], bh[:, ks])
                f = model_sum(f, ah[:, ks], bl[:, ks])
                f = model_sum(f, ah[:, ks], bh[:, ks])
            else:
                f = model_sum(np.broadcast_to(-share, dp.shape), ah[:, ks],
                              bh[:, ks])
                f = model_sum(f, al[:, ks], bh[:, ks])
                f = model_sum(f, ah[:, ks], bl[:, ks])
                if variant == "centred_lolo":
                    f = model_sum(f, al[:, ks], bl[:, ks])
            part = (part + f).astype(np.float32)
        s = (dp + part).astype(np.float32)  # two-sum: dp + part = s + err
        bb = (s - dp).astype(np.float32)
        carry = ((dp - (s - bb)) + (part - bb)).astype(np.float32)
        dp = s
    return dp


def model_one_column(N: int = 65, D: int = 1024) -> dict:
    import numpy as np
    import torch

    from mofo_tpu_torch.ops import flash_attention as fa
    from mofo_tpu_torch.tools import main_path as M

    q, k, v, b = M.mh_inputs(2, N, 1, D, torch.float32, D + N, "cpu")
    out, _ = fa.attention_mh_fwd_plain(q, k, v, b, D ** -0.5, 1)
    dout = 2 * out
    delta = fa.mh_delta(out, dout, 1)[0, 0].numpy()
    j = N // 2
    vj = np.ascontiguousarray(v[0, j:j + 1].numpy())
    do = dout[0].numpy()
    x64 = vj.astype(np.float64) @ do.astype(np.float64).T
    exact = x64 - delta  # dS's row against the f32 delta it is given
    vh, dh = _tf32(vj), _tf32(do)
    three = (_tf32(vj - vh).astype(np.float64) @ dh.T.astype(np.float64) +
             vh.astype(np.float64) @ _tf32(do - dh).T.astype(np.float64) +
             vh.astype(np.float64) @ dh.T.astype(np.float64))
    delta_err = delta.astype(np.float64) - \
        (do.astype(np.float64) * out[0].numpy().astype(np.float64)).sum(-1)
    return {"N": N, "D": D, "split_err": float((three - x64)[0, 0]),
            "delta_err": float(delta_err[0]),
            "walk_err": {w: float((model_walk(vj, do, delta, w) -
                                   exact)[0, 0])
                         for w in ("kernel", "centred", "centred_lolo")}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", action="store_true",
                   help="the CPU model of the one-column row's dP walk")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if args.model:
        return _emit({"device": "cpu", "model": model_one_column()},
                     args.out)

    if not torch.cuda.is_available():
        print("tf32_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return _emit({"nvidia_smi": smi, "accumulation": accumulation(_library()),
                  "one_column_row": [one_column_row(N) for N in (65, 200)]},
                 args.out)


def _emit(res: dict, out) -> int:
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
