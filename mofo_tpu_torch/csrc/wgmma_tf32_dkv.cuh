// The f32 dK/dV of K2 and K3 up to head dim 128 for Hopper: products in
// 3xTF32 on wgmma (wgmma_tf32.cuh's splits, descriptors and products), fed
// by TMA. qkv_flash_attention.cu's qkv_attn_bwd_dkv runs it for K2 (q, k
// and v the column views of the fused (B, N, 3A) qkv at row stride 3A, dK
// and dV written into dqkv's views at 3A, no bias) and
// mh_flash_attention_f32.cu's launchers for K3 (q at its own row stride, k
// and v the column views of one fused (B, N, 2A) kv, the (B, N) kv bias
// row, dK and dV at their own row stride; without a bias the unbiased
// instance, which hm_flash_attention.cu's f32 backward runs for K4 too: one
// head a (BH, N, D) plane, row strides D). It replaces the FMA kernels
// mh_bwd_dkv_f32 (K3) and hm_bwd_dkv_f32 (K4) and computes what
// mofo_tpu's _mh_dqkv_kernel (mofo_tpu/ops/flash_attention.py:523, called
// by _mh_bwd_impl at :783 for K3 and, K2's f32 fallback, through
// _qkv_bwd_impl at :1271) computes for dK and dV in f32. Above 128 K3's
// entry point runs wgmma_tf32_wide.cuh's dK/dV (192, 256) and
// wgmma_tf32_split.cuh's column-split one.
//
// What bounds it. S^T, dP^T, dV += P^T dO and dK += dS^T (q * q_scale) are
// 8 N^2 D FLOP a head on N D values of each of q, k, v and dO: at N = 1568
// it is bound by operations, 1.221 ms at the BB-focused MCA's 8 x 128 and
// 16 x 64 (B = 10) at 495 / 3 TFLOP/s.
//
// The walk. A block owns 64 kWGs key/value rows of one head (kWGs consumer
// warpgroups of 64 rows: two up to D = 64, one at 128, whose dK and dV
// accumulators take 128 registers), their K and V as (hi, lo) tile pairs
// in shared memory (the A operands of S^T and dP^T), and streams the q
// side in kBQ-row tiles (32 at 128) through a ring of kEntries (hi, lo)
// entries: for q tile j, q * q_scale as loaded (entry 4j), dO as loaded
// (4j + 1), dO transposed (4j + 2) and q * q_scale transposed (4j + 3);
// entry 4j also carries the tile's LSE and delta. A producer warpgroup's
// first thread starts each entry's TMA load one entry ahead, and its 128
// threads split each landed tile into its (hi, lo) TF32 pair, as loaded or
// transposed (32-bit wgmma operands are K-major only, and dV and dK
// contract over the q tile's rows). Each consumer warpgroup forms S^T = K
// (q * q_scale)^T and dP^T = V dO^T for its kv rows, so P^T = exp(S^T +
// bias - lse) and dS^T = P^T (dP^T - delta) go from the accumulators into
// the A fragments of dV += P^T dO and dK += dS^T (q * q_scale), split in
// registers, in the K order permuted within groups of 8 that the
// transposed tiles share.
//
// The bias flag (kBias). S^T's rows are kv rows, so the kv bias is one
// value an accumulator row: each consumer thread reads its two rows' bias
// once, before the q loop (0 on rows >= N, which are never stored: any
// finite value will do), and adds it to S^T after the fold. No shared
// memory is added. K2's instance (kBias false) reads no bias.
//
// The budget (232,448 bytes of shared memory a block; 200 registers a
// consumer thread with two consumer warpgroups and setmaxnreg, 255 with
// one). 1024 bytes of alignment, 4 kWGs K / V tiles of 256 D bytes, the
// ring's 2 kEntries q-side tiles of 4 kBQ D bytes, 2 kEntries kBQ floats of
// LSE and delta, 3 kEntries + 1 barriers:
//   D = 16: 8 entries, 1024 + 32,768 + 65,536 + 4,096 + 200 = 103,624;
//   D = 32: 6 entries, 1024 + 65,536 + 98,304 + 3,072 + 152 = 168,088;
//   D = 64: 3 entries, 1024 + 131,072 + 98,304 + 1,536 + 80 = 232,016;
//   D = 128: 3 entries of 32-row tiles, 1024 + 131,072 + 98,304 + 768 +
//     80 = 231,248.
//
// Precision (wgmma_tf32.cuh's note). Where P is 1 (N = 1, or a sample
// whose bias leaves one kv column unmasked: then every q row of the sample
// has the same dO, delta and dP) dS = P (dP - delta) is rounding noise,
// the same for every q row, and that kv row's dK sums it times q * q_scale
// over the sample's N rows; its dV sums N equal terms. The check holds
// those rows to the plain f32 version (cuBLAS), within F32_ATOL, wherever
// the plain version is within F32_ATOL of float64. So with the bias (K3):
//   - dP^T is formed one k-step a chain, each k-step's products into a
//     fresh accumulator summed in f32, with the lo.lo term too (lo.lo,
//     lo.hi, hi.lo, hi.hi): a chain over D truncates against its running
//     sum, and the split alone drops lo.lo, which is >= 0 where dO = 2 out
//     and out is V; both bias dP low. A chain over D with the small terms
//     apart put dK of such a row 1.16e-3 from the plain version's, the
//     k-step chains without lo.lo 5.8e-4 (B = 10, N = 1568, 12 heads of
//     64; NVIDIA H100 80GB HBM3);
//   - dV's and dK's chains over a q tile keep their small terms (lo.hi,
//     hi.lo) in an accumulator of their own (add_fresh_apart):
//     added into the running sum of N equal terms, a small term loses its
//     bits below the sum's 26th (dV of such a row was 3 f32 ulps low, 5.2e-4
//     from the plain version's at N = 100).
// Without the bias (K2, K3 without one, K4) the only such rows are N = 1's,
// where both sums have one term: dP^T sums its small terms in an
// accumulator of their own over the whole chain, issued behind S^T's, and
// dV's and dK's chains run 64 output columns at a time. At D = 128 S^T
// does the same (kSApart): its one chain of 16 k-steps cut every small
// term against a running sum of |S| (toward zero: a bias in P that a
// float64 LSE does not share), and put dK at (4, 100) x 128 (K4's planes;
// NVIDIA H100 80GB HBM3) beyond 4x the plain version's error against
// float64; the tensor-core sum model (tests/test_torch_tf32_k4_bwd.py)
// puts it at 4.3x, 2.6x with the small terms apart. Either way each chain over a q tile runs
// into a fresh accumulator, added in f32: the tensor cores' accumulation
// truncates to the running sum, so a sum over N runs in registers in f32.
//
// Numerics (_mh_dqkv_kernel's in f32, as mh_bwd_dkv_f32 had them): base
// e, so dK needs no 1 / log2(e) fix; q times q_scale in f32 as it is
// split; the bias added after the fold; P = exp(S^T + bias - lse) not
// rounded; dS = P (dP - delta), delta (B, H, N) from the caller
// (fa.mh_delta); q rows >= N carry lse = +inf, so P = 0 there.

#pragma once

#include <math.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kDkvRows = 64;  // rows of a K or V tile

template <int D>
struct DkvF32 {
  static constexpr int kWGs = D == 128 ? 1 : 2;
  static constexpr int kBQ = D == 128 ? 32 : 64;
  static constexpr int kKE = kDkvRows * D;  // floats of a K or V tile
  static constexpr int kQE = kBQ * D;       // floats of a q-side tile
  static constexpr int kEntries = D == 16 ? 8 : D == 32 ? 6 : 3;
  static constexpr int kThreads = (kWGs + 1) * kWarpgroup;
  static constexpr size_t smem() {
    return 1024 +
           ((size_t)4 * kWGs * kKE + 2 * kEntries * kQE +
            2 * kEntries * kBQ) * sizeof(float) +
           (3 * kEntries + 1) * sizeof(uint64_t);
  }
};

// add_fresh with the chain's small terms (lo.hi, hi.lo) in an accumulator
// of their own (chain(f, small, desc_offset)): the biased instance's dV
// and dK. 64 output columns a chain at D = 128, 32 up to 64: with dP^T's
// k-steps issued one ahead (kAhead), 64-column chains took 8 x 128 from
// 5.9 to 4.9 ms but 16 x 64 from 3.3 to 4.2 ms, where they spill
// (tools/f32_ab.py; NVIDIA H100 80GB HBM3).
template <int D, typename Chain>
__device__ __forceinline__ void add_fresh_apart(float (&acc)[D / 8][4],
                                                Chain chain) {
  constexpr int kCols = D == 128 ? 64 : D < 32 ? D : 32, NG = kCols / 8;
#pragma unroll
  for (int grp = 0; grp < D / kCols; ++grp) {
    float f[NG][4] = {}, small[NG][4] = {};
    wgmma_fence();
    chain(f, small, (uint64_t)grp * (kCols * 128 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(f);
    fence_acc(small);
#pragma unroll
    for (int nt = 0; nt < NG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[grp * NG + nt][e] += f[nt][e] + small[nt][e];
  }
}

// Grid (ceil(N / (64 kWGs)), B * H). One block: one head's 64 kWGs
// key/value rows against every q tile. q, k, v and dO through their own
// tensor maps (columns h * D of plane b = y / H; rows past N arrive as
// zeros); bias (B, N) f32 or null (kBias only); lse and delta (B H, N);
// dk and dv (B, N, H D) at row stride lddkv.
template <int D, bool kBias>
__global__ void __launch_bounds__(DkvF32<D>::kThreads, 1)
    bwd_dkv_f32(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ bias,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int lddkv, int N, int H,
                float q_scale) {
  using P = DkvF32<D>;
  constexpr int kKE = P::kKE, kQE = P::kQE, kBQ = P::kBQ;
  constexpr int kE = P::kEntries, kWGs = P::kWGs, NQ = kBQ / 8;
  // the biased dP^T's k-steps issued ahead of the wait that lands one:
  // one at 128, none up to 64, where the second accumulator spills (alone
  // it took 8 x 128 from 5.9 to 5.6 ms and 16 x 64 from 3.3 to 3.7;
  // tools/f32_ab.py, NVIDIA H100 80GB HBM3)
  constexpr int kAhead = D == 128 ? 1 : 0;
  // the unbiased S^T's small terms in an accumulator of their own at 128
  // (the precision note)
  constexpr bool kSApart = !kBias && D == 128;
  extern __shared__ unsigned char wsmem[];
  float* sKV = reinterpret_cast<float*>(smem_1024(wsmem));
  float* sE = sKV + 4 * kWGs * kKE;  // entry s: hi, then lo
  float* sStat = sE + 2 * kE * kQE;  // entry s: lse, then delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sStat + 2 * kE * kBQ);
  uint64_t* empty = full + kE;
  uint64_t* landed = empty + kE;
  uint64_t* kvbar = landed + kE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kWGs * kDkvRows;
  const int T = (N + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kE; ++s) {
      mbar_init(&full[s], kWarpgroup);
      mbar_init(&empty[s], 4 * kWGs);
      mbar_init(&landed[s], 1);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWGs) {  // producer: loads and splits
    if constexpr (kWGs == 2) producer_registers_f32();
    const int p = threadIdx.x - 4 * kWGs * 32;
    const int n = 4 * T;
    // entry e's raw tile: as-loaded kinds into the hi tile, transposed ones
    // into the lo tile; q * q_scale from q's map, dO from its own
    auto issue = [&](int e) {
      const int s = e % kE, kind = e & 3;
      mbar_wait(&empty[s], ((e / kE) & 1) ^ 1);
      mbar_expect_tx(&landed[s], kQE * sizeof(float));
      tma_f32<kBQ, D, kBQ>(sE + (2 * s + (kind >= 2)) * kQE,
                           kind == 0 || kind == 3 ? &tq : &tdo, &landed[s],
                           h * D, (e >> 2) * kBQ, b);
    };
    if (p == 0) {
      mbar_expect_tx(kvbar, 2 * kWGs * kKE * sizeof(float));
      for (int w = 0; w < kWGs; ++w) {
        const int row = k0 + kDkvRows * w;
        tma_f32<kDkvRows, D, kBQ>(sKV + 4 * w * kKE, &tk, kvbar, h * D, row,
                                  b);
        tma_f32<kDkvRows, D, kBQ>(sKV + (4 * w + 2) * kKE, &tv, kvbar, h * D,
                                  row, b);
      }
      issue(0);
    }
    const float* lse_bh = lse + (size_t)bh * N;
    const float* delta_bh = delta + (size_t)bh * N;
    for (int e = 0; e < n; ++e) {
      if (p == 0 && e + 1 < n) issue(e + 1);
      const int s = e % kE, kind = e & 3;
      float* hi = sE + 2 * s * kQE;
      const float mul = kind == 0 || kind == 3 ? q_scale : 1.f;
      mbar_wait(&landed[s], (e / kE) & 1);
      if (kind < 2)
        split_rows<kBQ, D>(hi, hi + kQE, mul, p);
      else
        split_transposed<kBQ, D>(hi + kQE, hi, hi + kQE, mul, p,
                                 kProducerBar);
      if (kind == 0) {
        float* st = sStat + 2 * s * kBQ;
        for (int r = p; r < kBQ; r += kWarpgroup) {
          const int row = (e >> 2) * kBQ + r;  // rows >= N: P = 0, dS = 0
          st[r] = row < N ? lse_bh[row] : INFINITY;
          st[kBQ + r] = row < N ? delta_bh[row] : 0.f;
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  } else {
    if constexpr (kWGs == 2) consumer_registers_f32();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    float* kt = sKV + 4 * wg * kKE;  // K hi, K lo, V hi, V lo
    float* vt = kt + 2 * kKE;
    // the bias of this thread's two kv rows (accumulator rows g, g + 8)
    float kvb[2] = {0.f, 0.f};
    if constexpr (kBias) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = k0 + kDkvRows * wg + r0 + g + 8 * half;
        if (row < N) kvb[half] = bias[(size_t)b * N + row];
      }
    }
    mbar_wait(kvbar, 0);
    split_rows<kDkvRows, D>(kt, kt + kKE, 1.f, threadIdx.x & 127);
    split_rows<kDkvRows, D>(vt, vt + kKE, 1.f, threadIdx.x & 127);
    fence_proxy_async();
    warpgroup_sync(2 + wg);
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};

    for (int j = 0; j < T; ++j) {
      int s[4], par[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = (4 * j + i) % kE;
        par[i] = ((4 * j + i) / kE) & 1;
      }
      const float* qe = sE + 2 * s[0] * kQE;   // q * scale: hi, lo
      const float* de = sE + 2 * s[1] * kQE;   // dO
      const float* dte = sE + 2 * s[2] * kQE;  // dO^T
      const float* qte = sE + 2 * s[3] * kQE;  // (q * scale)^T
      // S^T keeps one accumulator (registers; kSApart: two); dP^T as the
      // precision note says
      float st[NQ][4] = {}, st_small[NQ][4] = {}, dpt[NQ][4];
      auto scores = [&] {
        mbar_wait(&full[s[0]], par[0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint64_t a_hi = desc_k8<kDkvRows, D>(kt, kk);
          const uint64_t a_lo = desc_k8<kDkvRows, D>(kt + kKE, kk);
          const uint64_t b_hi = desc_k8<kBQ, D>(qe, kk);
          const uint64_t b_lo = desc_k8<kBQ, D>(qe + kQE, kk);
          if constexpr (kSApart)
            mma3_ss(st, st_small, a_hi, a_lo, b_hi, b_lo);
          else
            mma3_ss(st, a_hi, a_lo, b_hi, b_lo);
        }
      };
      if constexpr (kBias) {
        // dP^T first (S^T's accumulator is not live across its waits), one
        // k-step a fresh accumulator: lo.lo, lo.hi, hi.lo, then hi.hi
        mbar_wait(&full[s[1]], par[1]);
        // k-step kk's chain into f[kk % (kAhead + 1)], issued kAhead
        // k-steps ahead of the wait that lands it
        float f[kAhead + 1][NQ][4];
        auto issue = [&](int kk) {
          float (&g)[NQ][4] = f[kk % (kAhead + 1)];
#pragma unroll
          for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) g[nt][e] = 0.f;
          const uint64_t a_hi = desc_k8<kDkvRows, D>(vt, kk);
          const uint64_t a_lo = desc_k8<kDkvRows, D>(vt + kKE, kk);
          const uint64_t b_hi = desc_k8<kBQ, D>(de, kk);
          const uint64_t b_lo = desc_k8<kBQ, D>(de + kQE, kk);
          wgmma_fence();
          wgmma_tf32_ss(g, a_lo, b_lo);
          wgmma_tf32_ss(g, a_lo, b_hi);
          wgmma_tf32_ss(g, a_hi, b_lo);
          wgmma_tf32_ss(g, a_hi, b_hi);
          wgmma_commit();
        };
#pragma unroll
        for (int kk = 0; kk < kAhead; ++kk) issue(kk);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          if (kk + kAhead < D / 8) {
            issue(kk + kAhead);
            wgmma_wait<kAhead>();
          } else {
            wgmma_wait<0>();
          }
          float (&g)[NQ][4] = f[kk % (kAhead + 1)];
          fence_acc(g);
#pragma unroll
          for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[nt][e] = kk ? dpt[nt][e] + g[nt][e] : g[nt][e];
        }
        scores();
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
      } else {  // the small terms apart, issued behind S^T's chain
        float dpt_small[NQ][4] = {};
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpt[nt][e] = 0.f;
        scores();
        mbar_wait(&full[s[1]], par[1]);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
          mma3_ss(dpt, dpt_small, desc_k8<kDkvRows, D>(vt, kk),
                  desc_k8<kDkvRows, D>(vt + kKE, kk),
                  desc_k8<kBQ, D>(de, kk), desc_k8<kBQ, D>(de + kQE, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
        fence_acc(dpt_small);
        add_small(dpt, dpt_small);
        if constexpr (kSApart) {
          fence_acc(st_small);
          add_small(st, st_small);
        }
      }
      const float* sl = sStat + 2 * s[0] * kBQ;
      const float* sd = sl + kBQ;
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int col = 8 * nt + 2 * t;  // the q row within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sd + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the bias after the fold
          const float sb = kBias ? st[nt][e] + kvb[e >> 1] : st[nt][e];
          const float pv = expf(sb - ((e & 1) ? l2.y : l2.x));
          dpt[nt][e] = pv * (dpt[nt][e] - ((e & 1) ? d2.y : d2.x));
          st[nt][e] = pv;
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s[0]]);
        mbar_arrive(&empty[s[1]]);
      }
      uint32_t ph[NQ][4], pl[NQ][4];  // P^T, then dS^T, as (hi, lo)
      // acc += (P^T or dS^T) B over the tile's rows, B = dO or q * q_scale
      // transposed (its hi tile at bt)
      auto output = [&](float (&acc)[D / 8][4], const float* bt) {
        if constexpr (kBias)
          add_fresh_apart<D>(acc, [&](auto& f, auto& small, uint64_t off) {
#pragma unroll
            for (int kk = 0; kk < NQ; ++kk)
              mma3_rs(f, small, ph[kk], pl[kk],
                      desc_k8<D, kBQ>(bt, kk) + off,
                      desc_k8<D, kBQ>(bt + kQE, kk) + off);
          });
        else
          add_fresh<D>(acc, [&](auto& f, uint64_t off) {
#pragma unroll
            for (int kk = 0; kk < NQ; ++kk)
              mma3_rs(f, ph[kk], pl[kk], desc_k8<D, kBQ>(bt, kk) + off,
                      desc_k8<D, kBQ>(bt + kQE, kk) + off);
          });
      };
      acc_to_a(st, ph, pl);
      mbar_wait(&full[s[2]], par[2]);
      output(dva, dte);
      fence_frag(ph);
      fence_frag(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s[2]]);
      acc_to_a(dpt, ph, pl);
      mbar_wait(&full[s[3]], par[3]);
      output(dka, qte);
      fence_frag(ph);
      fence_frag(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s[3]]);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = k0 + kDkvRows * wg + r0 + g + 8 * half;
      if (row >= N) continue;
      const size_t off = ((size_t)b * N + row) * lddkv + h * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<float2*>(dk + off + 8 * nt) =
            make_float2(dka[nt][2 * half], dka[nt][2 * half + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * nt) =
            make_float2(dva[nt][2 * half], dva[nt][2 * half + 1]);
      }
    }
  }
}

// The f32 dK/dV at head dim D (16, 32, 64, 128): q, k and v (B, N, H D) at
// row strides ldq, ldk, ldv, dout (B, N, H D) contiguous (row strides
// multiples of 4: TMA wants 16-byte rows), each in boxes of sub_cols<D>()
// columns and kBQ rows; bias (B, N) with kBias (K3 with a bias), none
// without (K2, K3 without one); lse and delta (B H, N); dk and dv at row
// stride lddkv. Returns 0, kBadArgument or a cudaError_t from the set-up.
template <int D, bool kBias>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dk, void* dv, int B, int N,
                   int H, int ldq, int ldk, int ldv, int lddkv,
                   float q_scale, cudaStream_t st) {
  using P = DkvF32<D>;
  if (!delta || (kBias && !bias)) return kBadArgument;
  const int A = H * D;
  const void* base[4] = {q, k, v, dout};
  const int ld[4] = {ldq, ldk, ldv, A};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) {
    if (ld[i] % 4) return kBadArgument;
    if (int e = tile_map_f32(&m[i], base[i], A, N, B, ld[i], (long)N * ld[i],
                             sub_cols<D>(), P::kBQ))
      return e;
  }
  constexpr size_t smem = P::smem();
  auto kernel = bwd_dkv_f32<D, kBias>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + P::kWGs * kDkvRows - 1) / (P::kWGs * kDkvRows), B * H),
           P::kThreads, smem, st>>>(m[0], m[1], m[2], m[3],
                                    kBias ? bias : nullptr, lse, delta,
                                    static_cast<float*>(dk),
                                    static_cast<float*>(dv), lddkv, N, H,
                                    q_scale);
  return 0;
}

}  // namespace
