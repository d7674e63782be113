// The f32 dQ of K3 and K2 for Hopper: dQ = dS (K * k_scale) in 3xTF32 on
// wgmma (wgmma_tf32.cuh's splits, descriptors and products), fed by TMA.
// mh_flash_attention.cu's mh_attn_bwd_dq runs it for K3 at every head dim
// up to 256 in f32, and qkv_flash_attention.cu's qkv_attn_bwd_dq reaches
// it for K2 through K3's entry point (q, k and v the column views of the
// fused qkv, no bias, dQ into dqkv's columns [0, A) at row stride 3A). It
// runs for K4 too, through the same launcher (hm_flash_attention.cu's f32
// backward: one head a (BH, N, D) plane, row strides D, no bias). It
// replaces the FMA kernels mh_bwd_dq_f32 (K3), bwd_dq_f32 (K2) and
// hm_bwd_dq_f32 (K4), and the TPU kernels' dQ: _mh_dqkv_kernel
// (mofo_tpu/ops/flash_attention.py:523, called by _mh_bwd_impl at :783),
// which the f32 K2 backward runs as its blocked fallback (:1229-1244). Two
// forms:
//   - the narrow one (this file), head dims 16, 32, 64 and 128, with a
//     bias flag (K3 with a kv bias; K2 and K3 without);
//   - the chunked one at 192 and 256 (wgmma_tf32_wide.cuh's mh_dq_tf32),
//     which streams D in 64-column chunks.
//
// What bounds it. dQ forms S = (q * q_scale) K^T and dP = dO V^T again
// (the dK/dV kernel formed them too) and then dQ = dS K: 3 products of 2
// N^2 D FLOP each, on N D values of each input: at N = 1568 it is bound by
// operations, 0.549 ms at the ViT-B decoder (16, 1568, 6, 64) at 495 / 3
// TFLOP/s.
//
// The narrow walk. A block owns 64 query rows of one head per consumer
// warpgroup (two up to D = 64, one at 128) and streams the kv tiles (kBK
// rows). The consumer splits its q * q_scale and dO tiles once into
// resident (hi, lo) pairs: both are A operands of products that contract
// over D (S and dP), read from shared memory. K and V as loaded are
// K-major B operands of the same products. dQ += dS (K * k_scale)
// contracts over the tile's kv rows, so K goes through split_transposed
// (its kv index permuted, perm8) and dS goes from the accumulators into A
// fragments in the same order (acc_to_a), as bwd_dkv_f32 hands on P^T and
// dS^T. So a kv tile is three ring entries: K as loaded (3j), V as loaded
// (3j + 1) and K * k_scale transposed (3j + 2). The producer warpgroup's
// first thread starts each entry's TMA load one entry ahead, and its 128
// threads split each landed tile; the K entry also carries the tile's bias
// row (-inf past N), read before the K slot is released.
//
// The budget (shared memory a block may take: 232,448 bytes; registers a
// consumer thread: 200 with two consumer warpgroups and setmaxnreg, 255
// with one). The resident q * q_scale and dO pairs take 2 x 2 x 64 D x 4
// bytes a warpgroup, 64 KB at D = 64 and 128 KB at D = 128; a kv entry
// is 2 x kBK D x 4 bytes.
//   D = 16, 32: two warpgroups, kBK = 64, 6 entries (two tiles deep):
//     84,632 and 166,552 bytes.
//   D = 64: two warpgroups (128 KB of pairs), kBK = 64, 3 entries of 32
//     KB: 231,248 bytes.
//   D = 128: one warpgroup (128 KB of pairs); a 64-row entry would be 64
//     KB, so kBK = 32 (DkvF32's kBQ at D = 128 for the same reason), 3
//     entries of 32 KB: 230,864 bytes.
// A consumer holds the dQ accumulator (D / 2 registers), S and its small
// terms (kBK / 2 each), dP and a fresh accumulator for its one-k-step
// chains (kBK / 2 each), then dS's (hi, lo) fragments (kBK) beside a fresh
// accumulator for dQ's chain (at most 64 output columns: 32): at D = 64,
// 32 + 32 + 32 (S), 32 + 32 + 32 + 32 (dP) or 32 + 64 + 32 (dQ), 128 at
// most; at D = 128, 64 + 16 + 16 + 16 + 16 or 64 + 32 + 32. ptxas keeps
// more (168 with 136-156 bytes of spill at D = 64, 255 at 128): it holds
// the resident tiles' loop-invariant descriptors across the kv loop.
// Forming them inside the loop and pipelining dP over two fresh
// accumulators took the spill away but ran slower (30% at 128).
//
// Precision. S sums its small terms (lo.hi, hi.lo) in an accumulator of
// their own (mma3_ss), so the hi.hi chain that truncates against the
// running sum is D / 8 products long. dP is formed one k-step a chain,
// each k-step's three products into a fresh accumulator, summed in f32:
// where P is 1 (N = 1, or a sample with one unmasked kv column), dS = P
// (dP - delta) is rounding noise around 0, and a chain that truncates
// against its running sum makes that noise biased and several times
// f32's (wgmma_tf32_wide.cuh's dK/dV notes). dQ's chain over the tile's
// kBK rows runs into a fresh accumulator, added to dQ in f32.
//
// Numerics (_mh_dqkv_kernel's in f32): q * q_scale in f32; the (B, N)
// bias added after the fold (finite: a row with every kv column masked
// gets the reference's answer); kv columns >= N score -inf; base e, P =
// exp(S + bias - lse) not rounded; dS = P (dP - delta) with delta (B, H,
// N) from the caller (fa.mh_delta); K is scaled by k_scale (k times the
// true scale, rounded to f32, as khs_all at :571) before its split, as
// the reference scales k before its product. Rows past N arrive as zeros
// from TMA; q rows >= N carry +inf LSE (P = 0) and are never stored.

#pragma once

#include <math.h>

#include "wgmma_tf32_wide.cuh"

namespace {

template <int D>
struct DqF32 {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the narrow head dims");
  static constexpr int kWGs = D == 128 ? 1 : 2;   // consumer warpgroups
  static constexpr int kBK = D == 128 ? 32 : 64;  // kv rows of a tile
  static constexpr int kQE = 64 * D;              // floats of a q-side tile
  static constexpr int kKE = kBK * D;             // floats of a kv tile
  static constexpr int kEntries = D <= 32 ? 6 : 3;
  static constexpr int kThreads = (kWGs + 1) * kWarpgroup;
  static constexpr size_t smem() {
    return 1024 +
           ((size_t)4 * kWGs * kQE + 2 * kEntries * kKE + kEntries * kBK) *
               sizeof(float) +
           (3 * kEntries + 1) * sizeof(uint64_t);
  }
};

// Grid (ceil(N / (64 kWGs)), B * H). One block: 64 kWGs query rows of one
// head against all N keys, streamed in kBK-row tiles; dQ accumulates in
// registers and goes to dq at row stride lddq. The four maps cover q, k,
// v and dO (B, N, A) at their own row strides, in boxes of kBK rows.
template <int D, bool kBias>
__global__ void __launch_bounds__(DqF32<D>::kThreads, 1)
    mh_dq_f32(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ bias, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              int lddq, int N, int H, float q_scale, float k_scale) {
  using P = DqF32<D>;
  constexpr int kQE = P::kQE, kKE = P::kKE, kBK = P::kBK;
  constexpr int kE = P::kEntries, kWGs = P::kWGs, NK = kBK / 8;
  extern __shared__ unsigned char wsmem[];
  // per warpgroup: q * q_scale hi, lo, then dO hi, lo
  float* sQ = reinterpret_cast<float*>(smem_1024(wsmem));
  float* sE = sQ + 4 * kWGs * kQE;    // entry s: hi, then lo
  float* sBias = sE + 2 * kE * kKE;   // entry s's bias row (K entries)
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kE * kBK);
  uint64_t* empty = full + kE;
  uint64_t* landed = empty + kE;
  uint64_t* qbar = landed + kE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kWGs * 64;
  const int T = (N + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kE; ++s) {
      mbar_init(&full[s], kWarpgroup);  // every producer thread
      mbar_init(&empty[s], 4 * kWGs);   // one arrival per consumer warp
      mbar_init(&landed[s], 1);         // the TMA load
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWGs) {  // producer: loads and splits
    if constexpr (kWGs == 2) producer_registers_f32();
    const int p = threadIdx.x - 4 * kWGs * 32;
    const int n = 3 * T;
    // entry e of kv tile e / 3: K (kind 0) and V (1) into the hi tile, K
    // to be transposed (2) into the lo tile
    auto issue = [&](int e) {
      const int s = e % kE, kind = e % 3;
      mbar_wait(&empty[s], ((e / kE) & 1) ^ 1);
      mbar_expect_tx(&landed[s], kKE * sizeof(float));
      tma_f32<kBK, D, kBK>(sE + (2 * s + (kind == 2)) * kKE,
                           kind == 1 ? &tv : &tk, &landed[s], h * D,
                           (e / 3) * kBK, b);
    };
    if (p == 0) {
      mbar_expect_tx(qbar, 2 * kWGs * kQE * sizeof(float));
      for (int w = 0; w < kWGs; ++w) {
        tma_f32<64, D, kBK>(sQ + 4 * w * kQE, &tq, qbar, h * D,
                            q0 + 64 * w, b);
        tma_f32<64, D, kBK>(sQ + (4 * w + 2) * kQE, &tdo, qbar, h * D,
                            q0 + 64 * w, b);
      }
      issue(0);
    }
    const float* bias_b = kBias ? bias + (size_t)b * N : nullptr;
    for (int e = 0; e < n; ++e) {
      if (p == 0 && e + 1 < n) issue(e + 1);
      const int s = e % kE, kind = e % 3;
      float* hi = sE + 2 * s * kKE;
      mbar_wait(&landed[s], (e / kE) & 1);
      if (kind == 2)
        split_transposed<kBK, D>(hi + kKE, hi, hi + kKE, k_scale, p,
                                 kProducerBar);
      else
        split_rows<kBK, D>(hi, hi + kKE, 1.f, p);
      if (kBias && kind == 0)
        for (int c = p; c < kBK; c += kWarpgroup) {
          const int col = (e / 3) * kBK + c;
          sBias[s * kBK + c] = col < N ? bias_b[col] : -INFINITY;
        }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  } else {
    if constexpr (kWGs == 2) consumer_registers_f32();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    float* sq = sQ + 4 * wg * kQE;  // q * q_scale: hi, lo
    float* so = sq + 2 * kQE;       // dO: hi, lo
    float lse_r[2], delta_r[2];     // rows >= N: P = 0, dS = 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + 64 * wg + r0 + g + 8 * half;
      lse_r[half] = row < N ? lse[(size_t)bh * N + row] : INFINITY;
      delta_r[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
    }
    mbar_wait(qbar, 0);
    split_rows<64, D>(sq, sq + kQE, q_scale, threadIdx.x & 127);
    split_rows<64, D>(so, so + kQE, 1.f, threadIdx.x & 127);
    fence_proxy_async();
    warpgroup_sync(2 + wg);
    float dqa[D / 8][4] = {};

    for (int j = 0; j < T; ++j) {
      int s[3], par[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s[i] = (3 * j + i) % kE;
        par[i] = ((3 * j + i) / kE) & 1;
      }
      const float* kt = sE + 2 * s[0] * kKE;   // K: hi, lo
      const float* vt = sE + 2 * s[1] * kKE;   // V
      const float* ktt = sE + 2 * s[2] * kKE;  // (K * k_scale)^T
      // S = (q * q_scale) K^T, its small terms apart
      float sc[NK][4] = {}, sc_small[NK][4] = {};
      mbar_wait(&full[s[0]], par[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma3_ss(sc, sc_small, desc_k8<64, D>(sq, kk),
                desc_k8<64, D>(sq + kQE, kk), desc_k8<kBK, D>(kt, kk),
                desc_k8<kBK, D>(kt + kKE, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(sc_small);
      add_small(sc, sc_small);
      // the bias after the fold (-inf past N), read before the K slot
      // is released
      if constexpr (kBias) {
        const float* sb = sBias + s[0] * kBK;
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] += (e & 1) ? b2.y : b2.x;
        }
      } else if ((j + 1) * kBK > N) {  // the ragged last tile
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * kBK + 8 * nt + 2 * t + (e & 1) >= N)
              sc[nt][e] = -INFINITY;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s[0]]);
      // dP = dO V^T, one k-step a fresh accumulator, summed in f32
      float dp[NK][4];
      mbar_wait(&full[s[1]], par[1]);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        float f[NK][4] = {};
        const uint64_t a_hi = desc_k8<64, D>(so, kk);
        const uint64_t b_hi = desc_k8<kBK, D>(vt, kk);
        wgmma_fence();
        wgmma_tf32_ss(f, desc_k8<64, D>(so + kQE, kk), b_hi);
        wgmma_tf32_ss(f, a_hi, desc_k8<kBK, D>(vt + kKE, kk));
        wgmma_tf32_ss(f, a_hi, b_hi);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(f);
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[nt][e] = kk ? dp[nt][e] + f[nt][e] : f[nt][e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s[1]]);
      // P = exp(S + bias - lse), dS = P (dP - delta), in dp
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = expf(sc[nt][e] - lse_r[e >> 1]);
          dp[nt][e] = pv * (dp[nt][e] - delta_r[e >> 1]);
        }
      uint32_t dh[NK][4], dl[NK][4];  // dS, as (hi, lo), permuted K order
      acc_to_a(dp, dh, dl);
      mbar_wait(&full[s[2]], par[2]);
      add_fresh<D>(dqa, [&](auto& f, uint64_t off) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          mma3_rs(f, dh[kk], dl[kk], desc_k8<D, kBK>(ktt, kk) + off,
                  desc_k8<D, kBK>(ktt + kKE, kk) + off);
      });
      fence_frag(dh);
      fence_frag(dl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s[2]]);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + 64 * wg + r0 + g + 8 * half;
      if (row >= N) continue;
      float* dst = dq + ((size_t)b * N + row) * lddq + h * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            make_float2(dqa[nt][2 * half], dqa[nt][2 * half + 1]);
    }
  }
}

// A (B, N, A) f32 operand at row stride ld (a multiple of 4: TMA wants
// 16-byte rows) in boxes of sub_cols<D>() columns and box_rows rows.
template <int D>
int dq_map(CUtensorMap* map, const void* base, int B, int N, int A, int ld,
           int box_rows) {
  if (ld % 4) return kBadArgument;
  return tile_map_f32(map, base, A, N, B, ld, (long)N * ld, sub_cols<D>(),
                      box_rows);
}

// The f32 dQ at head dim D (16 to 256): the narrow kernel up to 128, the
// chunked one (wgmma_tf32_wide.cuh) at 192 and 256. dq at row stride
// lddq; delta (B, H, N) from the caller; bias (B, N) or null.
template <int D>
int launch_dq_tf32(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int N, int H,
                   int ldq, int ldk, int ldv, int lddq, float q_scale,
                   float k_scale, cudaStream_t st) {
  if constexpr (D >= 192) {
    return launch_dq_tf32_wide<D>(q, k, v, bias, dout, lse, delta, dq, B, N,
                                  H, ldq, ldk, ldv, lddq, q_scale, k_scale,
                                  st);
  } else {
    using P = DqF32<D>;
    const int A = H * D;
    CUtensorMap tq, tk, tv, tdo;
    if (int e = dq_map<D>(&tq, q, B, N, A, ldq, P::kBK)) return e;
    if (int e = dq_map<D>(&tk, k, B, N, A, ldk, P::kBK)) return e;
    if (int e = dq_map<D>(&tv, v, B, N, A, ldv, P::kBK)) return e;
    if (int e = dq_map<D>(&tdo, dout, B, N, A, A, P::kBK)) return e;
    constexpr size_t smem = P::smem();
    const dim3 grid((N + 64 * P::kWGs - 1) / (64 * P::kWGs), B * H);
    auto kernel = bias ? mh_dq_f32<D, true> : mh_dq_f32<D, false>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<grid, P::kThreads, smem, st>>>(
        tq, tk, tv, tdo, bias, lse, delta, static_cast<float*>(dq), lddq, N,
        H, q_scale, k_scale);
    return 0;
  }
}

}  // namespace
