// The bf16 attention backward for Hopper that qkv_flash_attention.cu (K2,
// fused-qkv layout, base 2), hm_flash_attention.cu (K4, head-major layout,
// base e) and mh_flash_attention.cu (K3: separate q, k, v with a kv bias
// row, base 2) share at head dims up to 128: a prep pass and the dK/dV and
// dQ kernels, built from wgmma_tiles.cuh. The layout, the softmax base and
// the bias are the parameters. At head dims 192 and 256 the three families
// run the strip kernels of wgmma_attn_wide.cuh instead, after the same prep
// pass.
//
// Layout. Every operand is reached through a 3D tensor map (columns, rows,
// planes) of 64 x D boxes (D in {16, 32, 64, 128}; at 128 a tile is two
// 64 x 64 boxes, wgmma_tiles.cuh's *_d helpers: the kernels and launchers
// take D as a template parameter, 64 by default),
// and block (x, y) works on plane b = y / H at columns h * D + a
// per-operand offset, h = y % H:
//   - fused qkv (B, N, 3A): one map serves q, k and v, H heads a plane, k at
//     column offset A, v at 2A; outputs go to columns of one dqkv, row stride
//     3A;
//   - head-major (BH, N, D): H = 1, every offset 0, each operand its own
//     map; outputs are (BH, N, D), row stride D;
//   - separate q, k, v (B, N, H D), each with its own row stride (k and v
//     may be column views of a fused kv): every offset 0, each operand its
//     own map; dk and dv share one row stride.
// Rows past N arrive as zeros (the maps' planes are N rows), and P = 0 for
// kv columns >= N and q rows >= N in-kernel. lse and delta are (planes * H,
// N) f32.
//
// Base. With kBaseE the LSE is a natural log and the scores carry the plain
// scale: P = exp2(s * log2 e - lse * log2 e), the LSE scaled once where it
// is staged. Otherwise the scores carry scale * log2 e and the LSE is in
// log2 units: P = exp2(s - lse), and the caller's dk_fix = 1 / log2 e
// rescales dK.
//
// Design. The prep pass reads q, O and dO once and writes delta =
// rowsum(dO * O) (f32) and q * q_scale in bf16, and k * k_scale when that
// scale is not a power of two; the two kernels then stream plain tiles and
// never read O. Each is two consumer warpgroups (64 rows of
// wgmma.mma_async m64n64k16 each, 232 registers) and a producer warpgroup
// (40 registers) whose first warp keeps a ring of kBwdStages stages full by
// TMA; in dK/dV its lanes also copy the 64 LSE and delta values of each q
// tile into the stage. The split into dK/dV over kv tiles and dQ over q
// tiles keeps one writer per output: no atomics, deterministic sums.
//
// Bias. With kBias a (planes, N) f32 row (or null: zeros) is added to the
// scores after the scale fold, before exp2f: dK/dV reads the two values of
// each thread's own kv rows once, dQ's producer lanes stage the 64 values of
// each kv tile beside it (-inf past N). Without kBias the kernels compile to
// what they were before the flag.
//
// Numerics: P is rounded to bf16; dS = bf16(P) * bf16(dP - delta), the
// subtraction in f32, rounded to bf16. dQ = dS (K * k_scale): with a
// power-of-two k_scale the f32 accumulator of dS K is scaled at the store,
// which is the same number bit for bit.

#pragma once

#include <math.h>

#include <algorithm>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kBwdStages = 2;
constexpr int kPrepThreads = 256;

// The lanes one head's row takes in the prep pass: its kHeadChunks chunks
// of 8 values, or a whole warp for the 24 of head dim 192 (8 lanes idle).
template <int kHeadChunks>
__host__ __device__ constexpr int prep_lanes() {
  return kHeadChunks == 24 ? 32 : kHeadChunks;
}

// Grid-stride over the 8-value chunks of BN rows of A = 8 kHeadChunks H
// columns: chunk c of row i is q[i, 8c..8c+7] (row stride ldq; k the same
// with ldk) and the same columns of dO, O, qs and ks (row stride A).
// kHeadChunks consecutive chunks are one head (2, 4, 8, 16, 24 or 32 at head
// dims 16, 32, 64, 128, 192 or 256), each on prep_lanes() lanes of one warp
// (a warp never straddles two heads), so delta is a shuffle sum over those
// lanes, written at ((i / N) * H + c / kHeadChunks) * N + i % N. ks (when
// not null) gets k * k_scale rounded to bf16.
template <int kHeadChunks>
__global__ void __launch_bounds__(kPrepThreads)
    bwd_prep_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  int ldq, int ldk, const bf16* __restrict__ out,
                  const bf16* __restrict__ dout, float* __restrict__ delta,
                  bf16* __restrict__ qs, bf16* __restrict__ ks, int BN, int N,
                  int H, float q_scale, float k_scale) {
  static_assert(kHeadChunks == 2 || kHeadChunks == 4 || kHeadChunks == 8 ||
                    kHeadChunks == 16 || kHeadChunks == 24 ||
                    kHeadChunks == 32,
                "head dim 16, 32, 64, 128, 192 or 256");
  constexpr int kLanes = prep_lanes<kHeadChunks>();
  const int A = H * 8 * kHeadChunks, C = A / 8;
  const int total = BN * H * kLanes;  // < 2^31: launch_bwd_prep's bound
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int i0 = blockIdx.x * blockDim.x + (threadIdx.x - lane); i0 < total;
       i0 += stride) {  // i0 is uniform across the warp
    const int i = i0 + lane;
    bool on = i < total;
    int row, c;
    if constexpr (kLanes == kHeadChunks) {
      row = on ? i / C : 0;
      c = on ? i - row * C : 0;
    } else {  // slot i: lane `part` of (row, head) i / kLanes
      const int hr = i / kLanes, part = i - hr * kLanes;
      on = on && part < kHeadChunks;
      row = on ? hr / H : 0;
      c = on ? (hr - row * H) * kHeadChunks + part : 0;
    }
    float acc = 0.f;
    if (on) {
      const size_t at = (size_t)row * A + 8 * c;
      const uint4 a = *reinterpret_cast<const uint4*>(dout + at);
      const uint4 o = *reinterpret_cast<const uint4*>(out + at);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(x[e]);
        const float2 fy = __bfloat1622float2(y[e]);
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
      for (int part = 0; part < (ks ? 2 : 1); ++part) {
        const size_t from = (size_t)row * (part ? ldk : ldq) + 8 * c;
        uint4 v = *reinterpret_cast<const uint4*>((part ? k : q) + from);
        const float mul = part ? k_scale : q_scale;
        __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(z[e]);
          z[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
        }
        *reinterpret_cast<uint4*>((part ? ks : qs) + at) = v;
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (on && c % kHeadChunks == 0) {
      const int b = row / N, n = row - b * N;
      delta[((size_t)b * H + c / kHeadChunks) * N + n] = acc;
    }
  }
}

// The LSE as the kernels subtract it from a score (see "Base" above).
template <bool kBaseE>
__device__ __forceinline__ float staged_lse(float lse) {
  return kBaseE ? lse * kLog2e : lse;
}

// P (rounded to bf16) and dS = bf16(P * bf16(dP - delta)) of one pair of
// accumulator values, as the packed A-fragment words of the next products.
// lse0 and lse1 are staged_lse values; +inf gives P = 0.
template <bool kBaseE>
__device__ __forceinline__ void p_and_ds_pair(float s0, float s1, float dp0,
                                              float dp1, float lse0,
                                              float lse1, float d0, float d1,
                                              uint32_t& pw, uint32_t& dsw) {
  pw = kBaseE ? bf16x2(exp2f(fmaf(s0, kLog2e, -lse0)),
                       exp2f(fmaf(s1, kLog2e, -lse1)))
              : bf16x2(exp2f(s0 - lse0), exp2f(s1 - lse1));
  const uint32_t dd = bf16x2(dp0 - d0, dp1 - d1);
  dsw = bf16x2(bf16_lo(pw) * bf16_lo(dd), bf16_hi(pw) * bf16_hi(dd));
}

template <int D>
constexpr size_t smem_dkv_bf16() {
  return 1024 + (size_t)(2 * kWG + 2 * kBwdStages) * tile_bytes<D>() +
         kBwdStages * 2 * kTileRows * sizeof(float) +
         (2 * kBwdStages + 1) * sizeof(uint64_t);
}

// Grid (ceil(N / (64 kWG)), planes * H). One block: one head's 64 kWG
// key/value rows (K fragments in registers, V in shared memory; at D = 128
// K too is read from shared memory, which keeps 32 registers a thread for
// the dK and dV accumulators' 128); streams
// (q * scale, dO) tiles and their LSE and delta, and accumulates dK and dV
// in registers. Each warpgroup forms S^T = K Q^T and dP^T = V dO^T for its
// kv rows, so P^T and dS^T feed dV += P^T dO and dK += dS^T Q straight from
// the accumulators. dk and dv point at head 0's column of plane 0, row
// stride ld_out. bias (kBias only): (planes, N) f32 or null.
template <bool kBaseE, bool kBias, int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    bwd_dkv_bf16(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tqs,
                 const __grid_constant__ CUtensorMap tdo, int col_k,
                 int col_v, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int ld_out, int N, int H,
                 float dk_fix) {
  constexpr int kTE = tile_elems<D>(), kTB = tile_bytes<D>();
  constexpr bool kKInRegs = D <= 64;
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sK = reinterpret_cast<bf16*>(sm);
  bf16* sV = sK + kWG * kTE;
  bf16* sQ = sV + kWG * kTE;
  bf16* sdO = sQ + kBwdStages * kTE;
  float* sStat = reinterpret_cast<float*>(sdO + kBwdStages * kTE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sStat + 2 * kBwdStages * kTileRows);
  uint64_t* empty = full + kBwdStages;
  uint64_t* kvbar = empty + kBwdStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the stats' lanes
      mbar_init(&empty[s], 4 * kWG);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG) {  // its lanes load the stats, lane 0 the tiles
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * kWG * kTB);
        for (int w = 0; w < kWG; ++w) {
          const int row = k0 + kTileRows * w;
          tma_tile_d<D>(sK + w * kTE, &tk, kvbar, col_k + h * D, row, b);
          tma_tile_d<D>(sV + w * kTE, &tv, kvbar, col_v + h * D, row, b);
        }
      }
      const float* lse_bh = lse + (size_t)bh * N;
      const float* delta_bh = delta + (size_t)bh * N;
      for (int j = 0; j < T; ++j) {
        const int s = j % kBwdStages;
        mbar_wait(&empty[s], ((j / kBwdStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kTB);
          tma_tile_d<D>(sQ + s * kTE, &tqs, &full[s], h * D, j * kTileRows,
                        b);
          tma_tile_d<D>(sdO + s * kTE, &tdo, &full[s], h * D, j * kTileRows,
                        b);
        }
        float* st = sStat + s * 2 * kTileRows;
        for (int r = lane; r < kTileRows; r += 32) {
          const int row = j * kTileRows + r;  // rows >= N: P = 0, dS = 0
          st[r] = row < N ? staged_lse<kBaseE>(lse_bh[row]) : INFINITY;
          st[kTileRows + r] = row < N ? delta_bh[row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int t = lane & 3;
    float bias_r[2] = {0.f, 0.f};  // of this thread's two kv rows
    if (kBias && bias) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // rows >= N are never stored: any finite bias will do
        const int row = k0 + kTileRows * wg + r0 + (lane >> 2) + 8 * half;
        if (row < N) bias_r[half] = bias[(size_t)b * N + row];
      }
    }
    mbar_wait(kvbar, 0);
    // V stays in shared memory: A of dP^T through desc (K too at D = 128)
    uint32_t ka[kKInRegs ? D / 16 : 1][4];
    if constexpr (kKInRegs) load_a_sw(ka, sK + wg * kTE, r0, 1.f);
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};

    for (int j = 0; j < T; ++j) {
      const int s = j % kBwdStages;
      mbar_wait(&full[s], (j / kBwdStages) & 1);
      const bf16* q_tile = sQ + s * kTE;
      const bf16* do_tile = sdO + s * kTE;
      float st[8][4] = {}, dpt[8][4] = {};
      if constexpr (kKInRegs)
        wgmma_tile_d<0, D>(st, ka, q_tile);
      else
        wgmma_tile_ss_d<D>(st, sK + wg * kTE, q_tile);
      wgmma_tile_ss_d<D>(dpt, sV + wg * kTE, do_tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      const float* sl = sStat + s * 2 * kTileRows;
      const float* sd = sl + kTileRows;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * t;  // the q row within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sd + col);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          if (kBias) {  // after the scale fold
            st[nt][e] += bias_r[e >> 1];
            st[nt][e + 1] += bias_r[e >> 1];
          }
          p_and_ds_pair<kBaseE>(st[nt][e], st[nt][e + 1], dpt[nt][e],
                                dpt[nt][e + 1], l2.x, l2.y, d2.x, d2.y,
                                pa[nt >> 1][2 * (nt & 1) + (e >> 1)],
                                da[nt >> 1][2 * (nt & 1) + (e >> 1)]);
        }
      }
      wgmma_tile_d<1, D>(dva, pa, do_tile);
      wgmma_tile_d<1, D>(dka, da, q_tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t off = (size_t)b * N * ld_out + h * D;
    const int row0 = k0 + kTileRows * wg + r0;
    store_acc(dk + off, ld_out, dka, row0, N, dk_fix);
    store_acc(dv + off, ld_out, dva, row0, N, 1.f);
  }
}

template <bool kScaledCopy, bool kBias, int D>
constexpr size_t smem_dq_bf16() {
  return 1024 +
         (size_t)(2 * kWG + (kScaledCopy ? 3 : 2) * kBwdStages) *
             tile_bytes<D>() +
         (kBias ? kBwdStages * kTileRows * sizeof(float) : 0) +
         (2 * kBwdStages + 1) * sizeof(uint64_t);
}

// Grid (ceil(N / (64 kWG)), planes * H). One block: one head's 64 kWG query
// rows (q * scale and dO fragments in registers); streams (K, V) tiles and
// accumulates dQ = dS K in registers, times acc_mul at the store. With
// kScaledCopy the dS K product reads K * k_scale from its own copy (a
// scale that is not a power of two); otherwise it reads the K tile of S and
// acc_mul = k_scale, which is the same in bf16. dq points at head 0's
// column of plane 0, row stride ld_out. With kBias the whole producer warp
// runs: lane 0 starts the loads, the lanes stage each tile's bias values
// ((planes, N) f32 or null; -inf past N).
template <bool kBaseE, bool kScaledCopy, bool kBias, int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    bwd_dq_bf16(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tqs,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tks, int col_k,
                int col_v, const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ bias, bf16* __restrict__ dq,
                int ld_out, int N, int H, float acc_mul) {
  constexpr int kLoads = kScaledCopy ? 3 : 2;
  constexpr int kTE = tile_elems<D>(), kTB = tile_bytes<D>();
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sdO = sQ + kWG * kTE;
  bf16* sKV = sdO + kWG * kTE;  // per stage: K, V (, K * k_scale)
  float* sBias =
      reinterpret_cast<float*>(sKV + kLoads * kBwdStages * kTE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      sBias + (kBias ? kBwdStages * kTileRows : 0));
  uint64_t* empty = full + kBwdStages;
  uint64_t* qbar = empty + kBwdStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], kBias ? 1 + 32 : 1);  // TMA (and the bias' lanes)
      mbar_init(&empty[s], 4 * kWG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG && (kBias || lane == 0)) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * kWG * kTB);
        for (int w = 0; w < kWG; ++w) {
          const int row = q0 + kTileRows * w;
          tma_tile_d<D>(sQ + w * kTE, &tqs, qbar, h * D, row, b);
          tma_tile_d<D>(sdO + w * kTE, &tdo, qbar, h * D, row, b);
        }
      }
      const float* bias_b = kBias && bias ? bias + (size_t)b * N : nullptr;
      for (int j = 0; j < T; ++j) {
        const int s = j % kBwdStages;
        bf16* stage = sKV + s * kLoads * kTE;
        mbar_wait(&empty[s], ((j / kBwdStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], kLoads * kTB);
          tma_tile_d<D>(stage, &tk, &full[s], col_k + h * D, j * kTileRows,
                        b);
          tma_tile_d<D>(stage + kTE, &tv, &full[s], col_v + h * D,
                        j * kTileRows, b);
          if (kScaledCopy)
            tma_tile_d<D>(stage + 2 * kTE, &tks, &full[s], h * D,
                          j * kTileRows, b);
        }
        if (kBias) {
          float* sb = sBias + s * kTileRows;
          for (int r = lane; r < kTileRows; r += 32) {
            const int col = j * kTileRows + r;  // -inf masks columns >= N
            sb[r] = col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
          }
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + kTileRows * wg + r0;
    float lse_r[2], delta_r[2];  // rows >= N: P = 0, dS = 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      lse_r[half] = row < N ? staged_lse<kBaseE>(lse[(size_t)bh * N + row])
                            : INFINITY;
      delta_r[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
    }
    mbar_wait(qbar, 0);
    uint32_t qa[D / 16][4], da[D / 16][4];
    load_a_sw(qa, sQ + wg * kTE, r0, 1.f);
    load_a_sw(da, sdO + wg * kTE, r0, 1.f);
    float acc[D / 8][4] = {};

    for (int j = 0; j < T; ++j) {
      const int s = j % kBwdStages;
      mbar_wait(&full[s], (j / kBwdStages) & 1);
      const bf16* stage = sKV + s * kLoads * kTE;
      float sc[8][4] = {}, dp[8][4] = {};
      wgmma_tile_d<0, D>(sc, qa, stage);
      wgmma_tile_d<0, D>(dp, da, stage + kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const bool ragged = (j + 1) * kTileRows > N;
      uint32_t sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (kBias) {  // after the scale fold
          const float2 b2 = *reinterpret_cast<const float2*>(
              sBias + s * kTileRows + 8 * nt + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] += (e & 1) ? b2.y : b2.x;
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int col = j * kTileRows + 8 * nt + 2 * t;
          // kv columns >= N: P = 0 (so dS = 0), whatever their score
          const float l0 = ragged && col >= N ? INFINITY : lse_r[e >> 1];
          const float l1 = ragged && col + 1 >= N ? INFINITY : lse_r[e >> 1];
          uint32_t pw;
          p_and_ds_pair<kBaseE>(sc[nt][e], sc[nt][e + 1], dp[nt][e],
                                dp[nt][e + 1], l0, l1, delta_r[e >> 1],
                                delta_r[e >> 1], pw,
                                sa[nt >> 1][2 * (nt & 1) + (e >> 1)]);
        }
      }
      wgmma_tile_d<1, D>(acc, sa, stage + (kScaledCopy ? 2 : 0) * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    store_acc(dq + (size_t)b * N * ld_out + h * D, ld_out, acc, row0, N,
              acc_mul);
  }
}

// -------------------------------------------------------------------------
// Launchers. B planes of N rows, H heads of D columns a plane; each returns
// 0, kBadArgument or a cudaError_t from the launch set-up (the caller reads
// cudaGetLastError after).
// -------------------------------------------------------------------------

dim3 hopper_grid(int B, int N, int H) {
  return dim3((N + kWG * kTileRows - 1) / (kWG * kTileRows), B * H);
}

bool power_of_two(float x) {
  int exponent;
  return frexpf(x, &exponent) == 0.5f;
}

// q (row stride ldq) and k (row stride ldk), out and dout (row stride
// A = 8 kHeadChunks H) -> delta, qs and, unless ks is null, ks.
template <int kHeadChunks>
int launch_bwd_prep(const void* q, const void* k, int ldq, int ldk,
                    const void* out, const void* dout, void* delta, void* qs,
                    void* ks, int B, int N, int H, float q_scale,
                    float k_scale, cudaStream_t st) {
  if ((long)B * N * std::max(ldq, ldk) >= (1l << 31)) return kBadArgument;
  const long chunks = (long)B * N * H * prep_lanes<kHeadChunks>();
  const int blocks = (int)std::min<long>(
      (chunks + kPrepThreads - 1) / kPrepThreads, 132 * 16);
  bwd_prep_bf16<kHeadChunks><<<blocks, kPrepThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), ldq, ldk,
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<bf16*>(qs),
      static_cast<bf16*>(ks), B * N, N, H, q_scale, k_scale);
  return 0;
}

template <bool kBaseE, bool kBias, int D = 64>
int launch_bwd_dkv(const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tqs, const CUtensorMap& tdo, int col_k,
                   int col_v, const void* lse, const void* delta,
                   const void* bias, void* dk, void* dv, int ld_out, int B,
                   int N, int H, float dk_fix, cudaStream_t st) {
  constexpr size_t smem = smem_dkv_bf16<D>();
  auto kernel = bwd_dkv_bf16<kBaseE, kBias, D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<hopper_grid(B, N, H), kHopperThreads, smem, st>>>(
      tk, tv, tqs, tdo, col_k, col_v, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), ld_out, N, H, dk_fix);
  return 0;
}

template <bool kBaseE, bool kScaledCopy, bool kBias, int D>
int launch_bwd_dq_as(const CUtensorMap& tk, const CUtensorMap& tv,
                     const CUtensorMap& tqs, const CUtensorMap& tdo,
                     const CUtensorMap& tks, int col_k, int col_v,
                     const void* lse, const void* delta, const void* bias,
                     void* dq, int ld_out, int B, int N, int H,
                     float acc_mul, cudaStream_t st) {
  constexpr size_t smem = smem_dq_bf16<kScaledCopy, kBias, D>();
  auto kernel = bwd_dq_bf16<kBaseE, kScaledCopy, kBias, D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<hopper_grid(B, N, H), kHopperThreads, smem, st>>>(
      tk, tv, tqs, tdo, tks, col_k, col_v, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dq), ld_out, N, H, acc_mul);
  return 0;
}

// tks is null when k_scale is a power of two (the accumulator is scaled);
// otherwise it maps the prep pass's k * k_scale.
template <bool kBaseE, bool kBias, int D = 64>
int launch_bwd_dq(const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& tqs, const CUtensorMap& tdo,
                  const CUtensorMap* tks, int col_k, int col_v,
                  const void* lse, const void* delta, const void* bias,
                  void* dq, int ld_out, int B, int N, int H, float k_scale,
                  cudaStream_t st) {
  if (!tks && !power_of_two(k_scale)) return kBadArgument;
  return tks ? launch_bwd_dq_as<kBaseE, true, kBias, D>(
                   tk, tv, tqs, tdo, *tks, col_k, col_v, lse, delta, bias,
                   dq, ld_out, B, N, H, 1.f, st)
             : launch_bwd_dq_as<kBaseE, false, kBias, D>(
                   tk, tv, tqs, tdo, tqs, col_k, col_v, lse, delta, bias, dq,
                   ld_out, B, N, H, k_scale, st);
}

}  // namespace
