// Head-major single-head flash attention for Hopper (sm_90a): forward and the
// two halves of the backward on (B*H, N, D) q, k and v. Plain C interface,
// loaded from Python with ctypes (mofo_tpu_torch/ops/flash_attention.py);
// built by mofo_tpu_torch/ops/_build.py with the other csrc/*.cu sources.
// The tile loads, products and reductions are flash_tiles.cuh's.
//
// Replaces the TPU kernel K4 of mofo_tpu/ops/flash_attention.py:
//   hm_attn_fwd      <- _fwd_impl (:262) / _fwd_kernel (:130)
//   hm_attn_bwd_dq   <- _bwd_impl (:304) / _dq_kernel (:160)
//   hm_attn_bwd_dkv  <- _bwd_impl (:304) / _dkv_kernel (:204)
//
// Layout. q, k, v, out, dout, dq, dk and dv are (BH, N, D) contiguous with
// D = 64: the ViT-S pretrain decoder's 3 x 64 heads, which take the
// head-major route of models/layers.Attention because A = 192 is not a
// multiple of 128. The forward writes a (BH, N) f32 LSE in natural-log units;
// the backward takes delta = rowsum(dO * O), (BH, N) f32, from the caller.
//
// What bounds it on this card. At the ViT-S decoder (BH = 96, N = 1568) each
// head does N^2 D multiply-adds per product on 2 N D bytes per operand: the
// kernels are bound by operations (the bf16 tensor-core rate), not bytes.
//
// What the design does about it. Every product of the bf16 kernels runs on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); four warps
// own 16 rows each of a 64-row tile and the other side streams in 64-row
// tiles. The f32 kernels (the parity path) use FMAs, since tensor cores would
// round f32 to TF32. The TPU rounds the normalized p / l before P.V, which an
// online softmax cannot do (it rounds exp(s - m_running)): so the forward
// makes two passes over kv, the first for the row max and sum, the second for
// P = exp(s - m) / l and P.V, one product more than an online softmax. The
// backward is two kernels (dK/dV over kv tiles, dQ over q tiles), so each
// output has one writer and no atomics. Ragged N is masked in-kernel: kv
// columns >= N and q rows >= N get P = 0; nothing is padded in HBM. wgmma,
// TMA and pipelined loads are later work.
//
// Numerics (those of the TPU kernel, which the tests hold the plain
// versions against):
//   - the softmax scale is folded into q in the input dtype;
//   - scores and softmax statistics are f32, in base e in every dtype;
//   - p / l is rounded to the input dtype before P.V;
//   - dQ takes k times the scale rounded to the input dtype, dK the scaled
//     q of the score;
//   - in bf16 dS is the bf16 product of bf16(P) with bf16(dP - delta), the
//     subtraction in f32; in f32 it is P * (dP - delta).

#include "flash_tiles.cuh"

namespace {

constexpr int kD = 64;     // the one head dim the kernels take
constexpr int kTile = 64;  // rows of the streamed tiles (and of f32 q tiles)

// One q tile's LSE and delta; rows >= N get 0 (their P is masked).
__device__ __forceinline__ void load_stats(float* sLse, float* sDelta,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int N, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    sLse[i] = row < N ? lse[row] : 0.f;
    sDelta[i] = row < N ? delta[row] : 0.f;
  }
}

// -------------------------------------------------------------------------
// f32: FMA kernels (flash_tiles.cuh's 16 x 16 thread layout)
// -------------------------------------------------------------------------

template <int BQ, int BK>
constexpr size_t smem_fwd_f32() {
  return ((size_t)(BQ + 2 * BK) * (kD + 1) + BQ * (BK + 1)) * sizeof(float);
}

// Grid (ceil(N / BQ), BH). One block: BQ query rows of one head against all
// N keys, in two passes over BK-row kv tiles.
template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    hm_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int N, float q_scale) {
  constexpr int D = kD, I = BQ / 16, JS = BK / 16, JO = D / 16, LD = D + 1,
                LDP = BK + 1;
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_f32<BQ, D>(sQ, q + base, q0, N, D, q_scale);
  float m[I], l[I];
#pragma unroll
  for (int i = 0; i < I; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {  // pass 1: row max and sum
    __syncthreads();  // sQ is written / the previous tile's reads are done
    load_f32<BK, D>(sK, k + base, k0, N, D, 1.f);
    __syncthreads();
    float s[I][JS] = {};
    gemm<I, JS, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < JS; ++j)
        if (k0 + tx + 16 * j < N) mx = fmaxf(mx, s[i][j]);
      // every tile holds a column < N, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JS; ++j)
        if (k0 + tx + 16 * j < N) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
  }

  float o[I][JO] = {};
  for (int k0 = 0; k0 < N; k0 += BK) {  // pass 2: P = exp(s - m) / l, P.V
    __syncthreads();
    load_f32<BK, D>(sK, k + base, k0, N, D, 1.f);
    load_f32<BK, D>(sV, v + base, k0, N, D, 1.f);
    __syncthreads();
    float s[I][JS] = {};
    gemm<I, JS, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int c = tx + 16 * j;
        sP[(I * ty + i) * LDP + c] =
            k0 + c < N ? expf(s[i][j] - m[i]) / l[i] : 0.f;
      }
    __syncthreads();
    gemm<I, JO, BK, LDP, 1, LD, 1>(o, sP, sV, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + I * ty + i;
    if (row >= N) continue;
    float* dst = out + base + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = o[i][j];
    if (tx == 0) lse[(size_t)blockIdx.y * N + row] = m[i] + logf(l[i]);
  }
}

template <int BQ, int BK>
constexpr size_t smem_dq_f32() {
  return ((size_t)(2 * BQ + 2 * BK) * (kD + 1) + BQ * (BK + 1) + 2 * BQ) *
         sizeof(float);
}

// Grid (ceil(N / BQ), BH). One block: BQ query rows of one head; loops over
// all kv tiles and accumulates dQ = dS (K * scale) in registers.
template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    hm_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int N, float q_scale, float k_scale) {
  constexpr int D = kD, I = BQ / 16, JS = BK / 16, JO = D / 16, LD = D + 1,
                LDP = BK + 1;
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;
  float* sLse = sdS + BQ * LDP;
  float* sDelta = sLse + BQ;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_f32<BQ, D>(sQ, q + base, q0, N, D, q_scale);
  load_f32<BQ, D>(sdO, dout + base, q0, N, D, 1.f);
  load_stats(sLse, sDelta, lse + (size_t)blockIdx.y * N,
             delta + (size_t)blockIdx.y * N, q0, N, BQ);
  float acc[I][JO] = {};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the q side is written / the last tile is consumed
    load_f32<BK, D>(sK, k + base, k0, N, D, 1.f);
    load_f32<BK, D>(sV, v + base, k0, N, D, 1.f);
    __syncthreads();
    float s[I][JS] = {}, dp[I][JS] = {};
    gemm<I, JS, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
    gemm<I, JS, D, LD, 1, 1, LD>(dp, sdO, sV, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int r = I * ty + i;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int c = tx + 16 * j;
        const float p = k0 + c < N ? expf(s[i][j] - sLse[r]) : 0.f;
        sdS[r * LDP + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    gemm<I, JO, BK, LDP, 1, LD, 1>(acc, sdS, sK, ty, tx, k_scale);
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + I * ty + i;
    if (row >= N) continue;
    float* dst = dq + base + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = acc[i][j];
  }
}

template <int BKV, int BQ>
constexpr size_t smem_dkv_f32() {
  return ((size_t)(2 * BKV + 2 * BQ) * (kD + 1) + 2 * BKV * (BQ + 1) +
          2 * BQ) * sizeof(float);
}

// Grid (ceil(N / BKV), BH). One block: BKV key/value rows of one head; loops
// over all q tiles and accumulates dK and dV in registers. It forms
// S^T = K Q^T and dP^T = V dO^T directly (rows kv, columns q), so P^T and
// dS^T are row-major A operands of dV += P^T dO and dK += dS^T Q.
template <int BKV, int BQ>
__global__ void __launch_bounds__(kThreads)
    hm_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, float q_scale) {
  constexpr int D = kD, I = BKV / 16, JQ = BQ / 16, JO = D / 16, LD = D + 1,
                LDP = BQ + 1;
  extern __shared__ float fsmem[];
  float* sK = fsmem;
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sdS = sP + BKV * LDP;
  float* sLse = sdS + BKV * LDP;
  float* sDelta = sLse + BQ;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int k0 = blockIdx.x * BKV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_f32<BKV, D>(sK, k + base, k0, N, D, 1.f);
  load_f32<BKV, D>(sV, v + base, k0, N, D, 1.f);
  float dka[I][JO] = {}, dva[I][JO] = {};

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_f32<BQ, D>(sQ, q + base, q0, N, D, q_scale);
    load_f32<BQ, D>(sdO, dout + base, q0, N, D, 1.f);
    load_stats(sLse, sDelta, lse + (size_t)blockIdx.y * N,
               delta + (size_t)blockIdx.y * N, q0, N, BQ);
    __syncthreads();
    float st[I][JQ] = {}, dpt[I][JQ] = {};
    gemm<I, JQ, D, LD, 1, 1, LD>(st, sK, sQ, ty, tx, 1.f);
    gemm<I, JQ, D, LD, 1, 1, LD>(dpt, sV, sdO, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int r = I * ty + i;
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        const int c = tx + 16 * j;
        const float p = q0 + c < N ? expf(st[i][j] - sLse[c]) : 0.f;
        sP[r * LDP + c] = p;
        sdS[r * LDP + c] = p * (dpt[i][j] - sDelta[c]);
      }
    }
    __syncthreads();
    gemm<I, JO, BQ, LDP, 1, LD, 1>(dva, sP, sdO, ty, tx, 1.f);
    gemm<I, JO, BQ, LDP, 1, LD, 1>(dka, sdS, sQ, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = k0 + I * ty + i;
    if (row >= N) continue;
    const size_t off = base + (size_t)row * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) {
      dk[off + 16 * j] = dka[i][j];
      dv[off + 16 * j] = dva[i][j];
    }
  }
}

// -------------------------------------------------------------------------
// bf16: tensor-core kernels (flash_tiles.cuh's mma.sync layout)
// -------------------------------------------------------------------------

template <int BK>
constexpr size_t smem_fwd_bf16() {
  return (size_t)(kRowsH + 2 * BK) * (kD + 8) * sizeof(bf16);
}

// Grid (ceil(N / 64), BH). One block: 64 query rows of one head against all
// N keys, in two passes over BK-row kv tiles.
template <int BK>
__global__ void __launch_bounds__(kMmaThreads)
    hm_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int N, float q_scale) {
  constexpr int D = kD, LD = D + 8, NO = D / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sQ = reinterpret_cast<bf16*>(hsmem);
  bf16* sK = sQ + kRowsH * LD;
  bf16* sV = sK + BK * LD;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  load_bf16<kRowsH, D>(sQ, q + base, q0, N, D, q_scale);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += BK) {  // pass 1: row max and sum
    __syncthreads();  // sQ is written / the previous tile's reads are done
    load_bf16<BK, D>(sK, k + base, k0, N, D, 1.f);
    __syncthreads();
    float s[NS][4] = {};
    mm_nt<NS, D / 16, LD>(s, sQ, r0, sK);
    float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nt + 2 * t + (e & 1) < N)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r)  // finite: the tile holds a column < N
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nt + 2 * t + (e & 1) < N)
          rs[e >> 1] += expf(s[nt][e] - m_new[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * expf(m[r] - m_new[r]) + quad_sum(rs[r]);
      m[r] = m_new[r];
    }
  }

  float o[NO][4] = {};
  for (int k0 = 0; k0 < N; k0 += BK) {  // pass 2: P = exp(s - m) / l, P.V
    __syncthreads();
    load_bf16<BK, D>(sK, k + base, k0, N, D, 1.f);
    load_bf16<BK, D>(sV, v + base, k0, N, D, 1.f);
    __syncthreads();
    float s[NS][4] = {};
    mm_nt<NS, D / 16, LD>(s, sQ, r0, sK);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = k0 + 8 * nt + 2 * t + (e & 1) < N
                       ? expf(s[nt][e] - m[e >> 1]) / l[e >> 1]
                       : 0.f;
    uint32_t pa[NS / 2][4];
    to_a<NS / 2>(pa, s);  // p / l rounded to bf16 before P.V
    mm_nn<NO, NS / 2, LD, false>(o, pa, sV, 1.f);
  }

  store_rows<NO>(out + base, D, o, q0 + r0, N, 1.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (t == 0 && row < N)
      lse[(size_t)blockIdx.y * N + row] = m[half] + logf(l[half]);
  }
}

template <int BK>
constexpr size_t smem_dq_bf16() {
  return (size_t)(2 * kRowsH + 2 * BK) * (kD + 8) * sizeof(bf16) +
         2 * kRowsH * sizeof(float);
}

// Grid (ceil(N / 64), BH). One block: 64 query rows of one head; loops over
// all kv tiles and accumulates dQ = dS (K * scale) in registers.
template <int BK>
__global__ void __launch_bounds__(kMmaThreads)
    hm_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int N, float q_scale, float k_scale) {
  constexpr int D = kD, LD = D + 8, NO = D / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sQ = reinterpret_cast<bf16*>(hsmem);
  bf16* sdO = sQ + kRowsH * LD;
  bf16* sK = sdO + kRowsH * LD;
  bf16* sV = sK + BK * LD;
  float* sLse = reinterpret_cast<float*>(sV + BK * LD);
  float* sDelta = sLse + kRowsH;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int q0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  load_bf16<kRowsH, D>(sQ, q + base, q0, N, D, q_scale);
  load_bf16<kRowsH, D>(sdO, dout + base, q0, N, D, 1.f);
  load_stats(sLse, sDelta, lse + (size_t)blockIdx.y * N,
             delta + (size_t)blockIdx.y * N, q0, N, kRowsH);
  float acc[NO][4] = {};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the q side is written / the last tile is consumed
    load_bf16<BK, D>(sK, k + base, k0, N, D, 1.f);
    load_bf16<BK, D>(sV, v + base, k0, N, D, 1.f);
    __syncthreads();
    float s[NS][4] = {}, dp[NS][4] = {};
    mm_nt<NS, D / 16, LD>(s, sQ, r0, sK);
    mm_nt<NS, D / 16, LD>(dp, sdO, r0, sV);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);
        const int i = r0 + g + 8 * (e >> 1);
        const float p =
            k0 + col < N ? rnd(expf(s[nt][e] - sLse[i])) : 0.f;
        dp[nt][e] = rnd(p * rnd(dp[nt][e] - sDelta[i]));
      }
    uint32_t sa[NS / 2][4];
    to_a<NS / 2>(sa, dp);
    mm_nn<NO, NS / 2, LD, true>(acc, sa, sK, k_scale);
  }

  store_rows<NO>(dq + base, D, acc, q0 + r0, N, 1.f);
}

template <int BQ>
constexpr size_t smem_dkv_bf16() {
  return (size_t)(2 * kRowsH + 2 * BQ) * (kD + 8) * sizeof(bf16) +
         2 * BQ * sizeof(float);
}

// Grid (ceil(N / 64), BH). One block: 64 key/value rows of one head; loops
// over all q tiles. Each warp computes its 16 kv rows of S^T = K Q^T (and
// dP^T = V dO^T), so P^T and dS^T feed dV += P^T dO and dK += dS^T Q straight
// from the accumulators.
template <int BQ>
__global__ void __launch_bounds__(kMmaThreads)
    hm_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int N, float q_scale) {
  constexpr int D = kD, LD = D + 8, NO = D / 8, NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sK = reinterpret_cast<bf16*>(hsmem);
  bf16* sV = sK + kRowsH * LD;
  bf16* sQ = sV + kRowsH * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sDelta = sLse + BQ;
  const size_t base = (size_t)blockIdx.y * N * D;
  const int k0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int t = threadIdx.x & 3;

  load_bf16<kRowsH, D>(sK, k + base, k0, N, D, 1.f);
  load_bf16<kRowsH, D>(sV, v + base, k0, N, D, 1.f);
  float dka[NO][4] = {}, dva[NO][4] = {};

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_bf16<BQ, D>(sQ, q + base, q0, N, D, q_scale);
    load_bf16<BQ, D>(sdO, dout + base, q0, N, D, 1.f);
    load_stats(sLse, sDelta, lse + (size_t)blockIdx.y * N,
               delta + (size_t)blockIdx.y * N, q0, N, BQ);
    __syncthreads();
    float st[NS][4] = {};
    mm_nt<NS, D / 16, LD>(st, sK, r0, sQ);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);  // q row
        st[nt][e] = q0 + col < N ? rnd(expf(st[nt][e] - sLse[col])) : 0.f;
      }
    uint32_t fa[NS / 2][4];
    to_a<NS / 2>(fa, st);
    mm_nn<NO, NS / 2, LD, false>(dva, fa, sdO, 1.f);
    float dpt[NS][4] = {};
    mm_nt<NS, D / 16, LD>(dpt, sV, r0, sdO);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);
        dpt[nt][e] = rnd(st[nt][e] * rnd(dpt[nt][e] - sDelta[col]));
      }
    to_a<NS / 2>(fa, dpt);
    mm_nn<NO, NS / 2, LD, false>(dka, fa, sQ, 1.f);
  }

  store_rows<NO>(dk + base, D, dka, k0 + r0, N, 1.f);
  store_rows<NO>(dv + base, D, dva, k0 + r0, N, 1.f);
}

bool bad(int BH, int N, int D) {
  return D != kD || BH < 1 || BH > 65535 || N < 1;
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take. `is_bf16` selects __nv_bfloat16
// (the tensor-core kernels) over float (the FMA kernels). q_scale and
// k_scale are already rounded to the element type. Every (BH, N, D) tensor is
// contiguous and 16-byte aligned; lse and delta are (BH, N) f32.

extern "C" int hm_attn_fwd(const void* q, const void* k, const void* v,
                           void* out, void* lse, int BH, int N, int D,
                           float q_scale, int is_bf16, void* stream) {
  if (bad(BH, N, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (is_bf16) {
    constexpr size_t smem = smem_fwd_bf16<kTile>();
    auto kernel = hm_fwd_bf16<kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), BH), kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), l, N, q_scale);
  } else {
    constexpr size_t smem = smem_fwd_f32<kTile, kTile>();
    auto kernel = hm_fwd_f32<kTile, kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kTile), BH), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), l, N,
        q_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int hm_attn_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int BH,
                               int N, int D, float q_scale, int is_bf16,
                               void* stream) {
  if (bad(BH, N, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  if (is_bf16) {
    constexpr size_t smem = smem_dkv_bf16<kTile>();
    auto kernel = hm_bwd_dkv_bf16<kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), BH), kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, q_scale);
  } else {
    constexpr size_t smem = smem_dkv_f32<kTile, kTile>();
    auto kernel = hm_bwd_dkv_f32<kTile, kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kTile), BH), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dk), static_cast<float*>(dv), N, q_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int hm_attn_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int BH, int N,
                              int D, float q_scale, float k_scale,
                              int is_bf16, void* stream) {
  if (bad(BH, N, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  if (is_bf16) {
    constexpr size_t smem = smem_dq_bf16<kTile>();
    auto kernel = hm_bwd_dq_bf16<kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), BH), kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
        static_cast<bf16*>(dq), N, q_scale, k_scale);
  } else {
    constexpr size_t smem = smem_dq_f32<kTile, kTile>();
    auto kernel = hm_bwd_dq_f32<kTile, kTile>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kTile), BH), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dq), N, q_scale, k_scale);
  }
  return (int)cudaGetLastError();
}
