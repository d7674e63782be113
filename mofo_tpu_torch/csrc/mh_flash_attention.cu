// Masked multihead flash attention for Hopper (sm_90a): separate q, k, v
// with an optional per-kv-position additive bias row. Forward, and the two
// halves of the backward. Plain C interface, loaded from Python with ctypes
// (mofo_tpu_torch/ops/flash_attention.py); built by
// mofo_tpu_torch/ops/_build.py together with qkv_flash_attention.cu.
//
// Replaces the TPU kernel K3 of mofo_tpu/ops/flash_attention.py:
//   mh_attn_fwd      <- _mh_fwd_impl (:653) / _mh_fwd_kernel with has_bias
//                       (:460)
//   mh_attn_bwd_dkv  <- _mh_bwd_impl (:737) / _mh_dqkv_kernel (:523), dK/dV
//   mh_attn_bwd_dq   <- _mh_bwd_impl (:737) / _mh_dqkv_kernel (:523), dQ
//
// Layout. q, k and v are (B, N, H*D) with their own row strides, so k and v
// can be column views of a fused (B, N, 2A) kv projection (A = H * D). The
// bias is a (B, N) f32 row (0 or -1e30), shared by every head and query, or
// absent (null). The forward writes out (B, N, A) and a compact (B, H, N) f32
// row log-sum-exp; the backward takes delta = rowsum(dO * O) per head,
// (B, H, N) f32, from the caller, writes dK and dV at their own row stride
// (one (B, N, 2A) dkv in the port) and dQ (B, N, A).
//
// What bounds it on this card. At the ViT-B MCA geometry (N = 1568, H = 3,
// D = 256) attention does the same N^2 * A work as one backbone block's
// attention (A = 768) on N * A bytes per operand: it is bound by operations
// (the bf16 tensor-core rate), about 190 FLOP per byte moved.
//
// What the design does about it. D = 256 is the hard part: a warp's 16 x 256
// f32 output accumulator is 128 registers a thread. So at D = 256 the bf16
// kernels read their q / k operands as fragments from shared memory at every
// k step (nothing but accumulators lives in registers), stream the other side
// in 32-row tiles (a 16 x 32 score tile is 16 registers), and the dK/dV
// kernel splits its two 64 x 256 accumulators across blockIdx.z: one block
// computes dK, another dV, for the same 64 kv rows (the score tile is
// recomputed, 5 products instead of 4). Every product of the bf16 kernels
// runs on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate);
// four warps own 16 rows each of a 64-row tile. The f32 kernels (the parity
// path) use FMAs, since tensor cores would round f32 to TF32; at D = 256
// their tiles shrink to 32 rows so that a padded tile (32 x 257 f32, 33 KB)
// leaves room for the rest. All tiles above 48 KB are dynamic shared memory.
// Ragged N is masked in-kernel (kv columns >= N score -inf, q rows >= N carry
// +inf LSE in the backward and are never stored); nothing is padded in HBM.
// The backward is two kernels (dK/dV over kv tiles, dQ over q tiles), so
// each output has exactly one writer: no atomics. wgmma, TMA and pipelined
// loads are later work.
//
// Numerics (held by the tests against the TPU kernel):
//   - the softmax scale is folded into q in the input dtype (bf16: times
//     log2 e); the bias is added after the fold;
//   - scores and softmax statistics are f32; P is rounded to the input dtype
//     before P.V and 1/l divides the output;
//   - bf16 works in base 2 (LSE in log2 units, dK rescaled by 1/log2 e),
//     f32 in base e;
//   - dQ takes k times the true scale, rounded to the input dtype;
//   - in bf16 dS is the bf16 product of P with (dP - delta) rounded to bf16;
//     in f32 it is P * (dP - delta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Copies bias[col0, col0 + n) of a (N,) row (null: zeros) to dst; columns
// >= N get -inf, which masks them out of every softmax.
__device__ __forceinline__ void load_bias(float* dst, const float* bias,
                                          int col0, int N, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int col = col0 + i;
    dst[i] = col < N ? (bias ? bias[col] : 0.f) : -INFINITY;
  }
}

// One q tile's LSE (+inf on rows >= N, so their P is 0) and delta.
__device__ __forceinline__ void load_stats(float* sLse, float* sDelta,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int N, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    sLse[i] = row < N ? lse[row] : INFINITY;
    sDelta[i] = row < N ? delta[row] : 0.f;
  }
}

// -------------------------------------------------------------------------
// f32: FMA kernels. 256 threads as 16 x 16 (ty, tx); in an R x C product a
// thread owns rows (R / 16) * ty + i and columns tx + 16 * j.
// -------------------------------------------------------------------------

constexpr int kThreads = 256;

// Rows [row0, row0 + ROWS) x D columns of a row-major matrix with row
// stride ld into dst (row stride D + 1). Rows >= n are zero. Each value is
// multiplied by mul (the scale fold; exact for mul = 1).
template <int ROWS, int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         int row0, int n, int ld, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < n ? src[(size_t)row * ld + c] * mul : 0.f;
  }
}

// acc[i][j] += sum_{k < K} A[r_i, k] * (B[k, c_j] * bmul) for rows
// r_i = I * ty + i and columns c_j = tx + 16 * j, where A[r, k] is
// A[r * ARS + k * AKS] and B[k, c] is B[k * BKS + c * BCS].
template <int I, int J, int K, int ARS, int AKS, int BKS, int BCS>
__device__ __forceinline__ void gemm(float (&acc)[I][J], const float* A,
                                     const float* B, int ty, int tx,
                                     float bmul) {
  const float* a0 = A + I * ty * ARS;
  const float* b0 = B + tx * BCS;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[I], b[J];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = a0[i * ARS + k * AKS];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = b0[16 * j * BCS + k * BKS] * bmul;
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Reductions over the 16 threads that share a row (one half-warp).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int BQ, int BK>
constexpr size_t smem_fwd_f32() {
  return ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + BK) *
         sizeof(float);
}

// Grid (ceil(N / BQ), B * H). One block: one head's BQ query rows against
// all N keys, streamed in BK-row tiles with an online softmax (base e).
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    mh_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, int N,
               int H, int ldq, int ldk, int ldv, float q_scale) {
  constexpr int I = BQ / 16, JS = BK / 16, JO = D / 16, LD = D + 1,
                LDP = BK + 1;
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sB = sP + BQ * LDP;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + (size_t)b * N * ldq + h * D;
  const float* kb = k + (size_t)b * N * ldk + h * D;
  const float* vb = v + (size_t)b * N * ldv + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_f32<BQ, D>(sQ, qb, q0, N, ldq, q_scale);
  float m[I], l[I], o[I][JO] = {};
#pragma unroll
  for (int i = 0; i < I; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // sQ is written / the previous tile's reads are done
    load_f32<BK, D>(sK, kb, k0, N, ldk, 1.f);
    load_f32<BK, D>(sV, vb, k0, N, ldv, 1.f);
    load_bias(sB, bb, k0, N, BK);
    __syncthreads();
    float s[I][JS] = {};
    gemm<I, JS, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        s[i][j] += sB[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a column < N, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(I * ty + i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JO; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    gemm<I, JO, BK, LDP, 1, LD, 1>(o, sP, sV, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + I * ty + i;
    if (row >= N) continue;
    float* dst = out + ((size_t)b * N + row) * (H * D) + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = o[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * N + row] = m[i] + logf(l[i]);
  }
}

template <int D, int BQ, int BK>
constexpr size_t smem_dq_f32() {
  return ((size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + 2 * BQ +
          BK) * sizeof(float);
}

// Grid (ceil(N / BQ), B * H). One block: one head's BQ query rows; loops
// over all kv tiles and accumulates dQ = dS (K * scale) in registers.
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    mh_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ bias,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int N, int H, int ldq, int ldk, int ldv, float q_scale,
                  float k_scale) {
  constexpr int I = BQ / 16, JS = BK / 16, JO = D / 16, LD = D + 1,
                LDP = BK + 1;
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;
  float* sLse = sdS + BQ * LDP;
  float* sDelta = sLse + BQ;
  float* sB = sDelta + BQ;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k + (size_t)b * N * ldk + h * D;
  const float* vb = v + (size_t)b * N * ldv + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_f32<BQ, D>(sQ, q + (size_t)b * N * ldq + h * D, q0, N, ldq, q_scale);
  load_f32<BQ, D>(sdO, dout + (size_t)b * N * A + h * D, q0, N, A, 1.f);
  load_stats(sLse, sDelta, lse + (size_t)bh * N, delta + (size_t)bh * N, q0,
             N, BQ);
  float acc[I][JO] = {};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the q side is written / the last tile is consumed
    load_f32<BK, D>(sK, kb, k0, N, ldk, 1.f);
    load_f32<BK, D>(sV, vb, k0, N, ldv, 1.f);
    load_bias(sB, bb, k0, N, BK);
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
        // columns >= N carry -inf bias, rows >= N +inf LSE: p = 0
        const float p = expf(s[i][j] + sB[c] - sLse[r]);
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
    float* dst = dq + ((size_t)b * N + row) * A + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = acc[i][j];
  }
}

template <int D, int BKV, int BQ>
constexpr size_t smem_dkv_f32() {
  return ((size_t)(2 * BKV + 2 * BQ) * (D + 1) + 2 * BKV * (BQ + 1) +
          2 * BQ + BKV) * sizeof(float);
}

// Grid (ceil(N / BKV), B * H). One block: one head's BKV key/value rows;
// loops over all q tiles and accumulates dK and dV in registers. It forms
// S^T = K Q^T and dP^T = V dO^T directly (rows kv, columns q), so P^T and
// dS^T are row-major A operands of dV += P^T dO and dK += dS^T Q.
template <int D, int BKV, int BQ>
__global__ void __launch_bounds__(kThreads)
    mh_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, int H, int ldq, int ldk,
                   int ldv, int lddkv, float q_scale) {
  constexpr int I = BKV / 16, JQ = BQ / 16, JO = D / 16, LD = D + 1,
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
  float* sB = sDelta + BQ;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BKV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + (size_t)b * N * ldq + h * D;
  const float* ob = dout + (size_t)b * N * A + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_f32<BKV, D>(sK, k + (size_t)b * N * ldk + h * D, k0, N, ldk, 1.f);
  load_f32<BKV, D>(sV, v + (size_t)b * N * ldv + h * D, k0, N, ldv, 1.f);
  // this block's kv rows >= N are never stored: any finite bias will do
  for (int i = threadIdx.x; i < BKV; i += blockDim.x)
    sB[i] = (k0 + i < N && bb) ? bb[k0 + i] : 0.f;
  float dka[I][JO] = {}, dva[I][JO] = {};

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_f32<BQ, D>(sQ, qb, q0, N, ldq, q_scale);
    load_f32<BQ, D>(sdO, ob, q0, N, A, 1.f);
    load_stats(sLse, sDelta, lse + (size_t)bh * N, delta + (size_t)bh * N,
               q0, N, BQ);
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
        const float p = expf(st[i][j] + sB[r] - sLse[c]);
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
    const size_t off = ((size_t)b * N + row) * lddkv + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) {
      dk[off + 16 * j] = dka[i][j];
      dv[off + 16 * j] = dva[i][j];
    }
  }
}

// -------------------------------------------------------------------------
// bf16: tensor-core kernels. 128 threads = 4 warps; warp w owns rows
// [16w, 16w + 16) of the block's 64-row tile. mma.sync m16n8k16 fragment
// layout (g = lane / 4, t = lane % 4): A holds rows g and g + 8, columns
// 2t, 2t + 1 (+8); B holds k rows 2t, 2t + 1 (+8) of column g; the f32
// accumulator c[nt] holds rows g (c0, c1) and g + 8 (c2, c3), columns
// 8*nt + 2t and 8*nt + 2t + 1. Shared tiles have row stride D + 8.
// -------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kRowsH = 64;  // rows of the block's own tile

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + ROWS) x D of a row-major bf16 matrix (row stride ld,
// 16-byte aligned rows) into dst (row stride D + 8), 8 values at a time.
// Rows >= n are zero. With mul != 1 each value is multiplied by mul and
// rounded to bf16 (the scale fold).
template <int ROWS, int D>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          int row0, int n, int ld,
                                          float mul) {
  constexpr int C8 = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * C8; idx += blockDim.x) {
    const int r = idx / C8, c = 8 * (idx % C8), row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + c);
      if (mul != 1.f) {
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          x[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// c (16 x 8NT) += A (rows [r0, r0 + 16) of shared tile a, k = 16 KK) . M^T
// for a shared tile M whose 8NT rows are the output columns (S = Q K^T).
// A fragments are read from shared memory at each k step.
template <int NT, int KK, int LD>
__device__ __forceinline__ void mm_nt(float (&c)[NT][4], const bf16* a,
                                      int r0, const bf16* m) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const bf16* pa = a + (r0 + g) * LD + 16 * kk + 2 * t;
    const uint32_t fa[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8),
                            ld32(pa + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* p = m + (8 * nt + g) * LD + 16 * kk + 2 * t;
      mma(c[nt], fa, ld32(p), ld32(p + 8));
    }
  }
}

// c (16 x 8NT) += a (16 x 16KK, A fragments in registers) . M for a shared
// tile M (16KK rows x 8NT columns) whose rows are the contraction index
// (O = P V). With kScale each M value is first multiplied by mul and
// rounded to bf16 (K times the softmax scale, for dQ).
template <int NT, int KK, int LD, bool kScale>
__device__ __forceinline__ void mm_nn(float (&c)[NT][4],
                                      const uint32_t (&a)[KK][4],
                                      const bf16* m, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const bf16* p = m + (16 * kk + 2 * t) * LD + 8 * nt + g;
      uint32_t b0, b1;
      if (kScale) {
        b0 = pack2(__bfloat162float(p[0]) * mul,
                   __bfloat162float(p[LD]) * mul);
        b1 = pack2(__bfloat162float(p[8 * LD]) * mul,
                   __bfloat162float(p[9 * LD]) * mul);
      } else {
        b0 = pack_bf(p[0], p[LD]);
        b1 = pack_bf(p[8 * LD], p[9 * LD]);
      }
      mma(c[nt], a[kk], b0, b1);
    }
  }
}

// Accumulators (16 x 16KK f32) -> A fragments of the next product, rounded
// to bf16.
template <int KK>
__device__ __forceinline__ void to_a(uint32_t (&a)[KK][4],
                                     const float (&c)[2 * KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Reductions over the 4 threads that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stores rows [r0, r0 + 16) of a 16 x 8NT accumulator (times mul) at
// dst + row * ld, rows >= n skipped.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld,
                                           const float (&c)[NT][4], int r0,
                                           int n, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(c[nt][2 * half] * mul,
                                c[nt][2 * half + 1] * mul);
  }
}

template <int D, int BK>
constexpr size_t smem_fwd_bf16() {
  return (size_t)(kRowsH + 2 * BK) * (D + 8) * sizeof(bf16) +
         BK * sizeof(float);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows against
// all N keys, streamed in BK-row tiles with an online softmax (base 2).
template <int D, int BK>
__global__ void __launch_bounds__(kMmaThreads)
    mh_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                bf16* __restrict__ out, float* __restrict__ lse, int N,
                int H, int ldq, int ldk, int ldv, float q_scale) {
  constexpr int LD = D + 8, NO = D / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sQ = reinterpret_cast<bf16*>(hsmem);
  bf16* sK = sQ + kRowsH * LD;
  bf16* sV = sK + BK * LD;
  float* sB = reinterpret_cast<float*>(sV + BK * LD);
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int q0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* kb = k + (size_t)b * N * ldk + h * D;
  const bf16* vb = v + (size_t)b * N * ldv + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_bf16<kRowsH, D>(sQ, q + (size_t)b * N * ldq + h * D, q0, N, ldq,
                       q_scale);
  float o[NO][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // sQ is written / the previous tile's reads are done
    load_bf16<BK, D>(sK, kb, k0, N, ldk, 1.f);
    load_bf16<BK, D>(sV, vb, k0, N, ldv, 1.f);
    load_bias(sB, bb, k0, N, BK);
    __syncthreads();
    float s[NS][4] = {};
    mm_nt<NS, D / 16, LD>(s, sQ, r0, sK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += sB[8 * nt + 2 * t + (e & 1)];  // -inf past N
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds a column < N, so the max is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
    uint32_t pa[NS / 2][4];
    to_a<NS / 2>(pa, s);  // P rounded to bf16 before P.V
    mm_nn<NO, NS / 2, LD, false>(o, pa, sV, 1.f);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= N) continue;
    bf16* dst = out + ((size_t)b * N + row) * A + h * D;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(o[nt][2 * half] / l[half],
                                o[nt][2 * half + 1] / l[half]);
    // LSE in log2 units: the scores carry log2(e)
    if (t == 0) lse[(size_t)bh * N + row] = m[half] + log2f(l[half]);
  }
}

template <int D, int BK>
constexpr size_t smem_dq_bf16() {
  return (size_t)(2 * kRowsH + 2 * BK) * (D + 8) * sizeof(bf16) +
         (2 * kRowsH + BK) * sizeof(float);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows; loops
// over all kv tiles and accumulates dQ = dS (K * scale) in registers.
template <int D, int BK>
__global__ void __launch_bounds__(kMmaThreads)
    mh_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const float* __restrict__ bias,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int N, int H, int ldq, int ldk, int ldv, float q_scale,
                   float k_scale) {
  constexpr int LD = D + 8, NO = D / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sQ = reinterpret_cast<bf16*>(hsmem);
  bf16* sdO = sQ + kRowsH * LD;
  bf16* sK = sdO + kRowsH * LD;
  bf16* sV = sK + BK * LD;
  float* sLse = reinterpret_cast<float*>(sV + BK * LD);
  float* sDelta = sLse + kRowsH;
  float* sB = sDelta + kRowsH;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int q0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* kb = k + (size_t)b * N * ldk + h * D;
  const bf16* vb = v + (size_t)b * N * ldv + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_bf16<kRowsH, D>(sQ, q + (size_t)b * N * ldq + h * D, q0, N, ldq,
                       q_scale);
  load_bf16<kRowsH, D>(sdO, dout + (size_t)b * N * A + h * D, q0, N, A,
                       1.f);
  load_stats(sLse, sDelta, lse + (size_t)bh * N, delta + (size_t)bh * N, q0,
             N, kRowsH);
  float acc[NO][4] = {};

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the q side is written / the last tile is consumed
    load_bf16<BK, D>(sK, kb, k0, N, ldk, 1.f);
    load_bf16<BK, D>(sV, vb, k0, N, ldv, 1.f);
    load_bias(sB, bb, k0, N, BK);
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
        // columns >= N carry -inf bias, rows >= N +inf LSE: p = 0
        const float p = rnd(exp2f(s[nt][e] + sB[col] - sLse[i]));
        dp[nt][e] = rnd(p * rnd(dp[nt][e] - sDelta[i]));
      }
    uint32_t sa[NS / 2][4];
    to_a<NS / 2>(sa, dp);
    mm_nn<NO, NS / 2, LD, true>(acc, sa, sK, k_scale);
  }

  store_rows<NO>(dq + (size_t)b * N * A + h * D, A, acc, q0 + r0, N, 1.f);
}

template <int D, int BQ>
constexpr size_t smem_dkv_bf16() {
  return (size_t)(2 * kRowsH + 2 * BQ) * (D + 8) * sizeof(bf16) +
         (2 * BQ + kRowsH) * sizeof(float);
}

// Grid (ceil(N / 64), B * H, kSplit ? 2 : 1). One block: one head's 64
// key/value rows; loops over all q tiles. Each warp computes its 16 kv rows
// of S^T = K Q^T (and dP^T = V dO^T), so P^T and dS^T feed dV += P^T dO and
// dK += dS^T Q straight from the accumulators. With kSplit (D = 256) the
// two accumulators do not fit in registers together: blocks with
// blockIdx.z == 0 compute dK, those with blockIdx.z == 1 compute dV.
template <int D, int BQ, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads)
    mh_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int N, int H, int ldq, int ldk,
                    int ldv, int lddkv, float q_scale, float dk_fix) {
  constexpr int LD = D + 8, NO = D / 8, NS = BQ / 8;
  constexpr int kAcc = kSplit ? 1 : 2;
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* sK = reinterpret_cast<bf16*>(hsmem);
  bf16* sV = sK + kRowsH * LD;
  bf16* sQ = sV + kRowsH * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sLse = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sDelta = sLse + BQ;
  float* sB = sDelta + BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int k0 = blockIdx.x * kRowsH, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool want_dk = !kSplit || blockIdx.z == 0;
  const bool want_dv = !kSplit || blockIdx.z == 1;
  const bf16* qb = q + (size_t)b * N * ldq + h * D;
  const bf16* ob = dout + (size_t)b * N * A + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_bf16<kRowsH, D>(sK, k + (size_t)b * N * ldk + h * D, k0, N, ldk, 1.f);
  load_bf16<kRowsH, D>(sV, v + (size_t)b * N * ldv + h * D, k0, N, ldv, 1.f);
  // this block's kv rows >= N are never stored: any finite bias will do
  for (int i = threadIdx.x; i < kRowsH; i += blockDim.x)
    sB[i] = (k0 + i < N && bb) ? bb[k0 + i] : 0.f;
  float acc[kAcc][NO][4] = {};

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_bf16<BQ, D>(sQ, qb, q0, N, ldq, q_scale);
    load_bf16<BQ, D>(sdO, ob, q0, N, A, 1.f);
    load_stats(sLse, sDelta, lse + (size_t)bh * N, delta + (size_t)bh * N,
               q0, N, BQ);
    __syncthreads();
    float st[NS][4] = {};
    mm_nt<NS, D / 16, LD>(st, sK, r0, sQ);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);  // kv
        const int col = 8 * nt + 2 * t + (e & 1);  // q; +inf LSE past N
        st[nt][e] = rnd(exp2f(st[nt][e] + sB[row] - sLse[col]));
      }
    uint32_t fa[NS / 2][4];
    if (want_dv) {
      to_a<NS / 2>(fa, st);
      mm_nn<NO, NS / 2, LD, false>(acc[kAcc - 1], fa, sdO, 1.f);
    }
    if (want_dk) {
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
      mm_nn<NO, NS / 2, LD, false>(acc[0], fa, sQ, 1.f);
    }
  }

  const size_t off = (size_t)b * N * lddkv + h * D;
  if (want_dk) store_rows<NO>(dk + off, lddkv, acc[0], k0 + r0, N, dk_fix);
  if (want_dv)
    store_rows<NO>(dv + off, lddkv, acc[kAcc - 1], k0 + r0, N, 1.f);
}

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

constexpr int kBadArgument = -1;

int max_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

bool bad(int B, int N, int H, int D, int ldq, int ldk, int ldv) {
  const int A = H * D;
  return (D != 64 && D != 256) || B < 1 || N < 1 || H < 1 ||
         B * H > 65535 || ldq < A || ldk < A || ldv < A;
}

// Tiles: the bf16 kernels' own tile is 64 rows; their streamed tile is 64
// rows at D = 64 and 32 at D = 256. The f32 kernels use 64 x 64 tiles at
// D = 64 and 32 x 32 at D = 256.
template <int D>
constexpr int stream_rows() { return D == 64 ? 64 : 32; }

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int N, int H, int ldq, int ldk,
        int ldv, float q_scale, int bf16_, cudaStream_t st) {
  constexpr int T = stream_rows<D>();
  if (bf16_) {
    constexpr size_t smem = smem_fwd_bf16<D, T>();
    auto kernel = mh_fwd_bf16<D, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), B * H), kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lse, N,
        H, ldq, ldk, ldv, q_scale);
  } else {
    constexpr size_t smem = smem_fwd_f32<D, T, T>();
    auto kernel = mh_fwd_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), lse,
        N, H, ldq, ldk, ldv, q_scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta,
            void* dk, void* dv, int B, int N, int H, int ldq, int ldk,
            int ldv, int lddkv, float q_scale, float dk_fix, int bf16_,
            cudaStream_t st) {
  constexpr int T = stream_rows<D>();
  if (bf16_) {
    constexpr bool kSplit = D == 256;
    constexpr size_t smem = smem_dkv_bf16<D, T>();
    auto kernel = mh_bwd_dkv_bf16<D, T, kSplit>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), B * H, kSplit ? 2 : 1), kMmaThreads,
             smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout),
        lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, H,
        ldq, ldk, ldv, lddkv, q_scale, dk_fix);
  } else {
    // f32 works in base e: dK needs no 1/log2(e) fix
    constexpr size_t smem = smem_dkv_f32<D, T, T>();
    auto kernel = mh_bwd_dkv_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout),
        lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), N, H,
        ldq, ldk, ldv, lddkv, q_scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* delta, void* dq,
           int B, int N, int H, int ldq, int ldk, int ldv, float q_scale,
           float k_scale, int bf16_, cudaStream_t st) {
  constexpr int T = stream_rows<D>();
  if (bf16_) {
    constexpr size_t smem = smem_dq_bf16<D, T>();
    auto kernel = mh_bwd_dq_bf16<D, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kRowsH), B * H), kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout),
        lse, delta, static_cast<bf16*>(dq), N, H, ldq, ldk, ldv, q_scale,
        k_scale);
  } else {
    constexpr size_t smem = smem_dq_f32<D, T, T>();
    auto kernel = mh_bwd_dq_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout),
        lse, delta, static_cast<float*>(dq), N, H, ldq, ldk, ldv, q_scale,
        k_scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take. `bf16` selects __nv_bfloat16 (the
// tensor-core kernels) over float (the FMA kernels). q_scale and k_scale are
// already rounded to the element type; bf16 rows must be 16-byte aligned.
// ld* are row strides in elements; dout, out and dq are (B, N, H*D)
// contiguous; lse and delta (B, H, N) f32; bias (B, N) f32 or null.

extern "C" int mh_attn_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* lse, int B,
                           int N, int H, int D, int ldq, int ldk, int ldv,
                           float q_scale, int bf16, void* stream) {
  if (bad(B, N, H, D, ldq, ldk, ldv)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<float*>(lse);
  return D == 64 ? fwd<64>(q, k, v, b, out, l, B, N, H, ldq, ldk, ldv,
                           q_scale, bf16, st)
                 : fwd<256>(q, k, v, b, out, l, B, N, H, ldq, ldk, ldv,
                            q_scale, bf16, st);
}

extern "C" int mh_attn_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, int B, int N, int H, int D, int ldq,
                               int ldk, int ldv, int lddkv, float q_scale,
                               float dk_fix, int bf16, void* stream) {
  if (bad(B, N, H, D, ldq, ldk, ldv) || lddkv < H * D) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  return D == 64
             ? bwd_dkv<64>(q, k, v, b, dout, l, d, dk, dv, B, N, H, ldq, ldk,
                           ldv, lddkv, q_scale, dk_fix, bf16, st)
             : bwd_dkv<256>(q, k, v, b, dout, l, d, dk, dv, B, N, H, ldq,
                            ldk, ldv, lddkv, q_scale, dk_fix, bf16, st);
}

extern "C" int mh_attn_bwd_dq(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              int B, int N, int H, int D, int ldq, int ldk,
                              int ldv, float q_scale, float k_scale,
                              int bf16, void* stream) {
  if (bad(B, N, H, D, ldq, ldk, ldv)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  return D == 64 ? bwd_dq<64>(q, k, v, b, dout, l, d, dq, B, N, H, ldq, ldk,
                              ldv, q_scale, k_scale, bf16, st)
                 : bwd_dq<256>(q, k, v, b, dout, l, d, dq, B, N, H, ldq,
                               ldk, ldv, q_scale, k_scale, bf16, st);
}
