// Fused-qkv flash attention for Hopper (sm_90a): forward, and the two halves
// of the backward. Plain C interface, loaded from Python with ctypes
// (mofo_tpu_torch/ops/flash_attention.py); built by mofo_tpu_torch/ops/_build.py.
//
// Replaces the TPU kernels of mofo_tpu/ops/flash_attention.py:
//   qkv_attn_fwd      <- _qkv_fwd_impl / _mh_fwd_kernel            (K1)
//   qkv_attn_bwd_dkv  <- _qkv_bwd_impl / _qkv_bwd_kernel and
//   qkv_attn_bwd_dq      _qkv_bwd_kernel_houter (dK/dV and dQ)    (K2)
//
// Layout. q, k and v are column views of the fused (B, N, 3A) projection
// (A = H * D, D = 64): q at column h*D, k at A + h*D, v at 2A + h*D, row
// stride 3A. The forward writes out (B, N, A) at column h*D and a compact
// (B, H, N) f32 row log-sum-exp. The backward writes one fused dqkv
// (B, N, 3A): dK/dV from one kernel, dQ from the other.
//
// What bounds it on this card. At the MOFO geometries (N = 160 and 1568,
// D = 64) attention does N^2*D work on N*D bytes: at N = 1568 it is bound
// by operations (the bf16 tensor-core rate), at N = 160 by bytes.
//
// What the design does about it. Each block holds a 64-row tile of queries
// (or of keys/values) and streams the other side in 64-row tiles through
// shared memory with an online softmax: one head's K and V at N = 1568 do
// not fit in a block's shared memory, so the TPU's "whole K/V rows
// resident" design does not carry over. The bf16 kernels (the training
// path) run every product on the tensor cores with mma.sync m16n8k16 (bf16
// in, f32 accumulate): four warps own 16 rows each, and P and dS go from
// the accumulators to the next product's A operand in registers. The f32
// kernels (the parity path) do their products with f32 FMAs, each thread a
// 4x4 register micro-tile, since tensor cores would round f32 to TF32. So
// the f32 card-against-CPU step check of chip_smoke.py runs these FMA
// kernels only; the bf16 kernels are held against their plain versions on
// their own (mofo_tpu_torch/tools/main_path.py's bounds).
// Shared-memory rows are padded (bf16: 72, f32: 65 elements) so fragment
// and micro-tile reads are free of bank conflicts. Ragged edges are masked
// in-kernel (kv columns >= N score -inf, q rows >= N carry +inf LSE in the
// backward and are never stored); nothing is padded in HBM. The backward is
// two kernels, dK/dV over kv tiles and dQ over q tiles, so each output has
// exactly one writer: no atomics, deterministic sums. wgmma, TMA and
// pipelined loads are later work.
//
// Numerics (held by the tests against the TPU kernels):
//   - the softmax scale is folded into q in the input dtype;
//   - scores and softmax statistics are f32;
//   - P is rounded to the input dtype before P.V, and 1/l divides the
//     (BQ, D) output;
//   - bf16 works in base 2: q carries scale*log2(e), the LSE is stored in
//     log2 units and the backward recomputes P with exp2 (and rescales dK by
//     1/log2(e)); f32 works in base e. Forward and backward always agree;
//   - in bf16, dS is the bf16 product of P with the f32 difference
//     (dP - delta) rounded to bf16; in f32 it is P * (dP - delta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;   // head dim
constexpr int kRows = 64;  // rows of every tile (q and kv)

// -------------------------------------------------------------------------
// f32: FMA kernels. 256 threads as 16 x 16, each a 4x4 micro-tile of a
// 64 x 64 product: rows 4*ty + i, columns tx + 16*j.
// -------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kLd = kD + 1;  // padded f32 row stride
constexpr int kTile = kRows * kLd;

// Copies rows [row0, row0 + 64) x kD columns of a row-major matrix with row
// stride `ld` into dst (stride kLd). Rows >= n are zero. With mul != 1 each
// value is multiplied by mul (the scale fold).
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n, int ld,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kRows * kD; idx += blockDim.x) {
    const int r = idx / kD, c = idx % kD, row = row0 + r;
    dst[r * kLd + c] = row < n ? src[(size_t)row * ld + c] * mul : 0.f;
  }
}

// acc[i][j] += sum_k A[r_i, k] * B[k, c_j] for the thread's rows
// r_i = 4*ty + i and columns c_j = tx + 16*j, where A[r, k] is
// A[r*ARS + k*AKS] and B[k, c] is B[k*BKS + c*BCS].
template <int ARS, int AKS, int BKS, int BCS>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
  const float* a0 = A + 4 * ty * ARS;
  const float* b0 = B + tx * BCS;
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * ARS + k * AKS];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b0[16 * j * BCS + k * BKS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows against
// all N keys, streamed in 64-row tiles with an online softmax.
__global__ void __launch_bounds__(kThreads)
    fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
            float* __restrict__ lse, int N, int H, float q_scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile;
  float* sV = sK + kTile;
  float* sP = sV + kTile;
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* base = qkv + (size_t)b * N * ld;

  load_tile(sQ, base + h * kD, q0, N, ld, q_scale);
  float m[4], l[4], o[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    load_tile(sK, base + A + h * kD, k0, N, ld, 1.f);
    load_tile(sV, base + 2 * A + h * kD, k0, N, ld, 1.f);
    __syncthreads();
    float s[4][4] = {};
    gemm_tile<kLd, 1, 1, kLd>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= N) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds at least one valid column, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(4 * ty + i) * kLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    gemm_tile<kLd, 1, kLd, 1>(o, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = out + ((size_t)b * N + row) * A + h * kD + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[16 * j] = o[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * N + row] = m[i] + logf(l[i]);
  }
}

// P and dS of one (q tile, kv tile) pair from the thread's score and dP
// micro-tiles, in place. kv columns >= N and q rows with +inf LSE get
// p = 0 and so ds = 0.
__device__ __forceinline__ void p_and_ds_f32(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* sLse,
                                             const float* sDelta, int k0,
                                             int N, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = k0 + tx + 16 * j < N ? expf(s[i][j] - sLse[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - sDelta[r]);
    }
  }
}

// Loads one q tile's scaled q, dO and O, its LSE (+inf on rows >= N) and
// computes its delta = rowsum(dO * O). Leaves O in `scratch`.
__device__ __forceinline__ void load_q_side_f32(
    float* sQ, float* sdO, float* scratch, float* sLse, float* sDelta,
    const float* qkv_b, const float* out_b, const float* dout_b,
    const float* lse_bh, int q0, int N, int A, int h, float q_scale) {
  load_tile(sQ, qkv_b + h * kD, q0, N, 3 * A, q_scale);
  load_tile(sdO, dout_b + h * kD, q0, N, A, 1.f);
  load_tile(scratch, out_b + h * kD, q0, N, A, 1.f);
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    sLse[threadIdx.x] = row < N ? lse_bh[row] : INFINITY;
  }
  __syncthreads();
  // four threads to a row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float acc = 0.f;
#pragma unroll
  for (int c = part * (kD / 4); c < (part + 1) * (kD / 4); ++c)
    acc = fmaf(sdO[r * kLd + c], scratch[r * kLd + c], acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) sDelta[r] = acc;
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 key/value rows;
// loops over all q tiles and accumulates dK and dV in registers.
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_f32(const float* __restrict__ qkv, const float* __restrict__ out,
                const float* __restrict__ lse,
                const float* __restrict__ dout, float* __restrict__ dqkv,
                int N, int H, float q_scale) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile;
  float* sQ = sV + kTile;
  float* sdO = sQ + kTile;
  float* sP = sdO + kTile;
  float* sdS = sP + kTile;
  float* sLse = sdS + kTile;
  float* sDelta = sLse + kRows;
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qkv_b = qkv + (size_t)b * N * ld;

  load_tile(sK, qkv_b + A + h * kD, k0, N, ld, 1.f);
  load_tile(sV, qkv_b + 2 * A + h * kD, k0, N, ld, 1.f);
  float dk[4][4] = {}, dv[4][4] = {};

  for (int q0 = 0; q0 < N; q0 += kRows) {
    __syncthreads();  // the previous q tile's reads are done
    load_q_side_f32(sQ, sdO, sdS, sLse, sDelta, qkv_b,
                    out + (size_t)b * N * A, dout + (size_t)b * N * A,
                    lse + (size_t)bh * N, q0, N, A, h, q_scale);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_tile<kLd, 1, 1, kLd>(s, sQ, sK, ty, tx);
    gemm_tile<kLd, 1, 1, kLd>(dp, sdO, sV, ty, tx);
    // this block's kv rows >= N are never stored, so no column mask
    p_and_ds_f32(s, dp, sLse, sDelta, 0, kRows, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(4 * ty + i) * kLd + tx + 16 * j] = s[i][j];
        sdS[(4 * ty + i) * kLd + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // rows of dV/dK are kv positions: A[kv, q] = P[q, kv]
    gemm_tile<1, kLd, kLd, 1>(dv, sP, sdO, ty, tx);
    gemm_tile<1, kLd, kLd, 1>(dk, sdS, sQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = dqkv + ((size_t)b * N + row) * ld + h * kD + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[A + 16 * j] = dk[i][j];
      dst[2 * A + 16 * j] = dv[i][j];
    }
  }
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows; loops
// over all kv tiles and accumulates dQ in registers.
__global__ void __launch_bounds__(kThreads)
    bwd_dq_f32(const float* __restrict__ qkv, const float* __restrict__ out,
               const float* __restrict__ lse, const float* __restrict__ dout,
               float* __restrict__ dqkv, int N, int H, float q_scale,
               float k_scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile;
  float* sdS = sdO + kTile;
  float* sK = sdS + kTile;
  float* sKs = sK + kTile;
  float* sV = sKs + kTile;
  float* sLse = sV + kTile;
  float* sDelta = sLse + kRows;
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qkv_b = qkv + (size_t)b * N * ld;

  load_q_side_f32(sQ, sdO, sdS, sLse, sDelta, qkv_b, out + (size_t)b * N * A,
                  dout + (size_t)b * N * A, lse + (size_t)bh * N, q0, N, A,
                  h, q_scale);
  float dq[4][4] = {};

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // delta is written / the previous kv tile is consumed
    load_tile(sK, qkv_b + A + h * kD, k0, N, ld, 1.f);
    load_tile(sKs, qkv_b + A + h * kD, k0, N, ld, k_scale);
    load_tile(sV, qkv_b + 2 * A + h * kD, k0, N, ld, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm_tile<kLd, 1, 1, kLd>(s, sQ, sK, ty, tx);
    gemm_tile<kLd, 1, 1, kLd>(dp, sdO, sV, ty, tx);
    p_and_ds_f32(s, dp, sLse, sDelta, k0, N, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(4 * ty + i) * kLd + tx + 16 * j] = dp[i][j];
    __syncthreads();
    gemm_tile<kLd, 1, kLd, 1>(dq, sdS, sKs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = dqkv + ((size_t)b * N + row) * ld + h * kD + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[16 * j] = dq[i][j];
  }
}

// -------------------------------------------------------------------------
// bf16: tensor-core kernels. 128 threads = 4 warps; warp w owns rows
// [16w, 16w + 16) of the block's 64-row tile. mma.sync m16n8k16 fragment
// layout (g = lane / 4, t = lane % 4): A holds rows g and g + 8, columns
// 2t, 2t + 1 (+8); B holds k rows 2t, 2t + 1 (+8) of column g; the f32
// accumulator c[nt] holds rows g (c0, c1) and g + 8 (c2, c3), columns
// 8*nt + 2t and 8*nt + 2t + 1.
// -------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kLdh = kD + 8;  // padded bf16 row stride: 144 bytes
constexpr int kTileH = kRows * kLdh;

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

// Copies rows [row0, row0 + 64) x kD columns of a row-major bf16 matrix
// (row stride ld, 16-byte aligned rows) into dst (stride kLdh), 8 values a
// thread at a time. Rows >= n are zero. With mul != 1 each value is
// multiplied by mul and rounded to bf16 (the scale fold).
__device__ __forceinline__ void load_tile_h(bf16* dst, const bf16* src,
                                            int row0, int n, int ld,
                                            float mul) {
  for (int idx = threadIdx.x; idx < kRows * kD / 8; idx += blockDim.x) {
    const int r = idx / (kD / 8), c = 8 * (idx % (kD / 8)), row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + c);
      if (mul != 1.f) {
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          x[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = v;
  }
}

// A fragments (k = 64: four k-steps) of the 16-row strip at row r0.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* s,
                                       int r0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p = s + (r0 + g) * kLdh + 16 * kk + 2 * t;
    a[kk][0] = ld32(p);
    a[kk][1] = ld32(p + 8 * kLdh);
    a[kk][2] = ld32(p + 8);
    a[kk][3] = ld32(p + 8 * kLdh + 8);
  }
}

// c (16 x 64) += a (16 x 64) . M^T for a row-major 64 x 64 tile M whose
// rows are the output columns (S = Q K^T).
__device__ __forceinline__ void mm_nt(float (&c)[8][4],
                                      const uint32_t (&a)[4][4],
                                      const bf16* m) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const bf16* p = m + (8 * nt + g) * kLdh + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma(c[nt], a[kk], ld32(p + 16 * kk), ld32(p + 16 * kk + 8));
  }
}

// c (16 x 64) += a (16 x 64) . M for a row-major 64 x 64 tile M whose rows
// are the contraction index (O = P V).
__device__ __forceinline__ void mm_nn(float (&c)[8][4],
                                      const uint32_t (&a)[4][4],
                                      const bf16* m) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* p = m + (16 * kk + 2 * t) * kLdh + 8 * nt + g;
      mma(c[nt], a[kk], pack_bf(p[0], p[kLdh]),
          pack_bf(p[8 * kLdh], p[9 * kLdh]));
    }
  }
}

// Accumulators (16 x 64 f32) -> A fragments of the next product, rounded
// to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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

// Stores rows [r0, r0 + 16) of a 16 x 64 accumulator (times mul) at
// dst + row * ld, rows >= n skipped.
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld,
                                           const float (&c)[8][4], int r0,
                                           int n, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(c[nt][2 * half] * mul,
                                c[nt][2 * half + 1] * mul);
  }
}

// delta[r] = sum_d dO[r, d] * O[r, d] (f32) for the 64 rows of a tile:
// two threads to a row, 16-byte loads.
__device__ __forceinline__ void row_delta_h(float* delta, const bf16* dO,
                                            const bf16* O) {
  static_assert(kMmaThreads == 2 * kRows, "two threads to a row");
  const int r = threadIdx.x >> 1, c0 = (kD / 2) * (threadIdx.x & 1);
  float acc = 0.f;
#pragma unroll
  for (int c = c0; c < c0 + kD / 2; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dO + r * kLdh + c);
    const uint4 b = *reinterpret_cast<const uint4*>(O + r * kLdh + c);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(x[e]);
      const float2 fy = __bfloat1622float2(y[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((threadIdx.x & 1) == 0) delta[r] = acc;
}

// Loads one q tile's scaled q, dO and O and its LSE (+inf on rows >= N),
// and computes its delta.
__device__ __forceinline__ void load_q_side_h(
    bf16* sQ, bf16* sdO, bf16* sO, float* sLse, float* sDelta,
    const bf16* qkv_b, const bf16* out_b, const bf16* dout_b,
    const float* lse_bh, int q0, int N, int A, int h, float q_scale) {
  load_tile_h(sQ, qkv_b + h * kD, q0, N, 3 * A, q_scale);
  load_tile_h(sdO, dout_b + h * kD, q0, N, A, 1.f);
  load_tile_h(sO, out_b + h * kD, q0, N, A, 1.f);
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    sLse[threadIdx.x] = row < N ? lse_bh[row] : INFINITY;
  }
  __syncthreads();
  row_delta_h(sDelta, sdO, sO);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows against
// all N keys, streamed in 64-row tiles with an online softmax (base 2).
__global__ void __launch_bounds__(kMmaThreads)
    fwd_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out,
             float* __restrict__ lse, int N, int H, float q_scale) {
  __shared__ __align__(16) bf16 sQ[kTileH];
  __shared__ __align__(16) bf16 sK[kTileH];
  __shared__ __align__(16) bf16 sV[kTileH];
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows, r0 = 16 * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* base = qkv + (size_t)b * N * ld;

  load_tile_h(sQ, base + h * kD, q0, N, ld, q_scale);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, sQ, r0);
  float o[8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // the previous tile's sK/sV reads are done
    load_tile_h(sK, base + A + h * kD, k0, N, ld, 1.f);
    load_tile_h(sV, base + 2 * A + h * kD, k0, N, ld, 1.f);
    __syncthreads();
    float s[8][4] = {};
    mm_nt(s, qa, sK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * nt + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every tile holds at least one valid column, so the max is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
        o[nt][e] *= corr[e >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
    uint32_t pa[4][4];
    to_a(pa, s);  // P rounded to bf16 before P.V
    mm_nn(o, pa, sV);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= N) continue;
    bf16* dst = out + ((size_t)b * N + row) * A + h * kD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(o[nt][2 * half] / l[half],
                                o[nt][2 * half + 1] / l[half]);
    // LSE in log2 units: the scores carry log2(e)
    if (t == 0) lse[(size_t)bh * N + row] = m[half] + log2f(l[half]);
  }
}

// P (rounded to bf16) and dS = bf16(P * bf16(dP - delta)) in place, for an
// accumulator pair whose delta and LSE are per row (dq) or per column
// (dkv, where the tile is transposed). Masked entries get p = 0, ds = 0.
template <bool kPerColumn>
__device__ __forceinline__ void p_and_ds_h(float (&s)[8][4],
                                           float (&dp)[8][4],
                                           const float* sLse,
                                           const float* sDelta, int r0,
                                           int k0, int N) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * t + (e & 1);
      const int i = kPerColumn ? col : r0 + g + 8 * (e >> 1);
      const float p =
          k0 + col < N ? rnd(exp2f(s[nt][e] - sLse[i])) : 0.f;
      s[nt][e] = p;
      dp[nt][e] = rnd(p * rnd(dp[nt][e] - sDelta[i]));
    }
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 key/value rows;
// loops over all q tiles and accumulates dK and dV in registers. Each warp
// computes its 16 kv rows of S^T = K Q^T and dP^T = V dO^T, so P^T and
// dS^T feed dV += P^T dO and dK += dS^T Q straight from the accumulators.
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dkv_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                 const float* __restrict__ lse,
                 const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                 int N, int H, float q_scale, float dk_fix) {
  __shared__ __align__(16) bf16 sK[kTileH];
  __shared__ __align__(16) bf16 sV[kTileH];
  __shared__ __align__(16) bf16 sQ[kTileH];
  __shared__ __align__(16) bf16 sdO[kTileH];
  __shared__ __align__(16) bf16 sO[kTileH];
  __shared__ float sLse[kRows], sDelta[kRows];
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows, r0 = 16 * (threadIdx.x >> 5);
  const bf16* qkv_b = qkv + (size_t)b * N * ld;

  load_tile_h(sK, qkv_b + A + h * kD, k0, N, ld, 1.f);
  load_tile_h(sV, qkv_b + 2 * A + h * kD, k0, N, ld, 1.f);
  float dk[8][4] = {}, dv[8][4] = {};

  for (int q0 = 0; q0 < N; q0 += kRows) {
    __syncthreads();  // the previous q tile's reads are done
    load_q_side_h(sQ, sdO, sO, sLse, sDelta, qkv_b, out + (size_t)b * N * A,
                  dout + (size_t)b * N * A, lse + (size_t)bh * N, q0, N, A,
                  h, q_scale);
    __syncthreads();
    uint32_t fa[4][4];
    float st[8][4] = {}, dpt[8][4] = {};
    load_a(fa, sK, r0);
    mm_nt(st, fa, sQ);
    load_a(fa, sV, r0);
    mm_nt(dpt, fa, sdO);
    // q rows >= N carry +inf LSE, so no column mask
    p_and_ds_h<true>(st, dpt, sLse, sDelta, r0, 0, kRows);
    to_a(fa, st);
    mm_nn(dv, fa, sdO);
    to_a(fa, dpt);
    mm_nn(dk, fa, sQ);
  }

  bf16* dst = dqkv + (size_t)b * N * ld + h * kD;
  store_rows(dst + A, ld, dk, k0 + r0, N, dk_fix);
  store_rows(dst + 2 * A, ld, dv, k0 + r0, N, 1.f);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows; loops
// over all kv tiles and accumulates dQ in registers. q and dO stay in
// registers as A fragments, so their shared tiles are reused for K, K*scale
// and V.
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dq_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                const float* __restrict__ lse, const bf16* __restrict__ dout,
                bf16* __restrict__ dqkv, int N, int H, float q_scale,
                float k_scale) {
  __shared__ __align__(16) bf16 s0[kTileH];
  __shared__ __align__(16) bf16 s1[kTileH];
  __shared__ __align__(16) bf16 s2[kTileH];
  __shared__ float sLse[kRows], sDelta[kRows];
  const int A = H * kD, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows, r0 = 16 * (threadIdx.x >> 5);
  const bf16* qkv_b = qkv + (size_t)b * N * ld;

  load_q_side_h(s0, s1, s2, sLse, sDelta, qkv_b, out + (size_t)b * N * A,
                dout + (size_t)b * N * A, lse + (size_t)bh * N, q0, N, A, h,
                q_scale);
  uint32_t qa[4][4], da[4][4];
  load_a(qa, s0, r0);
  load_a(da, s1, r0);
  float dq[8][4] = {};

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // fragments and delta are read / the last tile is used
    load_tile_h(s0, qkv_b + A + h * kD, k0, N, ld, 1.f);
    load_tile_h(s1, qkv_b + A + h * kD, k0, N, ld, k_scale);
    load_tile_h(s2, qkv_b + 2 * A + h * kD, k0, N, ld, 1.f);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mm_nt(s, qa, s0);
    mm_nt(dp, da, s2);
    p_and_ds_h<false>(s, dp, sLse, sDelta, r0, k0, N);
    uint32_t sa[4][4];
    to_a(sa, dp);
    mm_nn(dq, sa, s1);
  }

  store_rows(dqkv + (size_t)b * N * ld + h * kD, ld, dq, q0 + r0, N, 1.f);
}

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

int max_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t kSmemFwdF32 = 4 * kTile * sizeof(float);
constexpr size_t kSmemBwdF32 = (6 * kTile + 2 * kRows) * sizeof(float);

dim3 grid_for(int B, int N, int H) {
  return dim3((N + kRows - 1) / kRows, B * H);
}

constexpr int kBadArgument = -1;

bool bad(int B, int N, int H, int D) {
  return D != kD || B < 1 || N < 1 || H < 1 || B * H > 65535;
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take. `bf16` selects __nv_bfloat16 (the
// tensor-core kernels) over float (the FMA kernels). q_scale and k_scale are
// already rounded to the element type; bf16 rows must be 16-byte aligned.

extern "C" int qkv_attn_fwd(const void* qkv, void* out, void* lse, int B,
                            int N, int H, int D, float q_scale, int bf16,
                            void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, N, H);
  if (bf16) {
    fwd_bf16<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, H,
        q_scale);
  } else {
    if (int e = max_smem((const void*)fwd_f32, kSmemFwdF32)) return e;
    fwd_f32<<<grid, kThreads, kSmemFwdF32, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out),
        static_cast<float*>(lse), N, H, q_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int qkv_attn_bwd_dkv(const void* qkv, const void* out,
                                const void* lse, const void* dout, void* dqkv,
                                int B, int N, int H, int D, float q_scale,
                                float dk_fix, int bf16, void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, N, H);
  if (bf16) {
    bwd_dkv_bf16<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const float*>(lse),
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dqkv), N, H, q_scale, dk_fix);
  } else {
    // f32 works in base e: dK needs no 1/log2(e) fix
    if (int e = max_smem((const void*)bwd_dkv_f32, kSmemBwdF32)) return e;
    bwd_dkv_f32<<<grid, kThreads, kSmemBwdF32, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int qkv_attn_bwd_dq(const void* qkv, const void* out,
                               const void* lse, const void* dout, void* dqkv,
                               int B, int N, int H, int D, float q_scale,
                               float k_scale, int bf16, void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(B, N, H);
  if (bf16) {
    bwd_dq_bf16<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const float*>(lse),
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dqkv), N, H, q_scale, k_scale);
  } else {
    if (int e = max_smem((const void*)bwd_dq_f32, kSmemBwdF32)) return e;
    bwd_dq_f32<<<grid, kThreads, kSmemBwdF32, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale, k_scale);
  }
  return (int)cudaGetLastError();
}
