// Fused-qkv flash attention for Hopper (sm_90a): forward, and the two halves
// of the backward. Plain C interface, loaded from Python with ctypes
// (mofo_tpu_torch/ops/flash_attention.py); built by mofo_tpu_torch/ops/_build.py.
//
// Replaces the TPU kernels of mofo_tpu/ops/flash_attention.py:
//   qkv_attn_fwd      <- _qkv_fwd_impl / _mh_fwd_kernel            (K1)
//   qkv_attn_bwd_prep <- _qkv_bwd_impl (:1224) / _qkv_bwd_kernel's
//                        in-kernel delta (K2, bf16 only)
//   qkv_attn_bwd_dkv  <- _qkv_bwd_impl / _qkv_bwd_kernel and
//   qkv_attn_bwd_dq      _qkv_bwd_kernel_houter (dK/dV and dQ)    (K2)
//
// Layout. q, k and v are column views of the fused (B, N, 3A) projection
// (A = H * D, D = 64): q at column h*D, k at A + h*D, v at 2A + h*D, row
// stride 3A. The forward writes out (B, N, A) at column h*D and a compact
// (B, H, N) f32 row log-sum-exp. The backward writes one fused dqkv
// (B, N, 3A): dK/dV from one kernel, dQ from the other; in bf16 both read
// the prep pass's delta (B, H, N) f32 and q * q_scale (B, N, A).
//
// What bounds it on this card. At the MOFO geometries (N = 160 and 1568,
// D = 64) attention does N^2*D work on N*D bytes: at N = 1568 it is bound
// by operations (the bf16 tensor-core rate), at N = 160 by bytes (and, for
// a kernel this short, by the host's launch).
//
// What the design does about it. Each block holds 64-row tiles of queries
// (or of keys/values) and streams the other side in 64-row tiles: one
// head's K and V at N = 1568 do not fit in a block's shared memory, so the
// TPU's "whole K/V rows resident" design does not carry over.
//   - The bf16 forward (K1) runs every product on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) and an online softmax:
//     four warps own 16 rows each, P goes from the accumulators to P.V's A
//     operand in registers; tiles come through plain synchronous loads.
//   - The bf16 backward (K2, redesigned for Hopper; its kernels are
//     wgmma_attn_bwd.cuh's, shared with K4's backward, here in base 2) reads
//     each byte its math needs once. A prep kernel, qkv_attn_bwd_prep, reads
//     q, O and dO once and writes delta = rowsum(dO * O) and q * q_scale in
//     bf16 (the TPU kernel forms both inside, :1016-1023); the dK/dV and dQ
//     kernels then stream plain tiles and never read O. Each is two
//     consumer warpgroups (64 rows of wgmma.mma_async m64n64k16 each) and a
//     producer warpgroup whose first warp keeps a 2-stage ring full by TMA
//     from 3D tensor maps over (B, N, 3A) and (B, N, A), which zero-fill
//     rows past N per batch (its lanes also stage the q tiles' LSE and
//     delta); setmaxnreg hands the producer's registers to the consumers.
//     The A operands stay in registers (K's in dK/dV; q's and dO's in dQ)
//     or come from the accumulators (P, dS); B and V's A are read from
//     128-byte-swizzled shared memory. dQ's k_scale is 0.125 at head dim 64,
//     a power of two, so (dS K) * 0.125 on the f32 accumulator equals
//     dS bf16(K * 0.125) bit for bit and K is loaded once; another scale
//     reads a scaled copy that the prep pass writes. The split into dK/dV
//     over kv tiles and dQ over q tiles keeps one writer per output: no
//     atomics, deterministic sums, 7 products in all.
//   - The f32 kernels (the parity path) do their products with f32 FMAs,
//     each thread a 4x4 register micro-tile, since tensor cores would round
//     f32 to TF32; their backward forms delta itself. So the f32
//     card-against-CPU step check of chip_smoke.py runs these FMA kernels
//     only; the bf16 kernels are held against their plain versions on their
//     own (mofo_tpu_torch/tools/main_path.py's bounds).
// The mma.sync kernels pad shared-memory rows (bf16: 72, f32: 65 elements)
// so fragment and micro-tile reads are free of bank conflicts. Ragged edges
// are masked in-kernel (kv columns >= N score -inf or get P = 0, q rows >=
// N carry +inf LSE in the backward and are never stored); nothing is padded
// in HBM.
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

#include "wgmma_attn_bwd.cuh"
#include "wgmma_tiles.cuh"

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

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kLdh = kD + 8;  // padded bf16 row stride: 144 bytes
constexpr int kTileH = kRows * kLdh;

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
    a[kk][0] = bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
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

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

constexpr size_t kSmemFwdF32 = 4 * kTile * sizeof(float);
constexpr size_t kSmemBwdF32 = (6 * kTile + 2 * kRows) * sizeof(float);

dim3 grid_for(int B, int N, int H) {
  return dim3((N + kRows - 1) / kRows, B * H);
}

bool bad(int B, int N, int H, int D) {
  return D != kD || B < 1 || N < 1 || H < 1 || B * H > 65535;
}

// The tensor maps of the bf16 backward (wgmma_attn_bwd.cuh, base 2 on the
// fused layout): one map over (B, N, 3A) serves k (column offset A) and v
// (2A); q * q_scale and dO are (B, N, A).
int fused_maps(CUtensorMap* tqkv, CUtensorMap* tqs, CUtensorMap* tdo,
               const void* qkv, const void* qs, const void* dout, int B,
               int N, int A) {
  if (int e = tile_map(tqkv, qkv, 3 * A, N, B, 3 * A, (long)N * 3 * A))
    return e;
  if (int e = tile_map(tqs, qs, A, N, B, A, (long)N * A)) return e;
  return tile_map(tdo, dout, A, N, B, A, (long)N * A);
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

// The bf16 backward's prep pass: delta (B, H, N) f32 and q * q_scale (B, N,
// A) bf16, and k * k_scale into ks unless ks is null (k_scale a power of
// two: the dQ kernel then scales its accumulator).
extern "C" int qkv_attn_bwd_prep(const void* qkv, const void* out,
                                 const void* dout, void* delta, void* qs,
                                 void* ks, int B, int N, int H, int D,
                                 float q_scale, float k_scale, void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  const int A = H * kD;
  if (int e = launch_bwd_prep(
          qkv, static_cast<const __nv_bfloat16*>(qkv) + A, 3 * A, out, dout,
          delta, qs, ks, B, N, H, q_scale, k_scale,
          static_cast<cudaStream_t>(stream)))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta and qs come from qkv_attn_bwd_prep (out is not read); f32:
// delta and qs are null and the kernel forms them from out and qkv.
extern "C" int qkv_attn_bwd_dkv(const void* qkv, const void* out,
                                const void* lse, const void* dout,
                                const void* delta, const void* qs, void* dqkv,
                                int B, int N, int H, int D, float q_scale,
                                float dk_fix, int bf16, void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!delta || !qs) return kBadArgument;
    const int A = H * kD;
    CUtensorMap tqkv, tqs, tdo;
    if (int e = fused_maps(&tqkv, &tqs, &tdo, qkv, qs, dout, B, N, A))
      return e;
    auto dk = static_cast<__nv_bfloat16*>(dqkv) + A;
    if (int e = launch_bwd_dkv<false>(tqkv, tqkv, tqs, tdo, A, 2 * A, lse,
                                      delta, dk, dk + A, 3 * A, B, N, H,
                                      dk_fix, st))
      return e;
  } else {
    // f32 works in base e: dK needs no 1/log2(e) fix
    if (int e = max_smem((const void*)bwd_dkv_f32, kSmemBwdF32)) return e;
    bwd_dkv_f32<<<grid_for(B, N, H), kThreads, kSmemBwdF32, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale);
  }
  return (int)cudaGetLastError();
}

// bf16: delta, qs and (unless k_scale is a power of two) ks come from
// qkv_attn_bwd_prep; f32: they are null and the kernel reads out and qkv.
extern "C" int qkv_attn_bwd_dq(const void* qkv, const void* out,
                               const void* lse, const void* dout,
                               const void* delta, const void* qs,
                               const void* ks, void* dqkv, int B, int N,
                               int H, int D, float q_scale, float k_scale,
                               int bf16, void* stream) {
  if (bad(B, N, H, D)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!delta || !qs) return kBadArgument;
    const int A = H * kD;
    CUtensorMap tqkv, tqs, tdo, tks;
    if (int e = fused_maps(&tqkv, &tqs, &tdo, qkv, qs, dout, B, N, A))
      return e;
    if (ks)
      if (int e = tile_map(&tks, ks, A, N, B, A, (long)N * A)) return e;
    if (int e = launch_bwd_dq<false>(tqkv, tqkv, tqs, tdo,
                                     ks ? &tks : nullptr, A, 2 * A, lse,
                                     delta, dqkv, 3 * A, B, N, H, k_scale,
                                     st))
      return e;
  } else {
    if (int e = max_smem((const void*)bwd_dq_f32, kSmemBwdF32)) return e;
    bwd_dq_f32<<<grid_for(B, N, H), kThreads, kSmemBwdF32, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale, k_scale);
  }
  return (int)cudaGetLastError();
}
