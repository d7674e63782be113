// Tile helpers shared by the flash-attention kernels of mh_flash_attention.cu
// (K3) and hm_flash_attention.cu (K4): shared-memory tile loads, the f32 FMA
// product of the parity kernels, the bf16 mma.sync m16n8k16 products of the
// tensor-core kernels, row reductions and the launch helpers. Everything is
// in an anonymous namespace: each source that includes it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"  // bf16, kBadArgument, max_smem

namespace {

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

// -------------------------------------------------------------------------
// Launch helpers
// -------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace
