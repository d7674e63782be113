// Tile helpers of the f32 flash-attention kernels still on FMAs: K3's
// dK/dV up to head dim 128 (mh_flash_attention.cu) and K4's f32 kernels up
// to 256 (hm_flash_attention.cu): shared-memory tile loads, the FMA
// product, row reductions and a launch helper. They replace the TPU
// kernels of mofo_tpu/ops/flash_attention.py in f32 (each source names
// its own). What bounds them: the inner loop (gemm) has each thread read
// 8 shared-memory words for every 16 FMAs of its 4 x 4 micro-tile, which
// caps it near half the card's 67 TFLOP/s f32 FMA rate, and the tiles load
// synchronously between two __syncthreads, so loads and math never
// overlap. K1's and K3's f32 forwards, K2's f32 dK/dV, the f32 dQs of K2
// and K3 and every f32 kernel above 256 left these helpers for 3xTF32
// products on the tensor cores, fed by TMA (wgmma_tf32.cuh); the kernels
// here wait for the same redesign
// (ROADMAP). The bf16 kernels are
// built from wgmma_tiles.cuh. Everything is in an anonymous namespace:
// each source that includes it gets its own copy.

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
// Launch helpers
// -------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace
