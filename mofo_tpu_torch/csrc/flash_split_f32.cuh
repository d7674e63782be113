// The column-split f32 (parity) forward: every head dim D above 256 for
// K1/K2 (through K3's entry points), K3 and K4, on flash_tiles.cuh's FMA
// products (the backward above 256 is wgmma_tf32_split.cuh's 3xTF32
// kernels). The split is wgmma_attn_split.cuh's: block (x, y, z) owns
// output columns [256 z, 256 z + 256) of its head (fewer in the last
// group), and S = Q K^T streams 64-column chunks of both operands through
// shared memory into one f32 sum. Every group forms the same S in the same
// order, so group 0 alone writes the LSE; each output has one writer.
//
// Layout: q, k, v at their own row strides, plane b = y / H at columns
// h D, h = y % H (K4: H = 1); out (B, N, H D) contiguous; lse (B H, N)
// f32; bias (B, N) f32 or null. Tiles are 32 rows (a 32 x 257 f32 group
// tile is 33 KB); kv columns >= N score -inf.
//
// Numerics: f32 in base e; q times the scale as it is loaded; K3 and K1 an
// online softmax and 1/l dividing the output; K4 (kTwoPass) two passes,
// p / l before P.V; the LSE a natural log.

#pragma once

#include <math.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kSplitRows = 32;   // rows of every f32 tile
constexpr int kSplitChunk = 64;  // head-dim columns of a streamed chunk
constexpr int kSplitCols = 256;  // output columns of a block (a group)

// Rows [row0, row0 + kSplitRows) x columns [0, cols) of src (row stride ld)
// into dst (row stride C + 1): rows >= n and columns >= cols as zeros, each
// value times mul (the scale fold; exact for mul = 1).
template <int C>
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          int row0, int n, int ld, int cols,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kSplitRows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C, row = row0 + r;
    dst[r * (C + 1) + c] =
        row < n && c < cols ? src[(size_t)row * ld + c] * mul : 0.f;
  }
}

// The score terms of kv tile k0 (the bias, null: 0; -inf past N) into sB.
__device__ __forceinline__ void load_kv_terms(float* sB, const float* bias_b,
                                              int k0, int N) {
  for (int i = threadIdx.x; i < kSplitRows; i += blockDim.x)
    sB[i] = k0 + i < N ? (bias_b ? bias_b[k0 + i] : 0.f) : -INFINITY;
}

// Writes a thread's rows (I ty + i, from row0) of a 32 x 256 accumulator,
// columns < cols, at dst + row * ld, rows >= N skipped; with l (not null)
// each row divided by its l[i].
template <int I, int J>
__device__ __forceinline__ void store_group(float* dst, size_t ld,
                                            const float (&acc)[I][J],
                                            int row0, int N, int cols,
                                            const float* l, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = row0 + I * ty + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (tx + 16 * j < cols)
        dst[(size_t)row * ld + tx + 16 * j] = l ? acc[i][j] / l[i]
                                                : acc[i][j];
  }
}

constexpr size_t smem_split_fwd_f32() {
  constexpr int R = kSplitRows;
  return ((size_t)2 * R * (kSplitChunk + 1) + R * (R + 1) +
          R * (kSplitCols + 1) + R) * sizeof(float);
}

// Grid (ceil(N / 32), B * H, G). One block: 32 query rows of one head
// against all N keys, output columns of group z.
template <bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
    split_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ lse, int N,
                  int H, int D, int ldq, int ldk, int ldv, float q_scale) {
  constexpr int R = kSplitRows, C = kSplitChunk, G = kSplitCols;
  constexpr int I = R / 16, JS = R / 16, JO = G / 16, LC = C + 1,
                LP = R + 1, LG = G + 1;
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
  float* sK = sQ + R * LC;
  float* sP = sK + R * LC;
  float* sV = sP + R * LP;
  float* sB = sV + R * LG;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int c0 = G * blockIdx.z, cols = min(G, D - c0);
  const int q0 = blockIdx.x * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + (size_t)b * N * ldq + h * D;
  const float* kb = k + (size_t)b * N * ldk + h * D;
  const float* vb = v + (size_t)b * N * ldv + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  float m[I], l[I], o[I][JO] = {};
#pragma unroll
  for (int i = 0; i < I; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int pass = 0; pass < (kTwoPass ? 2 : 1); ++pass) {
    const bool stats_only = kTwoPass && pass == 0;
    for (int k0 = 0; k0 < N; k0 += R) {
      float s[I][JS] = {};
      for (int cc = 0; cc < D; cc += C) {
        __syncthreads();  // the previous chunk's (and tile's) reads are done
        load_cols<C>(sQ, qb + cc, q0, N, ldq, C, q_scale);
        load_cols<C>(sK, kb + cc, k0, N, ldk, C, 1.f);
        if (cc == 0) load_kv_terms(sB, bb, k0, N);
        __syncthreads();
        gemm<I, JS, C, LC, 1, 1, LC>(s, sQ, sK, ty, tx, 1.f);
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          s[i][j] += sB[tx + 16 * j];
          mx = fmaxf(mx, s[i][j]);
        }
        const int r = I * ty + i;
        if (kTwoPass && !stats_only) {  // pass 2: P = exp(s - m) / l
#pragma unroll
          for (int j = 0; j < JS; ++j)
            sP[r * LP + tx + 16 * j] = expf(s[i][j] - m[i]) / l[i];
          continue;
        }
        // every tile holds a column < N, so m_new is finite
        const float m_new = fmaxf(m[i], row_max16(mx));
        const float corr = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          const float p = expf(s[i][j] - m_new);
          rs += p;
          if (!kTwoPass) sP[r * LP + tx + 16 * j] = p;
        }
        l[i] = l[i] * corr + row_sum16(rs);
        m[i] = m_new;
        if (!kTwoPass) {
#pragma unroll
          for (int j = 0; j < JO; ++j) o[i][j] *= corr;
        }
      }
      if (stats_only) continue;
      load_cols<G>(sV, vb + c0, k0, N, ldv, cols, 1.f);
      __syncthreads();
      gemm<I, JO, R, LP, 1, LG, 1>(o, sP, sV, ty, tx, 1.f);
    }
  }

  float* dst = out + (size_t)b * N * A + h * D + c0;
  store_group(dst, A, o, q0, N, cols, kTwoPass ? nullptr : l, ty, tx);
  if (blockIdx.z == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int row = q0 + I * ty + i;
      if (row < N) lse[(size_t)bh * N + row] = m[i] + logf(l[i]);
    }
  }
}

// -------------------------------------------------------------------------
// Launchers: B planes of N rows, H heads of D columns (a multiple of 64)
// a plane; each returns 0, kBadArgument or a cudaError_t from the set-up.
// -------------------------------------------------------------------------

dim3 split_grid_f32(int B, int N, int H, int D) {
  return dim3(cdiv(N, kSplitRows), B * H, cdiv(D, kSplitCols));
}

template <bool kTwoPass>
int launch_split_fwd_f32(const void* q, const void* k, const void* v,
                         const float* bias, void* out, float* lse, int B,
                         int N, int H, int D, int ldq, int ldk, int ldv,
                         float q_scale, cudaStream_t st) {
  if (D % kSplitChunk) return kBadArgument;
  constexpr size_t smem = smem_split_fwd_f32();
  auto kernel = split_fwd_f32<kTwoPass>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<split_grid_f32(B, N, H, D), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), lse, N,
      H, D, ldq, ldk, ldv, q_scale);
  return 0;
}

}  // namespace
