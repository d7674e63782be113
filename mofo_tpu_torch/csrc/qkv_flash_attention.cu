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
// (A = H * D, D one of the built head dims 16, 32, 64, 128, 192 and 256:
// every kernel is a template on D, the entry points dispatch on it through
// wgmma_tiles.cuh's by_head_dim; or, above 256, any multiple of 64, run by
// K3's column-split kernels; the wrapper pads any other D with zero
// columns): q at column h*D, k at A + h*D, v at 2A + h*D, row stride
// 3A. The forward writes out (B, N, A) at column h*D
// and a compact (B, H, N) f32 row log-sum-exp. The backward writes one fused dqkv
// (B, N, 3A): dK/dV from one kernel, dQ from the other; in bf16 both read
// the prep pass's delta (B, H, N) f32 and q * q_scale (B, N, A).
//
// What bounds it on this card. At the MOFO geometries (N = 160 to 8192,
// D = 64) attention does N^2*D work on N*D bytes: at N >= 1568 it is bound
// by operations (the bf16 tensor-core rate), at N = 160 by bytes (and, for
// a kernel this short, by the host's launch). The flat head dims 16, 32 and
// 128 (models/layers.Attention's route at A % 128 == 0 with another
// attn_head_dim, e.g. 96 padded to 128) run the same kernels, templated on
// D: right first, not tuned (D = 128 holds an O accumulator twice D = 64's).
// At D = 192 and 256 a thread's registers cannot hold q's fragments beside
// the 64 x D output, nor dK/dV's two accumulators: those head dims run K3's
// strip kernels (wgmma_attn_wide.cuh) through K3's entry points
// (mh_flash_attention.cu), which take q, k and v as row-strided column views
// of the fused qkv and write dK, dV and dQ into the views of one dqkv; their
// f32 backward takes delta from the caller. Above 256 the same entry points
// run the column-split kernels (wgmma_attn_split.cuh), after the prep
// pass's wide form (a warp a head row).
//
// What the design does about it. Each block holds 64-row tiles of queries
// (or of keys/values) and streams the other side in 64-row tiles: one
// head's K and V at N = 1568 do not fit in a block's shared memory, so the
// TPU's "whole K/V rows resident" design does not carry over.
//   - The bf16 forward (K1, redesigned for Hopper, wgmma_tiles.cuh) makes
//     one pass over kv with an online softmax: two consumer warpgroups of 64
//     query rows each keep their q fragments (times scale * log2 e) in
//     registers, and a producer warpgroup's first warp keeps a ring of 3
//     (K, V) stages full by TMA from one 3D tensor map over (B, N, 3A)
//     (q, k and v are column offsets h * D, A + h * D and 2A + h * D of
//     it; rows past N arrive as zeros), so tile j + 1 is in flight while
//     tile j is multiplied; setmaxnreg hands the producer's registers to
//     the consumers. S = Q K^T and O += P V are wgmma.mma_async m64n64k16
//     chains on 128-byte-swizzled shared memory (V MN-major; 32- and
//     64-byte swizzles at D = 16 and 32, two 64-column sub-tiles at 128); the
//     un-normalized P goes from the accumulators (rounded to bf16) into
//     P.V, the accumulator is rescaled by exp2(m_old - m_new), and 1 / l
//     divides it at the end. 3 products would be the floor; it does 2.
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
//     own (mofo_tpu_torch/tools/main_path.py's bounds) and in a bf16 step
//     against the same step through the plain versions.
// The FMA kernels pad shared-memory rows to D + 1 (and 65) f32 values so
// micro-tile reads are free of bank conflicts. Ragged edges
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

#include "flash_tiles.cuh"
#include "wgmma_attn_bwd.cuh"
#include "wgmma_attn_split.cuh"
#include "wgmma_tiles.cuh"

// K3's entry points (mh_flash_attention.cu), which run K1/K2 above head dim
// 128 on column views of the fused qkv: q, k and v at row stride 3A, no
// bias.
extern "C" {
int mh_attn_fwd(const void* q, const void* k, const void* v,
                const void* bias, void* out, void* lse, int B, int N, int H,
                int D, int ldq, int ldk, int ldv, float q_scale, int bf16,
                void* stream);
int mh_attn_bwd_dkv(const void* q, const void* k, const void* v,
                    const void* bias, const void* dout, const void* lse,
                    const void* delta, const void* qs, void* dk, void* dv,
                    int B, int N, int H, int D, int ldq, int ldk, int ldv,
                    int lddkv, float q_scale, float dk_fix, int bf16,
                    void* stream);
int mh_attn_bwd_dq(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, const void* qs, const void* ks,
                   void* dq, int B, int N, int H, int D, int ldq, int ldk,
                   int ldv, int lddq, float q_scale, float k_scale, int bf16,
                   void* stream);
}

namespace {

constexpr int kRows = 64;  // rows of every tile (q and kv)

// -------------------------------------------------------------------------
// f32: FMA kernels (flash_tiles.cuh's 256 threads as 16 x 16). A 64 x 64
// score tile is a 4 x 4 micro-tile a thread, rows 4*ty + i, columns
// tx + 16*j; a 64 x D tile (O, dQ, dK, dV) a 4 x D/16 one.
// -------------------------------------------------------------------------

constexpr int kLdS = kRows + 1;  // padded row stride of the score tiles

template <int D>
constexpr size_t smem_fwd_f32() {
  return ((size_t)3 * kRows * (D + 1) + kRows * kLdS) * sizeof(float);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows against
// all N keys, streamed in 64-row tiles with an online softmax.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
            float* __restrict__ lse, int N, int H, float q_scale) {
  constexpr int LD = D + 1, JO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kRows * LD;
  float* sV = sK + kRows * LD;
  float* sP = sV + kRows * LD;
  const int A = H * D, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* base = qkv + (size_t)b * N * ld;

  load_f32<kRows, D>(sQ, base + h * D, q0, N, ld, q_scale);
  float m[4], l[4], o[4][JO] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    load_f32<kRows, D>(sK, base + A + h * D, k0, N, ld, 1.f);
    load_f32<kRows, D>(sV, base + 2 * A + h * D, k0, N, ld, 1.f);
    __syncthreads();
    float s[4][4] = {};
    gemm<4, 4, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
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
        sP[(4 * ty + i) * kLdS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JO; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    gemm<4, JO, kRows, kLdS, 1, LD, 1>(o, sP, sV, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = out + ((size_t)b * N + row) * A + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = o[i][j] / l[i];
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

// Loads one q tile's scaled q and dO, its LSE (+inf on rows >= N) and
// computes its delta = rowsum(dO * O), O read from device memory.
template <int D>
__device__ __forceinline__ void load_q_side_f32(
    float* sQ, float* sdO, float* sLse, float* sDelta, const float* qkv_b,
    const float* out_b, const float* dout_b, const float* lse_bh, int q0,
    int N, int A, int h, float q_scale) {
  load_f32<kRows, D>(sQ, qkv_b + h * D, q0, N, 3 * A, q_scale);
  load_f32<kRows, D>(sdO, dout_b + h * D, q0, N, A, 1.f);
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    sLse[threadIdx.x] = row < N ? lse_bh[row] : INFINITY;
  }
  __syncthreads();
  // four threads to a row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, row = q0 + r;
  float acc = 0.f;
  if (row < N) {
    const float* o = out_b + (size_t)row * A + h * D;
#pragma unroll
    for (int c = part * (D / 4); c < (part + 1) * (D / 4); ++c)
      acc = fmaf(sdO[r * (D + 1) + c], o[c], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) sDelta[r] = acc;
}

template <int D>
constexpr size_t smem_dkv_f32() {
  return ((size_t)4 * kRows * (D + 1) + 2 * kRows * kLdS + 2 * kRows) *
         sizeof(float);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 key/value rows;
// loops over all q tiles and accumulates dK and dV in registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_f32(const float* __restrict__ qkv, const float* __restrict__ out,
                const float* __restrict__ lse,
                const float* __restrict__ dout, float* __restrict__ dqkv,
                int N, int H, float q_scale) {
  constexpr int LD = D + 1, JO = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kRows * LD;
  float* sQ = sV + kRows * LD;
  float* sdO = sQ + kRows * LD;
  float* sP = sdO + kRows * LD;
  float* sdS = sP + kRows * kLdS;
  float* sLse = sdS + kRows * kLdS;
  float* sDelta = sLse + kRows;
  const int A = H * D, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qkv_b = qkv + (size_t)b * N * ld;

  load_f32<kRows, D>(sK, qkv_b + A + h * D, k0, N, ld, 1.f);
  load_f32<kRows, D>(sV, qkv_b + 2 * A + h * D, k0, N, ld, 1.f);
  float dk[4][JO] = {}, dv[4][JO] = {};

  for (int q0 = 0; q0 < N; q0 += kRows) {
    __syncthreads();  // the previous q tile's reads are done
    load_q_side_f32<D>(sQ, sdO, sLse, sDelta, qkv_b,
                       out + (size_t)b * N * A, dout + (size_t)b * N * A,
                       lse + (size_t)bh * N, q0, N, A, h, q_scale);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm<4, 4, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
    gemm<4, 4, D, LD, 1, 1, LD>(dp, sdO, sV, ty, tx, 1.f);
    // this block's kv rows >= N are never stored, so no column mask
    p_and_ds_f32(s, dp, sLse, sDelta, 0, kRows, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(4 * ty + i) * kLdS + tx + 16 * j] = s[i][j];
        sdS[(4 * ty + i) * kLdS + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // rows of dV/dK are kv positions: A[kv, q] = P[q, kv]
    gemm<4, JO, kRows, 1, kLdS, LD, 1>(dv, sP, sdO, ty, tx, 1.f);
    gemm<4, JO, kRows, 1, kLdS, LD, 1>(dk, sdS, sQ, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = dqkv + ((size_t)b * N + row) * ld + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) {
      dst[A + 16 * j] = dk[i][j];
      dst[2 * A + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
constexpr size_t smem_dq_f32() {
  return ((size_t)5 * kRows * (D + 1) + kRows * kLdS + 2 * kRows) *
         sizeof(float);
}

// Grid (ceil(N / 64), B * H). One block: one head's 64 query rows; loops
// over all kv tiles and accumulates dQ in registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_f32(const float* __restrict__ qkv, const float* __restrict__ out,
               const float* __restrict__ lse, const float* __restrict__ dout,
               float* __restrict__ dqkv, int N, int H, float q_scale,
               float k_scale) {
  constexpr int LD = D + 1, JO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kRows * LD;
  float* sK = sdO + kRows * LD;
  float* sKs = sK + kRows * LD;
  float* sV = sKs + kRows * LD;
  float* sdS = sV + kRows * LD;
  float* sLse = sdS + kRows * kLdS;
  float* sDelta = sLse + kRows;
  const int A = H * D, ld = 3 * A;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qkv_b = qkv + (size_t)b * N * ld;

  load_q_side_f32<D>(sQ, sdO, sLse, sDelta, qkv_b, out + (size_t)b * N * A,
                     dout + (size_t)b * N * A, lse + (size_t)bh * N, q0, N,
                     A, h, q_scale);
  float dq[4][JO] = {};

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // delta is written / the previous kv tile is consumed
    load_f32<kRows, D>(sK, qkv_b + A + h * D, k0, N, ld, 1.f);
    load_f32<kRows, D>(sKs, qkv_b + A + h * D, k0, N, ld, k_scale);
    load_f32<kRows, D>(sV, qkv_b + 2 * A + h * D, k0, N, ld, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    gemm<4, 4, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx, 1.f);
    gemm<4, 4, D, LD, 1, 1, LD>(dp, sdO, sV, ty, tx, 1.f);
    p_and_ds_f32(s, dp, sLse, sDelta, k0, N, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(4 * ty + i) * kLdS + tx + 16 * j] = dp[i][j];
    __syncthreads();
    gemm<4, JO, kRows, kLdS, 1, LD, 1>(dq, sdS, sKs, ty, tx, 1.f);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    float* dst = dqkv + ((size_t)b * N + row) * ld + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) dst[16 * j] = dq[i][j];
  }
}

// -------------------------------------------------------------------------
// bf16 forward (K1), redesigned for Hopper (wgmma_tiles.cuh). A warp's 16
// accumulator rows are in mma.sync's m16n8 layout (g = lane / 4, t = lane %
// 4): c[nt] holds rows g (c0, c1) and g + 8 (c2, c3), columns 8 nt + 2t and
// 8 nt + 2t + 1.
// -------------------------------------------------------------------------

constexpr int kFwdStages = 3;
template <int D>
constexpr size_t smem_fwd_bf16() {
  return 1024 + (size_t)(kWG + 2 * kFwdStages) * tile_bytes<D>() +
         (2 * kFwdStages + 1) * sizeof(uint64_t);
}

// Grid (ceil(N / (64 kWG)), B * H). One block: 64 kWG query rows of one head
// against all N keys, streamed once in 64-row (K, V) tiles with an online
// softmax (base 2). Each consumer warpgroup keeps the fragments of its 64
// query rows (q times q_scale, in bf16) in registers; the producer
// warpgroup's first warp keeps a ring of kFwdStages (K, V) stages full by
// TMA. One tensor map over the fused (B, N, 3A) serves q (column h * D), k
// (A + h * D) and v (2A + h * D); rows past N arrive as zeros. The
// un-normalized P is rounded to bf16 before P.V, and 1 / l divides the
// output at the end.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    fwd_bf16(const __grid_constant__ CUtensorMap tqkv, bf16* __restrict__ out,
             float* __restrict__ lse, int N, int H, float q_scale) {
  constexpr int kTE = tile_elems<D>(), kTB = tile_bytes<D>();
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sK = sQ + kWG * kTE;
  bf16* sV = sK + kFwdStages * kTE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kFwdStages * kTE);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG && lane == 0) {
      mbar_expect_tx(qbar, kWG * kTB);
      for (int w = 0; w < kWG; ++w)
        tma_tile_d<D>(sQ + w * kTE, &tqkv, qbar, h * D, q0 + kTileRows * w,
                      b);
      for (int j = 0; j < T; ++j) {
        const int s = j % kFwdStages;
        mbar_wait(&empty[s], ((j / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTB);
        tma_tile_d<D>(sK + s * kTE, &tqkv, &full[s], A + h * D,
                      j * kTileRows, b);
        tma_tile_d<D>(sV + s * kTE, &tqkv, &full[s], 2 * A + h * D,
                      j * kTileRows, b);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    mbar_wait(qbar, 0);
    uint32_t qa[D / 16][4];
    load_a_sw(qa, sQ + wg * kTE, r0, q_scale);
    float o[D / 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int j = 0; j < T; ++j) {
      const int s = j % kFwdStages;
      mbar_wait(&full[s], (j / kFwdStages) & 1);
      float sc[8][4] = {};
      wgmma_tile_d<0, D>(sc, qa, sK + s * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if ((j + 1) * kTileRows > N) {  // the ragged last tile
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * kTileRows + 8 * nt + 2 * t + (e & 1) >= N)
              sc[nt][e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds at least one valid column, so the max is finite
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      uint32_t pa[4][4];  // P rounded to bf16: the A fragments of P.V
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float p0 = exp2f(sc[nt][e] - m[e >> 1]);
          const float p1 = exp2f(sc[nt][e + 1] - m[e >> 1]);
          rs[e >> 1] += p0 + p1;
          pa[nt >> 1][2 * (nt & 1) + (e >> 1)] = bf16x2(p0, p1);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
      wgmma_tile_d<1, D>(o, pa, sV + s * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + kTileRows * wg + r0 + g + 8 * half;
      if (row >= N) continue;
      bf16* dst = out + ((size_t)b * N + row) * A + h * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
            __floats2bfloat162_rn(o[nt][2 * half] / l[half],
                                  o[nt][2 * half + 1] / l[half]);
      // LSE in log2 units: the scores carry log2(e)
      if (t == 0) lse[(size_t)bh * N + row] = m[half] + log2f(l[half]);
    }
  }
}

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

dim3 grid_for(int B, int N, int H) {
  return dim3((N + kRows - 1) / kRows, B * H);
}

bool bad(int B, int N, int H) {
  return B < 1 || N < 1 || H < 1 || (long)B * H > 65535;
}

// Column `col` of a row of qkv (or dqkv) of the element type.
const void* at_col(const void* p, long col, int is_bf16) {
  return static_cast<const char*>(p) + col * (is_bf16 ? 2 : 4);
}
void* at_col(void* p, long col, int is_bf16) {
  return static_cast<char*>(p) + col * (is_bf16 ? 2 : 4);
}

// The fused (B, N, 3A) map: boxes of box_cols<D>() columns, one per tile
// (two at D = 128).
template <int D>
int fused_map(CUtensorMap* map, const void* qkv, int B, int N, int A) {
  return tile_map(map, qkv, 3 * A, N, B, 3 * A, (long)N * 3 * A,
                  box_cols<D>());
}

// A (B, N, A) map (q * q_scale, dO, k * k_scale).
template <int D>
int row_map(CUtensorMap* map, const void* base, int B, int N, int A) {
  return tile_map(map, base, A, N, B, A, (long)N * A, box_cols<D>());
}

// K1/K2 through K3's entry points (above head dim 128: the strip kernels at
// 192 and 256, the column-split ones above): q, k and v (and dq, dk, dv)
// the column views of qkv (dqkv) at offsets 0, A and 2A, row stride 3A.
int k3_fwd(const void* qkv, void* out, void* lse, int B, int N, int H, int D,
           float q_scale, int is_bf16, cudaStream_t st) {
  const int A = H * D;
  return mh_attn_fwd(qkv, at_col(qkv, A, is_bf16),
                     at_col(qkv, 2 * A, is_bf16), nullptr, out, lse, B, N, H,
                     D, 3 * A, 3 * A, 3 * A, q_scale, is_bf16, st);
}

// f32 takes delta from the caller (K3's kernels).
int k3_dkv(const void* qkv, const void* lse, const void* dout,
           const void* delta, const void* qs, void* dqkv, int B, int N, int H,
           int D, float q_scale, float dk_fix, int is_bf16, cudaStream_t st) {
  const int A = H * D;
  return mh_attn_bwd_dkv(qkv, at_col(qkv, A, is_bf16),
                         at_col(qkv, 2 * A, is_bf16), nullptr, dout, lse,
                         delta, qs, at_col(dqkv, A, is_bf16),
                         at_col(dqkv, 2 * A, is_bf16), B, N, H, D, 3 * A,
                         3 * A, 3 * A, 3 * A, q_scale, dk_fix, is_bf16, st);
}

int k3_dq(const void* qkv, const void* lse, const void* dout,
          const void* delta, const void* qs, const void* ks, void* dqkv,
          int B, int N, int H, int D, float q_scale, float k_scale,
          int is_bf16, cudaStream_t st) {
  const int A = H * D;
  return mh_attn_bwd_dq(qkv, at_col(qkv, A, is_bf16),
                        at_col(qkv, 2 * A, is_bf16), nullptr, dout, lse,
                        delta, qs, ks, dqkv, B, N, H, D, 3 * A, 3 * A, 3 * A,
                        3 * A, q_scale, k_scale, is_bf16, st);
}

template <int D>
int run_fwd(const void* qkv, void* out, void* lse, int B, int N, int H,
            float q_scale, int is_bf16, cudaStream_t st) {
  if constexpr (D > 128) {
    return k3_fwd(qkv, out, lse, B, N, H, D, q_scale, is_bf16, st);
  } else if (is_bf16) {
    CUtensorMap tqkv;
    if (int e = fused_map<D>(&tqkv, qkv, B, N, H * D)) return e;
    constexpr size_t smem = smem_fwd_bf16<D>();
    auto kernel = fwd_bf16<D>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<hopper_grid(B, N, H), kHopperThreads, smem, st>>>(
        tqkv, static_cast<bf16*>(out), static_cast<float*>(lse), N, H,
        q_scale);
    return 0;
  } else {
    constexpr size_t smem = smem_fwd_f32<D>();
    auto kernel = fwd_f32<D>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<grid_for(B, N, H), kThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out),
        static_cast<float*>(lse), N, H, q_scale);
    return 0;
  }
}

// The tensor maps of the bf16 backward (wgmma_attn_bwd.cuh, base 2 on the
// fused layout): one map over (B, N, 3A) serves k (column offset A) and v
// (2A); q * q_scale and dO are (B, N, A).
template <int D>
int fused_maps(CUtensorMap* tqkv, CUtensorMap* tqs, CUtensorMap* tdo,
               const void* qkv, const void* qs, const void* dout, int B,
               int N, int A) {
  if (int e = fused_map<D>(tqkv, qkv, B, N, A)) return e;
  if (int e = row_map<D>(tqs, qs, B, N, A)) return e;
  return row_map<D>(tdo, dout, B, N, A);
}

template <int D>
int run_dkv(const void* qkv, const void* out, const void* lse,
            const void* dout, const void* delta, const void* qs, void* dqkv,
            int B, int N, int H, float q_scale, float dk_fix, int is_bf16,
            cudaStream_t st) {
  if constexpr (D > 128) {
    return k3_dkv(qkv, lse, dout, delta, qs, dqkv, B, N, H, D, q_scale,
                  dk_fix, is_bf16, st);
  } else if (is_bf16) {
    if (!delta || !qs) return kBadArgument;
    const int A = H * D;
    CUtensorMap tqkv, tqs, tdo;
    if (int e = fused_maps<D>(&tqkv, &tqs, &tdo, qkv, qs, dout, B, N, A))
      return e;
    auto dk = static_cast<bf16*>(dqkv) + A;
    return launch_bwd_dkv<false, false, D>(tqkv, tqkv, tqs, tdo, A, 2 * A,
                                           lse, delta, nullptr, dk, dk + A,
                                           3 * A, B, N, H, dk_fix, st);
  } else {
    // f32 works in base e: dK needs no 1/log2(e) fix
    constexpr size_t smem = smem_dkv_f32<D>();
    auto kernel = bwd_dkv_f32<D>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<grid_for(B, N, H), kThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale);
    return 0;
  }
}

template <int D>
int run_dq(const void* qkv, const void* out, const void* lse,
           const void* dout, const void* delta, const void* qs,
           const void* ks, void* dqkv, int B, int N, int H, float q_scale,
           float k_scale, int is_bf16, cudaStream_t st) {
  if constexpr (D > 128) {
    return k3_dq(qkv, lse, dout, delta, qs, ks, dqkv, B, N, H, D, q_scale,
                 k_scale, is_bf16, st);
  } else if (is_bf16) {
    if (!delta || !qs) return kBadArgument;
    const int A = H * D;
    CUtensorMap tqkv, tqs, tdo, tks;
    if (int e = fused_maps<D>(&tqkv, &tqs, &tdo, qkv, qs, dout, B, N, A))
      return e;
    if (ks)
      if (int e = row_map<D>(&tks, ks, B, N, A)) return e;
    return launch_bwd_dq<false, false, D>(tqkv, tqkv, tqs, tdo,
                                          ks ? &tks : nullptr, A, 2 * A, lse,
                                          delta, nullptr, dqkv, 3 * A, B, N,
                                          H, k_scale, st);
  } else {
    constexpr size_t smem = smem_dq_f32<D>();
    auto kernel = bwd_dq_f32<D>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<grid_for(B, N, H), kThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(out),
        static_cast<const float*>(lse), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, H, q_scale, k_scale);
    return 0;
  }
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take (a head dim up to 256 that is not
// built, or one above it that is no multiple of 64; above 256 every entry
// point runs K3's, whose column-split kernels take D at run time). `is_bf16` selects __nv_bfloat16 (the tensor-core
// kernels) over float (the FMA kernels). q_scale and k_scale are already
// rounded to the element type; bf16 rows must be 16-byte aligned.

extern "C" int qkv_attn_fwd(const void* qkv, void* out, void* lse, int B,
                            int N, int H, int D, float q_scale, int is_bf16,
                            void* stream) {
  if (bad(B, N, H)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? k3_fwd(qkv, out, lse, B, N, H, D, q_scale, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_fwd<decltype(d)::value>(
                          qkv, out, lse, B, N, H, q_scale, is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// The bf16 backward's prep pass: delta (B, H, N) f32 and q * q_scale (B, N,
// A) bf16, and k * k_scale into ks unless ks is null (k_scale a power of
// two: the dQ kernel then scales its accumulator).
extern "C" int qkv_attn_bwd_prep(const void* qkv, const void* out,
                                 const void* dout, void* delta, void* qs,
                                 void* ks, int B, int N, int H, int D,
                                 float q_scale, float k_scale, void* stream) {
  if (bad(B, N, H)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const bf16*>(qkv) + H * D;
  if (int e = D > kStripMaxDim
                  ? launch_prep_wide(qkv, k, 3 * H * D, 3 * H * D, out, dout,
                                     delta, qs, ks, B, N, H, D, q_scale,
                                     k_scale, st)
                  : by_head_dim(D, [&](auto d) {
                      constexpr int kD = decltype(d)::value;
                      return launch_bwd_prep<kD / 8>(
                          qkv, k, 3 * H * kD, 3 * H * kD, out, dout, delta,
                          qs, ks, B, N, H, q_scale, k_scale, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta and qs come from qkv_attn_bwd_prep (out is not read); f32:
// qs is null and, up to D = 128, delta too: the kernel forms both from out
// and qkv.
extern "C" int qkv_attn_bwd_dkv(const void* qkv, const void* out,
                                const void* lse, const void* dout,
                                const void* delta, const void* qs, void* dqkv,
                                int B, int N, int H, int D, float q_scale,
                                float dk_fix, int is_bf16, void* stream) {
  if (bad(B, N, H)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? k3_dkv(qkv, lse, dout, delta, qs, dqkv, B, N, H, D,
                           q_scale, dk_fix, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_dkv<decltype(d)::value>(
                          qkv, out, lse, dout, delta, qs, dqkv, B, N, H,
                          q_scale, dk_fix, is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta, qs and (up to D = 128, unless k_scale is a power of two) ks
// come from qkv_attn_bwd_prep; f32: qs and ks are null, and delta too up to
// D = 128 (the kernel reads out and qkv).
extern "C" int qkv_attn_bwd_dq(const void* qkv, const void* out,
                               const void* lse, const void* dout,
                               const void* delta, const void* qs,
                               const void* ks, void* dqkv, int B, int N,
                               int H, int D, float q_scale, float k_scale,
                               int is_bf16, void* stream) {
  if (bad(B, N, H)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? k3_dq(qkv, lse, dout, delta, qs, ks, dqkv, B, N, H, D,
                          q_scale, k_scale, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_dq<decltype(d)::value>(
                          qkv, out, lse, dout, delta, qs, ks, dqkv, B, N, H,
                          q_scale, k_scale, is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}
