// Masked multihead flash attention for Hopper (sm_90a): separate q, k, v
// with an optional per-kv-position additive bias row. Forward, the
// backward's prep pass and the two halves of the backward. Plain C
// interface, loaded from Python with ctypes
// (mofo_tpu_torch/ops/flash_attention.py); built by
// mofo_tpu_torch/ops/_build.py together with the other csrc/*.cu sources.
// The bf16 kernels are built from wgmma_tiles.cuh (TMA, mbarriers, wgmma):
// the forward up to 256 and the backward at 192 and 256 are
// wgmma_attn_wide.cuh's strip kernels, the backward up to 128 and the prep
// pass wgmma_attn_bwd.cuh's, shared with K2 and K4, and every kernel above
// 256 wgmma_attn_split.cuh's column-split ones. The f32 FMA kernels' tile
// loads, products and reductions are flash_tiles.cuh's (the column-split
// forward flash_split_f32.cuh's), which hm_flash_attention.cu (K4) shares;
// the f32 backward above 256 is wgmma_tf32_split.cuh's.
//
// Replaces the TPU kernel K3 of mofo_tpu/ops/flash_attention.py:
//   mh_attn_fwd      <- _mh_fwd_impl (:653) / _mh_fwd_kernel with has_bias
//                       (:460)
//   mh_attn_bwd_prep <- _mh_bwd_impl's delta, computed in XLA (:751-758),
//                       and the kernels' in-kernel scale folds (bf16 only)
//   mh_attn_bwd_dkv  <- _mh_bwd_impl (:737) / _mh_dqkv_kernel (:523), dK/dV
//   mh_attn_bwd_dq   <- _mh_bwd_impl (:737) / _mh_dqkv_kernel (:523), dQ
//
// Layout. q, k and v are (B, N, H*D) with their own row strides, so k and v
// can be column views of a fused (B, N, 2A) kv projection (A = H * D), or of
// K1's fused (B, N, 3A) qkv: qkv_flash_attention.cu runs K1/K2 above head
// dim 128 through these entry points. D is one of the built head dims 16,
// 32, 64, 128, 192 and 256 (wgmma_tiles.cuh's by_head_dim) or, above 256,
// any multiple of 64 (the column-split kernels take it at run time); the
// wrapper pads any other D with zero columns. The bias is a (B, N) f32
// row (0 or -1e30), shared by every head and query, or absent (null). The
// forward writes out (B, N, A) and a compact (B, H, N) f32 row
// log-sum-exp; the backward takes delta = rowsum(dO * O) per head,
// (B, H, N) f32 (in bf16 from the prep pass, with q * q_scale (B, N, A)),
// writes dK and dV at their own row stride (one (B, N, 2A) dkv in the port)
// and dQ at its own (contiguous (B, N, A) in the port, dqkv's for K2).
//
// What bounds it on this card. At the ViT-B MCA geometry (N = 1568, H = 3,
// D = 256) attention does the same N^2 * A work as one backbone block's
// attention (A = 768) on N * A bytes per operand: it is bound by operations
// (the bf16 tensor-core rate), about 190 FLOP per byte moved; the prep pass
// (3 reads, 1 write of N A values) by bytes.
//
// What the design does about it. D = 256 is the hard part: a 64 x 256 f32
// output accumulator is 128 registers a thread of a warpgroup, and a 64-row
// operand strip is 32 KB of shared memory (wgmma_attn_wide.cuh says how its
// strip kernels keep the q strip in shared memory, split the backward's
// outputs between the warpgroups and fold a k scale into the K strip).
//   - The bf16 forward is the strip forward at every D (one 64 x D box at
//     16 and 32, D / 64 boxes above): two consumer warpgroups of 64 query
//     rows, a producer warp keeping a ring of (K, V) stages full by TMA and
//     staging each tile's bias (-inf past N). One block an SM: 13 x 30
//     blocks at the MCA are three waves on 132 SMs.
//   - The bf16 backward runs after a prep pass (mh_attn_bwd_prep) that reads
//     q, O and dO once and writes delta and q * q_scale (and k * k_scale up
//     to D = 128 when that scale is no power of two), so no torch reduction
//     runs on the card and neither kernel reads O or rescales a q tile. It
//     is two kernels (dK/dV over kv tiles, dQ over q tiles), so each output
//     has exactly one writer: no atomics, deterministic sums. Up to D = 128
//     they are wgmma_attn_bwd.cuh's, with the bias flag; at 192 and 256 the
//     strip kernels.
//   - Above D = 256 the 64 x D output no longer fits a warpgroup's
//     registers: the column-split kernels (wgmma_attn_split.cuh) stream D
//     through the score products and split the output in groups of 256
//     columns over the grid, each group forming S (and dP) again; the
//     MCA's 2 and 1 heads (D = 384, 768) and ViT-L's 3 (341, padded to 384)
//     run there.
//   - The f32 dQ at every D up to 256, and the f32 forward and dK/dV at D
//     = 192 and 256 (the parity path's MCA, and K1/K2's f32 at those
//     widths; K2's f32 dQ at every D), run products in 3xTF32 on wgmma
//     (each operand split into TF32 hi and lo, lo.hi + hi.lo + hi.hi in
//     f32: as accurate as f32), fed by TMA: dQ up to 128 is
//     wgmma_tf32_dq.cuh's narrow kernel (q * q_scale and dO resident as
//     (hi, lo) pairs, K, V and K transposed streamed, a bias flag), the
//     rest wgmma_tf32_wide.cuh's, with D streamed in 64-column chunks
//     beside one resident (hi, lo) strip, and dK and dV written by
//     separate blocks. Above 256 the f32 dK/dV and dQ are
//     wgmma_tf32_split.cuh's column-split 3xTF32 kernels (both operands of
//     every contraction over D streamed, balanced groups of at most 256
//     columns, dV, dK and dQ each by its own blocks). The f32 forward and
//     dK/dV up to D = 128, and the f32 forward above 256
//     (flash_split_f32.cuh), use FMAs (flash_tiles.cuh). All tiles above
//     48 KB are dynamic shared memory.
// Ragged N is masked in-kernel (kv columns >= N score -inf, q rows >= N carry
// +inf LSE in the backward and are never stored); nothing is padded in HBM.
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

#include "flash_split_f32.cuh"
#include "flash_tiles.cuh"
#include "wgmma_attn_bwd.cuh"
#include "wgmma_attn_split.cuh"
#include "wgmma_attn_wide.cuh"
#include "wgmma_tf32_dq.cuh"
#include "wgmma_tf32_split.cuh"
#include "wgmma_tf32_wide.cuh"
#include "wgmma_tiles.cuh"

namespace {

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
// Launchers
// -------------------------------------------------------------------------

// D: a built head dim (by_head_dim); ld*: row strides of at least A.
bool bad(int B, int N, int H, int ldq, int ldk, int ldv, int A) {
  return B < 1 || N < 1 || H < 1 || B * H > 65535 || ldq < A || ldk < A ||
         ldv < A;
}

// Tiles of the f32 FMA kernels (the forward and dK/dV up to D = 128).
constexpr int kFmaRows = 64;

// A (B, N, A) bf16 operand at row stride ld, boxes of box_cols<D>().
template <int D>
int mh_map(CUtensorMap* map, const void* base, int B, int N, int A, int ld) {
  return tile_map(map, base, A, N, B, ld, (long)N * ld, box_cols<D>());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int N, int H, int ldq, int ldk,
        int ldv, float q_scale, int bf16_, cudaStream_t st) {
  if (bf16_) {
    // q, k and v keep their row strides: k and v may be column views of a
    // fused (B, N, 2A) kv projection (or of K1's (B, N, 3A) qkv)
    const int A = H * D;
    CUtensorMap tq, tk, tv;
    if (int e = mh_map<D>(&tq, q, B, N, A, ldq)) return e;
    if (int e = mh_map<D>(&tk, k, B, N, A, ldk)) return e;
    if (int e = mh_map<D>(&tv, v, B, N, A, ldv)) return e;
    return launch_strip_fwd<D>(tq, tk, tv, bias, out, lse, B, N, H, q_scale,
                               st);
  }
  if constexpr (D >= 192) {  // 3xTF32 on wgmma, D streamed in chunks
    return launch_fwd_tf32<D>(q, k, v, bias, out, lse, B, N, H, ldq, ldk,
                              ldv, q_scale, st);
  } else {
    constexpr int T = kFmaRows;
    constexpr size_t smem = smem_fwd_f32<D, T, T>();
    auto kernel = mh_fwd_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), lse, N,
        H, ldq, ldk, ldv, q_scale);
    return 0;
  }
}

// The tensor maps of the bf16 backward: k and v on their own row strides
// (column views of a fused kv, or tensors of their own), the prep pass's
// q * q_scale and dO as contiguous (B, N, A).
template <int D>
int bwd_maps(CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tqs,
             CUtensorMap* tdo, const void* k, const void* v, const void* qs,
             const void* dout, int B, int N, int A, int ldk, int ldv) {
  if (int e = mh_map<D>(tk, k, B, N, A, ldk)) return e;
  if (int e = mh_map<D>(tv, v, B, N, A, ldv)) return e;
  if (int e = mh_map<D>(tqs, qs, B, N, A, A)) return e;
  return mh_map<D>(tdo, dout, B, N, A, A);
}

// bf16: wgmma_attn_bwd.cuh's kernels with the bias flag up to D = 128,
// wgmma_attn_wide.cuh's strip kernels above.
template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta,
            const void* qs, void* dk, void* dv, int B, int N, int H, int ldq,
            int ldk, int ldv, int lddkv, float q_scale, float dk_fix,
            int bf16_, cudaStream_t st) {
  if (bf16_) {
    if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
    CUtensorMap tk, tv, tqs, tdo;
    if (int e = bwd_maps<D>(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N,
                            H * D, ldk, ldv))
      return e;
    if constexpr (D <= 128)
      return launch_bwd_dkv<false, true, D>(tk, tv, tqs, tdo, 0, 0, lse,
                                            delta, bias, dk, dv, lddkv, B, N,
                                            H, dk_fix, st);
    else
      return launch_strip_dkv<D, false>(tk, tv, tqs, tdo, bias, lse, delta,
                                        dk, dv, lddkv, B, N, H, dk_fix, st);
  }
  // f32 works in base e: dK needs no 1/log2(e) fix
  if constexpr (D >= 192) {  // 3xTF32 on wgmma: dV and dK blocks
    return launch_dkv_tf32<D>(q, k, v, bias, dout, lse, delta, dk, dv, B, N,
                              H, ldq, ldk, ldv, lddkv, q_scale, st);
  } else {
    constexpr int T = kFmaRows;
    constexpr size_t smem = smem_dkv_f32<D, T, T>();
    auto kernel = mh_bwd_dkv_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout),
        lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), N, H,
        ldq, ldk, ldv, lddkv, q_scale);
    return 0;
  }
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* delta,
           const void* qs, const void* ks, void* dq, int B, int N, int H,
           int ldq, int ldk, int ldv, int lddq, float q_scale, float k_scale,
           int bf16_, cudaStream_t st) {
  if (bf16_) {
    if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
    const int A = H * D;
    CUtensorMap tk, tv, tqs, tdo, tks;
    if (int e = bwd_maps<D>(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N, A,
                            ldk, ldv))
      return e;
    if constexpr (D <= 128) {
      if (ks)
        if (int e = mh_map<D>(&tks, ks, B, N, A, A)) return e;
      return launch_bwd_dq<false, true, D>(tk, tv, tqs, tdo,
                                           ks ? &tks : nullptr, 0, 0, lse,
                                           delta, bias, dq, lddq, B, N, H,
                                           k_scale, st);
    } else {
      // no room for a third strip a stage: a scale that is not a power of
      // two is folded into the K strip in place, ks is not read
      return launch_strip_dq<D, false>(tk, tv, tqs, tdo, bias, lse, delta,
                                       dq, lddq, B, N, H, k_scale, st);
    }
  }
  // f32: 3xTF32 on wgmma at every D, the narrow kernel up to 128 (its bias
  // flag set by a non-null bias), D streamed in chunks at 192 and 256
  return launch_dq_tf32<D>(q, k, v, bias, dout, lse, delta, dq, B, N, H,
                           ldq, ldk, ldv, lddq, q_scale, k_scale, st);
}

// ---- above head dim 256: the column-split kernels, D at run time ----------
// (wgmma_attn_split.cuh in bf16; in f32 flash_split_f32.cuh's forward and
// wgmma_tf32_split.cuh's 3xTF32 backward; D a multiple of 64, the wrapper
// pads any other)

int split_fwd(const void* q, const void* k, const void* v, const float* bias,
              void* out, float* lse, int B, int N, int H, int D, int ldq,
              int ldk, int ldv, float q_scale, int bf16_, cudaStream_t st) {
  return bf16_ ? launch_split_fwd<false>(q, k, v, ldq, ldk, ldv, bias, out,
                                         lse, B, N, H, D, q_scale, st)
               : launch_split_fwd_f32<false>(q, k, v, bias, out, lse, B, N,
                                             H, D, ldq, ldk, ldv, q_scale,
                                             st);
}

int split_dkv(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta,
              const void* qs, void* dk, void* dv, int B, int N, int H, int D,
              int ldq, int ldk, int ldv, int lddkv, float q_scale,
              float dk_fix, int bf16_, cudaStream_t st) {
  return bf16_ ? launch_split_dkv<false>(k, v, ldk, ldv, qs, dout, bias, lse,
                                         delta, dk, dv, lddkv, B, N, H, D,
                                         dk_fix, st)
               : launch_split_dkv_tf32(q, k, v, bias, dout, lse, delta, dk,
                                       dv, B, N, H, D, ldq, ldk, ldv, lddkv,
                                       q_scale, st);
}

int split_dq(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* delta,
             const void* qs, const void* ks, void* dq, int B, int N, int H,
             int D, int ldq, int ldk, int ldv, int lddq, float q_scale,
             float k_scale, int bf16_, cudaStream_t st) {
  return bf16_ ? launch_split_dq<false>(k, v, ldk, ldv, qs, ks, dout, bias,
                                        lse, delta, dq, lddq, B, N, H, D,
                                        k_scale, st)
               : launch_split_dq_tf32(q, k, v, bias, dout, lse, delta, dq,
                                      B, N, H, D, ldq, ldk, ldv, lddq,
                                      q_scale, k_scale, st);
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take (a head dim up to 256 that is not
// built, or one above it that is no multiple of 64). `bf16` selects
// __nv_bfloat16 (the tensor-core kernels) over float (3xTF32 on the tensor
// cores for dQ, for the forward and dK/dV at head dims 192 and 256, and for
// dK/dV above 256; FMAs for the forward and dK/dV up to 128 and the forward
// above 256). q_scale and k_scale are
// already rounded to the element type; rows must be 16-byte aligned (TMA
// reads them). ld* are row strides in elements;
// dout and out are (B, N, H*D) contiguous; lse and delta (B, H, N) f32;
// bias (B, N) f32 or null. qkv_flash_attention.cu calls these four above
// head dim 128 with q, k and v (and dk, dv, dq) as column views of the
// fused (B, N, 3A) qkv (dqkv) and no bias. Above head dim 256 each entry
// point runs the column-split kernels.

extern "C" int mh_attn_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* lse, int B,
                           int N, int H, int D, int ldq, int ldk, int ldv,
                           float q_scale, int bf16, void* stream) {
  if (bad(B, N, H, ldq, ldk, ldv, H * D)) return kBadArgument;
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? split_fwd(q, k, v, b, out, l, B, N, H, D, ldq, ldk, ldv,
                              q_scale, bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return fwd<decltype(d)::value>(q, k, v, b, out, l, B, N,
                                                     H, ldq, ldk, ldv, q_scale,
                                                     bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// The bf16 backward's prep pass: delta (B, H, N) f32 and q * q_scale
// (B, N, A) bf16 from q (row stride ldq), out and dout, and k * k_scale
// (k at row stride ldk) into ks unless ks is null.
extern "C" int mh_attn_bwd_prep(const void* q, const void* k,
                                const void* out, const void* dout,
                                void* delta, void* qs, void* ks, int B, int N,
                                int H, int D, int ldq, int ldk, float q_scale,
                                float k_scale, void* stream) {
  if (bad(B, N, H, ldq, ldk, ldk, H * D)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? launch_prep_wide(q, k, ldq, ldk, out, dout, delta, qs, ks,
                                     B, N, H, D, q_scale, k_scale, st)
                  : by_head_dim(D, [&](auto d) {
                      return launch_bwd_prep<decltype(d)::value / 8>(
                          q, k, ldq, ldk, out, dout, delta, qs, ks, B, N, H,
                          q_scale, k_scale, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta and qs come from mh_attn_bwd_prep (q is not read); f32: delta
// is the caller's reduction, qs null, and the kernel scales q itself.
extern "C" int mh_attn_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta,
                               const void* qs, void* dk, void* dv, int B,
                               int N, int H, int D, int ldq, int ldk, int ldv,
                               int lddkv, float q_scale, float dk_fix,
                               int bf16, void* stream) {
  if (bad(B, N, H, ldq, ldk, ldv, H * D) || lddkv < H * D || !delta)
    return kBadArgument;
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<const float*>(lse);
  const auto d_ = static_cast<const float*>(delta);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? split_dkv(q, k, v, b, dout, l, d_, qs, dk, dv, B, N, H, D,
                              ldq, ldk, ldv, lddkv, q_scale, dk_fix, bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return bwd_dkv<decltype(d)::value>(
                          q, k, v, b, dout, l, d_, qs, dk, dv, B, N, H, ldq,
                          ldk, ldv, lddkv, q_scale, dk_fix, bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta, qs and (up to D = 128 and above 256, unless k_scale is a
// power of two) ks come from mh_attn_bwd_prep; f32: qs and ks are null,
// delta is the caller's reduction. dq at row stride lddq.
extern "C" int mh_attn_bwd_dq(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* delta,
                              const void* qs, const void* ks, void* dq, int B,
                              int N, int H, int D, int ldq, int ldk, int ldv,
                              int lddq, float q_scale, float k_scale,
                              int bf16, void* stream) {
  if (bad(B, N, H, ldq, ldk, ldv, H * D) || lddq < H * D || !delta)
    return kBadArgument;
  const auto b = static_cast<const float*>(bias);
  const auto l = static_cast<const float*>(lse);
  const auto d_ = static_cast<const float*>(delta);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? split_dq(q, k, v, b, dout, l, d_, qs, ks, dq, B, N, H, D,
                             ldq, ldk, ldv, lddq, q_scale, k_scale, bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return bwd_dq<decltype(d)::value>(
                          q, k, v, b, dout, l, d_, qs, ks, dq, B, N, H, ldq,
                          ldk, ldv, lddq, q_scale, k_scale, bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}
