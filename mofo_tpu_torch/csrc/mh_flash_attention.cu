// Masked multihead flash attention for Hopper (sm_90a): separate q, k, v
// with an optional per-kv-position additive bias row. Forward, the
// backward's prep pass and the two halves of the backward. Plain C
// interface, loaded from Python with ctypes
// (mofo_tpu_torch/ops/flash_attention.py); built by
// mofo_tpu_torch/ops/_build.py together with the other csrc/*.cu sources.
// The bf16 kernels are built from wgmma_tiles.cuh (TMA, mbarriers, wgmma);
// the backward at head dim 64 and the prep pass are wgmma_attn_bwd.cuh's,
// shared with K2 and K4. The f32 tile loads, products and reductions are
// flash_tiles.cuh's, which hm_flash_attention.cu (K4) shares.
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
// can be column views of a fused (B, N, 2A) kv projection (A = H * D). The
// bias is a (B, N) f32 row (0 or -1e30), shared by every head and query, or
// absent (null). The forward writes out (B, N, A) and a compact (B, H, N) f32
// row log-sum-exp; the backward takes delta = rowsum(dO * O) per head,
// (B, H, N) f32 (in bf16 from the prep pass, with q * q_scale (B, N, A)),
// writes dK and dV at their own row stride (one (B, N, 2A) dkv in the port)
// and dQ (B, N, A).
//
// What bounds it on this card. At the ViT-B MCA geometry (N = 1568, H = 3,
// D = 256) attention does the same N^2 * A work as one backbone block's
// attention (A = 768) on N * A bytes per operand: it is bound by operations
// (the bf16 tensor-core rate), about 190 FLOP per byte moved; the prep pass
// (3 reads, 1 write of N A values) by bytes.
//
// What the design does about it. D = 256 is the hard part: a 64 x 256 f32
// output accumulator is 128 registers a thread of a warpgroup, and a 64-row
// operand strip is 32 KB of shared memory.
//   - The bf16 forward (D = 64 is the same template) runs two consumer
//     warpgroups of 64 query rows each (232 registers: 128 of output, 32 of
//     a 64 x 64 score tile, 16 of P) and a producer warpgroup (40) whose
//     first warp keeps a ring of (K, V) stages full by TMA, so tile j + 1 is
//     in flight while tile j is multiplied. q's fragments would be 64
//     registers more, so each q strip stays in shared memory, where its
//     warpgroup folds scale * log2 e into it once, and S = Q K^T is
//     wgmma.mma_async m64n64k16 with both operands from 128-byte-swizzled
//     shared memory, 16 k-steps over four 64-column boxes; P goes from the
//     accumulators into P.V, four m64n64k16 chains (one per 64 output
//     columns) on the MN-major V boxes. The tensor maps keep q's, k's and
//     v's row strides, so k and v stay column views of the fused (B, N, 2A)
//     kv projection, head h's boxes at column h D + 64 j; rows past N arrive
//     as zeros. The producer warp's lanes copy the 64 bias values of each
//     tile into the stage (-inf past N). Shared memory bounds the ring at
//     D = 256: two q strips (64 KB) and two stages of K and V (128 KB) fit a
//     block's 227 KB, a third stage does not; D = 64 takes four stages. One
//     block an SM: 13 x 30 blocks at the MCA are three waves on 132 SMs.
//   - The bf16 backward runs after a prep pass (mh_attn_bwd_prep) that reads
//     q, O and dO once and writes delta and q * q_scale, so no torch
//     reduction runs on the card and neither kernel reads O or rescales a q
//     tile. It is two kernels (dK/dV over kv tiles, dQ over q tiles), so
//     each output has exactly one writer: no atomics, deterministic sums.
//     At D = 64 they are wgmma_attn_bwd.cuh's, with the bias flag. At
//     D = 256 one warpgroup has registers for one 64 x 256 accumulator and
//     a block has shared memory for six strips (192 KB): a resident pair and
//     a 2-stage ring of streamed pairs, both operands of S and dP read from
//     shared memory. dK/dV holds a K and a V strip and streams (q * scale,
//     dO); its two consumer warpgroups split the outputs, not the rows:
//     one forms S^T = K Q^T and dV += P^T dO, the other S^T again,
//     dP^T = V dO^T and dK += dS^T Q (5 products against the floor's 4, no
//     hand-over of P^T between warpgroups). dQ holds a q * scale and a dO
//     strip (64 query rows) and streams (K, V); its warpgroups split the kv
//     tiles, each on its own stage, and their two partial sums are added in
//     a fixed order through shared memory at the end. A k scale that is a
//     power of two (1/16 at D = 256) scales dQ's f32 accumulator at the
//     store; any other is folded into the K strip in place between S and
//     dS K (there is no room for a strip of the prep pass's k * scale).
//   - The f32 kernels (the parity path) use FMAs, since tensor cores would
//     round f32 to TF32; at D = 256 their tiles shrink to 32 rows so that a
//     padded tile (32 x 257 f32, 33 KB) leaves room for the rest. All tiles
//     above 48 KB are dynamic shared memory.
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

#include "flash_tiles.cuh"
#include "wgmma_attn_bwd.cuh"
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
// bf16 forward, redesigned for Hopper (wgmma_tiles.cuh). A 64-row strip of
// D columns is D / 64 swizzled 64 x 64 boxes, one after the other.
// -------------------------------------------------------------------------

template <int D>
struct FwdShape {
  static constexpr int kBoxes = D / 64;
  // D = 256: two q strips (64 KB) and two stages of a K and a V strip
  // (128 KB) fit the 227 KB a block can use; a third stage does not
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kStrip = kBoxes * kTileElems;  // elements
  static constexpr size_t kSmem =
      1024 + (size_t)(kWG + 2 * kStages) * kStrip * sizeof(bf16) +
      kStages * kTileRows * sizeof(float) +
      (2 * kStages + 1) * sizeof(uint64_t);
};

// Grid (ceil(N / (64 kWG)), B * H). One block: 64 kWG query rows of one head
// against all N keys, streamed in 64-row (K, V) tiles with an online softmax
// (base 2). Each consumer warpgroup owns a 64-row q strip, which stays in
// shared memory (its fragments would take D / 4 registers a thread beside
// the D / 2 of the output): the warpgroup folds the scale into it in place,
// once, and S = Q K^T reads it as wgmma's A operand. P goes from the
// accumulators into P.V, one m64n64k16 chain per 64 output columns. The
// producer warp's lanes copy each tile's 64 bias values into the stage
// (-inf past N), lane 0 issues the TMA loads.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    mh_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ bias, bf16* __restrict__ out,
                float* __restrict__ lse, int N, int H, float q_scale) {
  using Shape = FwdShape<D>;
  constexpr int NB = Shape::kBoxes, kStages = Shape::kStages,
                kStrip = Shape::kStrip;
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sKV = sQ + kWG * kStrip;  // per stage: a K strip, a V strip
  float* sBias = reinterpret_cast<float*>(sKV + 2 * kStages * kStrip);
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kStages * kTileRows);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the bias' lanes
      mbar_init(&empty[s], 4 * kWG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG) {
      if (lane == 0) {
        mbar_expect_tx(qbar, kWG * NB * kTileBytes);
        for (int w = 0; w < kWG; ++w)
          for (int jb = 0; jb < NB; ++jb)
            tma_tile(sQ + w * kStrip + jb * kTileElems, &tq, qbar,
                     h * D + 64 * jb, q0 + kTileRows * w, b);
      }
      const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
      for (int j = 0; j < T; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          bf16* stage = sKV + s * 2 * kStrip;
          mbar_expect_tx(&full[s], 2 * NB * kTileBytes);
          for (int jb = 0; jb < NB; ++jb) {
            tma_tile(stage + jb * kTileElems, &tk, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
            tma_tile(stage + kStrip + jb * kTileElems, &tv, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
          }
        }
        float* sb = sBias + s * kTileRows;
        for (int r = lane; r < kTileRows; r += 32) {
          const int col = j * kTileRows + r;  // -inf masks columns >= N
          sb[r] = col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    bf16* strip = sQ + wg * kStrip;
    mbar_wait(qbar, 0);
    // q * q_scale rounded to bf16, in place (elementwise, so the swizzle
    // does not matter), then visible to wgmma's reads
    for (int i = threadIdx.x & (kWarpgroup - 1); i < kStrip / 8;
         i += kWarpgroup) {
      uint4 v = reinterpret_cast<uint4*>(strip)[i];
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x[e]);
        x[e] = __floats2bfloat162_rn(f.x * q_scale, f.y * q_scale);
      }
      reinterpret_cast<uint4*>(strip)[i] = v;
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);

    float o[NB][8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < T; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const bf16* k_strip = sKV + s * 2 * kStrip;
      const bf16* v_strip = k_strip + kStrip;
      float sc[8][4] = {};
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
        wgmma_tile_ss<0>(sc, strip + jb * kTileElems,
                         k_strip + jb * kTileElems);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      const float* sb = sBias + s * kTileRows;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] += (e & 1) ? b2.y : b2.x;  // after the scale fold
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds a column < N, so the max is finite
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
      for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[jb][nt][e] *= corr[e >> 1];
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
        wgmma_tile<1>(o[jb], pa, v_strip + jb * kTileElems);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) fence_acc(o[jb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + kTileRows * wg + r0 + g + 8 * half;
      if (row >= N) continue;
      bf16* dst = out + ((size_t)b * N + row) * A + h * D + 2 * t;
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * jb + 8 * nt) =
              __floats2bfloat162_rn(o[jb][nt][2 * half] / l[half],
                                    o[jb][nt][2 * half + 1] / l[half]);
      // LSE in log2 units: the scores carry log2(e)
      if (t == 0) lse[(size_t)bh * N + row] = m[half] + log2f(l[half]);
    }
  }
}

// -------------------------------------------------------------------------
// bf16 backward at D = 256, redesigned for Hopper (D = 64 runs
// wgmma_attn_bwd.cuh's kernels with the bias flag). A 64 x 256 f32
// accumulator is 128 registers a thread of a warpgroup, so a consumer
// warpgroup holds one output strip and nothing else of that size; every
// 64-row operand strip (four swizzled 64 x 64 boxes, 32 KB) stays in shared
// memory and both operands of S and dP come from there.
// -------------------------------------------------------------------------

template <int D>
struct BwdShape {
  static constexpr int kBoxes = D / 64;
  static constexpr int kStrip = kBoxes * kTileElems;  // elements
  static constexpr int kStages = 2;
  // dK/dV: a K and a V strip, kStages x (q * scale, dO) strips with their
  // LSE and delta. dQ: a q * scale and a dO strip, kStages x (K, V) strips
  // with their bias. 192 KB of strips at D = 256, of the 227 KB of a block.
  static constexpr size_t kStrips =
      (size_t)(2 + 2 * kStages) * kStrip * sizeof(bf16);
  static constexpr size_t kSmemDkv =
      1024 + kStrips + kStages * 2 * kTileRows * sizeof(float) +
      (2 * kStages + 1) * sizeof(uint64_t);
  static constexpr size_t kSmemDq =
      1024 + kStrips + kStages * kTileRows * sizeof(float) +
      (2 * kStages + 1) * sizeof(uint64_t);
};

// c (64 x 64) += A . B^T over the D columns of two strips, both read from
// shared memory: one m64n64k16 chain of D / 16 steps.
template <int NB>
__device__ __forceinline__ void strip_product(float (&c)[8][4],
                                              const bf16* a_strip,
                                              const bf16* b_strip) {
#pragma unroll
  for (int jb = 0; jb < NB; ++jb)
    wgmma_tile_ss<0>(c, a_strip + jb * kTileElems, b_strip + jb * kTileElems);
}

// acc (64 x D, one 64 x 64 accumulator per box) += a (64 x 64 from
// registers) . strip, whose 64 rows are the contraction.
template <int NB>
__device__ __forceinline__ void strip_accumulate(float (&acc)[NB][8][4],
                                                 const uint32_t (&a)[4][4],
                                                 const bf16* strip) {
#pragma unroll
  for (int jb = 0; jb < NB; ++jb)
    wgmma_tile<1>(acc[jb], a, strip + jb * kTileElems);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int jb = 0; jb < NB; ++jb) fence_acc(acc[jb]);
}

// Grid (ceil(N / 64), B * H). One block: 64 key/value rows of one head (a K
// and a V strip in shared memory); streams (q * scale, dO) strips with their
// LSE and delta through a 2-stage TMA ring. The two consumer warpgroups
// split the outputs, not the rows: warpgroup 0 forms S^T = K Q^T and
// dV += P^T dO, warpgroup 1 forms S^T again, dP^T = V dO^T and
// dK += dS^T Q: one writer per output, no atomics, and no hand-over of P^T
// between warpgroups, for one repeated S^T (5 products against the floor's
// 4). P^T and dS^T go from the accumulators into the last products.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    mh_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tqs,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int lddkv, int N, int H,
                    float dk_fix) {
  using Shape = BwdShape<D>;
  constexpr int NB = Shape::kBoxes, kStages = Shape::kStages,
                kStrip = Shape::kStrip;
  static_assert(kWG == 2, "one warpgroup per output");
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sK = reinterpret_cast<bf16*>(sm);
  bf16* sV = sK + kStrip;
  bf16* sQdO = sV + kStrip;  // per stage: a q * scale strip, a dO strip
  float* sStat = reinterpret_cast<float*>(sQdO + 2 * kStages * kStrip);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sStat + 2 * kStages * kTileRows);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        mbar_expect_tx(kvbar, 2 * NB * kTileBytes);
        for (int jb = 0; jb < NB; ++jb) {
          tma_tile(sK + jb * kTileElems, &tk, kvbar, h * D + 64 * jb, k0, b);
          tma_tile(sV + jb * kTileElems, &tv, kvbar, h * D + 64 * jb, k0, b);
        }
      }
      const float* lse_bh = lse + (size_t)bh * N;
      const float* delta_bh = delta + (size_t)bh * N;
      for (int j = 0; j < T; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          bf16* stage = sQdO + s * 2 * kStrip;
          mbar_expect_tx(&full[s], 2 * NB * kTileBytes);
          for (int jb = 0; jb < NB; ++jb) {
            tma_tile(stage + jb * kTileElems, &tqs, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
            tma_tile(stage + kStrip + jb * kTileElems, &tdo, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
          }
        }
        float* st = sStat + s * 2 * kTileRows;
        for (int r = lane; r < kTileRows; r += 32) {
          const int row = j * kTileRows + r;  // rows >= N: P = 0, dS = 0
          st[r] = row < N ? lse_bh[row] : INFINITY;
          st[kTileRows + r] = row < N ? delta_bh[row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    float bias_r[2] = {0.f, 0.f};  // of this thread's two kv rows
    if (bias) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // rows >= N are never stored: any finite bias will do
        const int row = k0 + r0 + g + 8 * half;
        if (row < N) bias_r[half] = bias[(size_t)b * N + row];
      }
    }
    mbar_wait(kvbar, 0);
    float acc[NB][8][4] = {};  // warpgroup 0: dV, warpgroup 1: dK

    for (int j = 0; j < T; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const bf16* q_strip = sQdO + s * 2 * kStrip;
      const bf16* do_strip = q_strip + kStrip;
      const float* sl = sStat + s * 2 * kTileRows;
      float st[8][4] = {};
      strip_product<NB>(st, sK, q_strip);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      uint32_t pa[4][4];  // P^T rounded to bf16, then (warpgroup 1) dS^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // the q row within the tile; +inf LSE past N
        const float2 l2 =
            *reinterpret_cast<const float2*>(sl + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float s0 = st[nt][e] + bias_r[e >> 1];  // after the fold
          const float s1 = st[nt][e + 1] + bias_r[e >> 1];
          pa[nt >> 1][2 * (nt & 1) + (e >> 1)] =
              bf16x2(exp2f(s0 - l2.x), exp2f(s1 - l2.y));
        }
      }
      if (wg == 0) {
        strip_accumulate<NB>(acc, pa, do_strip);  // dV += P^T dO
      } else {
        float dpt[8][4] = {};
        strip_product<NB>(dpt, sV, do_strip);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dpt);
        const float* sd = sl + kTileRows;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(sd + 8 * nt + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            uint32_t& w = pa[nt >> 1][2 * (nt & 1) + (e >> 1)];
            const uint32_t dd =
                bf16x2(dpt[nt][e] - d2.x, dpt[nt][e + 1] - d2.y);
            w = bf16x2(bf16_lo(w) * bf16_lo(dd), bf16_hi(w) * bf16_hi(dd));
          }
        }
        strip_accumulate<NB>(acc, pa, q_strip);  // dK += dS^T Q
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    bf16* dst = (wg == 0 ? dv : dk) + (size_t)b * N * lddkv + h * D;
    const float mul = wg == 0 ? 1.f : dk_fix;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
      store_acc(dst + 64 * jb, lddkv, acc[jb], k0 + r0, N, mul);
  }
}

// Grid (ceil(N / 64), B * H). One block: 64 query rows of one head (a
// q * scale and a dO strip in shared memory); streams (K, V) strips with
// their 64 bias values (-inf past N) through a 2-stage TMA ring. Shared
// memory has room for one block of 64 query rows only, so the two consumer
// warpgroups split the kv tiles, not the rows: warpgroup w takes tiles w,
// w + 2, ... from stage w and accumulates its own dQ = dS K; at the end
// warpgroup 1 hands its sum over through its (idle) stage and warpgroup 0
// adds and stores, in that fixed order. acc_mul = k_scale (a power of two)
// scales the sum at the store; with kRescaleK (any other scale) the
// warpgroup multiplies its K strip by k_scale in place, rounded to bf16,
// between S and dS K, and acc_mul = 1.
template <int D, bool kRescaleK>
__global__ void __launch_bounds__(kHopperThreads, 1)
    mh_bwd_dq_bf16(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tqs,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int N, int H, float k_scale) {
  using Shape = BwdShape<D>;
  constexpr int NB = Shape::kBoxes, kStages = Shape::kStages,
                kStrip = Shape::kStrip;
  static_assert(kStages == kWG, "one stage per consumer warpgroup");
  static_assert(2 * kStrip * sizeof(bf16) ==
                    (size_t)NB * 32 * kWarpgroup * sizeof(float),
                "a stage holds one warpgroup's accumulators");
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sdO = sQ + kStrip;
  bf16* sKV = sdO + kStrip;  // per stage: a K strip, a V strip
  float* sBias = reinterpret_cast<float*>(sKV + 2 * kStages * kStrip);
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kStages * kTileRows);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, A = H * D;
  const int q0 = blockIdx.x * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the bias' lanes
      mbar_init(&empty[s], 4);      // the warps of the stage's warpgroup
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * NB * kTileBytes);
        for (int jb = 0; jb < NB; ++jb) {
          tma_tile(sQ + jb * kTileElems, &tqs, qbar, h * D + 64 * jb, q0, b);
          tma_tile(sdO + jb * kTileElems, &tdo, qbar, h * D + 64 * jb, q0,
                   b);
        }
      }
      const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
      for (int j = 0; j < T; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          bf16* stage = sKV + s * 2 * kStrip;
          mbar_expect_tx(&full[s], 2 * NB * kTileBytes);
          for (int jb = 0; jb < NB; ++jb) {
            tma_tile(stage + jb * kTileElems, &tk, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
            tma_tile(stage + kStrip + jb * kTileElems, &tv, &full[s],
                     h * D + 64 * jb, j * kTileRows, b);
          }
        }
        float* sb = sBias + s * kTileRows;
        for (int r = lane; r < kTileRows; r += 32) {
          const int col = j * kTileRows + r;  // -inf masks columns >= N
          sb[r] = col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x & (kWarpgroup - 1);
    float lse_r[2], delta_r[2];  // rows >= N: P = 0, dS = 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + g + 8 * half;
      lse_r[half] = row < N ? lse[(size_t)bh * N + row] : INFINITY;
      delta_r[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
    }
    mbar_wait(qbar, 0);
    bf16* k_strip = sKV + wg * 2 * kStrip;  // this warpgroup's stage
    const bf16* v_strip = k_strip + kStrip;
    const float* sb = sBias + wg * kTileRows;
    float acc[NB][8][4] = {};

    for (int j = wg, it = 0; j < T; j += kWG, ++it) {
      mbar_wait(&full[wg], it & 1);
      float sc[8][4] = {};
      strip_product<NB>(sc, sQ, k_strip);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      uint32_t pa[4][4];  // P rounded to bf16, then dS
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float s0 = sc[nt][e] + b2.x;  // after the scale fold
          const float s1 = sc[nt][e + 1] + b2.y;
          pa[nt >> 1][2 * (nt & 1) + (e >> 1)] = bf16x2(
              exp2f(s0 - lse_r[e >> 1]), exp2f(s1 - lse_r[e >> 1]));
        }
      }
      if (kRescaleK) {
        // every warp's S has read the strip; scale it in place (elementwise,
        // so the swizzle does not matter), then make it visible to wgmma
        warpgroup_sync(1 + wg);
        for (int i = tid; i < kStrip / 8; i += kWarpgroup) {
          uint4 v = reinterpret_cast<uint4*>(k_strip)[i];
          __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(x[e]);
            x[e] = __floats2bfloat162_rn(f.x * k_scale, f.y * k_scale);
          }
          reinterpret_cast<uint4*>(k_strip)[i] = v;
        }
        fence_proxy_async();
        warpgroup_sync(1 + wg);
      }
      float dp[8][4] = {};
      strip_product<NB>(dp, sdO, v_strip);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          uint32_t& w = pa[nt >> 1][2 * (nt & 1) + (e >> 1)];
          const uint32_t dd = bf16x2(dp[nt][e] - delta_r[e >> 1],
                                     dp[nt][e + 1] - delta_r[e >> 1]);
          w = bf16x2(bf16_lo(w) * bf16_lo(dd), bf16_hi(w) * bf16_hi(dd));
        }
      strip_accumulate<NB>(acc, pa, k_strip);  // dQ += dS K
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[wg]);
    }

    // warpgroup 1's stage is idle now (its loads are consumed): thread i of
    // warpgroup 1 leaves its accumulators there for thread i of warpgroup 0
    float* hand = reinterpret_cast<float*>(sKV + 2 * kStrip);
    if (wg == 1) {
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hand[((jb * 8 + nt) * 4 + e) * kWarpgroup + tid] = acc[jb][nt][e];
    }
    asm volatile("bar.sync 3, %0;\n" ::"n"(kWG * kWarpgroup) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[jb][nt][e] += hand[((jb * 8 + nt) * 4 + e) * kWarpgroup + tid];
        store_acc(dq + (size_t)b * N * A + h * D + 64 * jb, A, acc[jb],
                  q0 + r0, N, kRescaleK ? 1.f : k_scale);
      }
    }
  }
}

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

bool bad(int B, int N, int H, int D, int ldq, int ldk, int ldv) {
  const int A = H * D;
  return (D != 64 && D != 256) || B < 1 || N < 1 || H < 1 ||
         B * H > 65535 || ldq < A || ldk < A || ldv < A;
}

// Tiles of the f32 FMA kernels: 64 x 64 at D = 64 and 32 x 32 at D = 256.
template <int D>
constexpr int stream_rows() { return D == 64 ? 64 : 32; }

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int N, int H, int ldq, int ldk,
        int ldv, float q_scale, int bf16_, cudaStream_t st) {
  if (bf16_) {
    // q, k and v keep their row strides: k and v may be column views of a
    // fused (B, N, 2A) kv projection
    const int A = H * D;
    CUtensorMap tq, tk, tv;
    if (int e = tile_map(&tq, q, A, N, B, ldq, (long)N * ldq)) return e;
    if (int e = tile_map(&tk, k, A, N, B, ldk, (long)N * ldk)) return e;
    if (int e = tile_map(&tv, v, A, N, B, ldv, (long)N * ldv)) return e;
    constexpr size_t smem = FwdShape<D>::kSmem;
    auto kernel = mh_fwd_bf16<D>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, kWG * kTileRows), B * H), kHopperThreads, smem,
             st>>>(tq, tk, tv, bias, static_cast<bf16*>(out), lse, N, H,
                   q_scale);
  } else {
    constexpr int T = stream_rows<D>();
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

// The tensor maps of the bf16 backward: k and v on their own row strides
// (column views of a fused kv, or tensors of their own), the prep pass's
// q * q_scale and dO as contiguous (B, N, A).
int bwd_maps(CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tqs,
             CUtensorMap* tdo, const void* k, const void* v, const void* qs,
             const void* dout, int B, int N, int A, int ldk, int ldv) {
  if (int e = tile_map(tk, k, A, N, B, ldk, (long)N * ldk)) return e;
  if (int e = tile_map(tv, v, A, N, B, ldv, (long)N * ldv)) return e;
  if (int e = tile_map(tqs, qs, A, N, B, A, (long)N * A)) return e;
  return tile_map(tdo, dout, A, N, B, A, (long)N * A);
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta,
            const void* qs, void* dk, void* dv, int B, int N, int H, int ldq,
            int ldk, int ldv, int lddkv, float q_scale, float dk_fix,
            int bf16_, cudaStream_t st) {
  if (bf16_) {
    if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
    CUtensorMap tk, tv, tqs, tdo;
    if (int e = bwd_maps(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N, H * D,
                         ldk, ldv))
      return e;
    if constexpr (D == 64) {
      if (int e = launch_bwd_dkv<false, true>(tk, tv, tqs, tdo, 0, 0, lse,
                                              delta, bias, dk, dv, lddkv, B,
                                              N, H, dk_fix, st))
        return e;
    } else {
      constexpr size_t smem = BwdShape<D>::kSmemDkv;
      auto kernel = mh_bwd_dkv_bf16<D>;
      if (int e = max_smem((const void*)kernel, smem)) return e;
      kernel<<<dim3(cdiv(N, kTileRows), B * H), kHopperThreads, smem, st>>>(
          tk, tv, tqs, tdo, bias, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), lddkv, N, H, dk_fix);
    }
  } else {
    // f32 works in base e: dK needs no 1/log2(e) fix
    constexpr int T = stream_rows<D>();
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

template <int D, bool kRescaleK>
int launch_dq_d256(const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tqs, const CUtensorMap& tdo,
                   const float* bias, const float* lse, const float* delta,
                   void* dq, int B, int N, int H, float k_scale,
                   cudaStream_t st) {
  constexpr size_t smem = BwdShape<D>::kSmemDq;
  auto kernel = mh_bwd_dq_bf16<D, kRescaleK>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3(cdiv(N, kTileRows), B * H), kHopperThreads, smem, st>>>(
      tk, tv, tqs, tdo, bias, lse, delta, static_cast<bf16*>(dq), N, H,
      k_scale);
  return 0;
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* delta,
           const void* qs, const void* ks, void* dq, int B, int N, int H,
           int ldq, int ldk, int ldv, float q_scale, float k_scale, int bf16_,
           cudaStream_t st) {
  if (bf16_) {
    if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
    const int A = H * D;
    CUtensorMap tk, tv, tqs, tdo, tks;
    if (int e = bwd_maps(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N, A, ldk,
                         ldv))
      return e;
    if constexpr (D == 64) {
      if (ks)
        if (int e = tile_map(&tks, ks, A, N, B, A, (long)N * A)) return e;
      if (int e = launch_bwd_dq<false, true>(tk, tv, tqs, tdo,
                                             ks ? &tks : nullptr, 0, 0, lse,
                                             delta, bias, dq, A, B, N, H,
                                             k_scale, st))
        return e;
    } else {
      // no room for a third strip a stage: a scale that is not a power of
      // two is folded into the K strip in place, ks is not read
      if (int e = power_of_two(k_scale)
                      ? launch_dq_d256<D, false>(tk, tv, tqs, tdo, bias, lse,
                                                 delta, dq, B, N, H, k_scale,
                                                 st)
                      : launch_dq_d256<D, true>(tk, tv, tqs, tdo, bias, lse,
                                                delta, dq, B, N, H, k_scale,
                                                st))
        return e;
    }
  } else {
    constexpr int T = stream_rows<D>();
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

// The bf16 backward's prep pass: delta (B, H, N) f32 and q * q_scale
// (B, N, A) bf16 from q (row stride ldq), out and dout, and k * k_scale
// (k at row stride ldk) into ks unless ks is null.
extern "C" int mh_attn_bwd_prep(const void* q, const void* k,
                                const void* out, const void* dout,
                                void* delta, void* qs, void* ks, int B, int N,
                                int H, int D, int ldq, int ldk, float q_scale,
                                float k_scale, void* stream) {
  if (bad(B, N, H, D, ldq, ldk, ldk)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  if (int e = D == 64 ? launch_bwd_prep<8>(q, k, ldq, ldk, out, dout, delta,
                                           qs, ks, B, N, H, q_scale, k_scale,
                                           st)
                      : launch_bwd_prep<32>(q, k, ldq, ldk, out, dout, delta,
                                            qs, ks, B, N, H, q_scale, k_scale,
                                            st))
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
  if (bad(B, N, H, D, ldq, ldk, ldv) || lddkv < H * D) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  return D == 64
             ? bwd_dkv<64>(q, k, v, b, dout, l, d, qs, dk, dv, B, N, H, ldq,
                           ldk, ldv, lddkv, q_scale, dk_fix, bf16, st)
             : bwd_dkv<256>(q, k, v, b, dout, l, d, qs, dk, dv, B, N, H, ldq,
                            ldk, ldv, lddkv, q_scale, dk_fix, bf16, st);
}

// bf16: delta, qs and (at D = 64, unless k_scale is a power of two) ks come
// from mh_attn_bwd_prep; f32: qs and ks are null.
extern "C" int mh_attn_bwd_dq(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* delta,
                              const void* qs, const void* ks, void* dq, int B,
                              int N, int H, int D, int ldq, int ldk, int ldv,
                              float q_scale, float k_scale, int bf16,
                              void* stream) {
  if (bad(B, N, H, D, ldq, ldk, ldv)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  auto l = static_cast<const float*>(lse);
  auto d = static_cast<const float*>(delta);
  return D == 64 ? bwd_dq<64>(q, k, v, b, dout, l, d, qs, ks, dq, B, N, H,
                              ldq, ldk, ldv, q_scale, k_scale, bf16, st)
                 : bwd_dq<256>(q, k, v, b, dout, l, d, qs, ks, dq, B, N, H,
                               ldq, ldk, ldv, q_scale, k_scale, bf16, st);
}
