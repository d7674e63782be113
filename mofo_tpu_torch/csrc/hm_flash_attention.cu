// Head-major single-head flash attention for Hopper (sm_90a): forward and the
// two halves of the backward on (B*H, N, D) q, k and v. Plain C interface,
// loaded from Python with ctypes (mofo_tpu_torch/ops/flash_attention.py);
// built by mofo_tpu_torch/ops/_build.py with the other csrc/*.cu sources.
// The f32 backward's tile loads, products and reductions up to D = 256 are
// flash_tiles.cuh's, the f32 forward's kernels wgmma_tf32_fwd.cuh's and
// wgmma_tf32_split.cuh's, the TMA, mbarrier and wgmma pieces of the bf16
// forward wgmma_tiles.cuh's, and the bf16 backward's kernels
// wgmma_attn_bwd.cuh's.
//
// Replaces the TPU kernel K4 of mofo_tpu/ops/flash_attention.py:
//   hm_attn_fwd      <- _fwd_impl (:262) / _fwd_kernel (:130)
//   hm_attn_bwd_prep <- _bwd_impl's delta, computed in XLA (:313-315), and
//                       the kernels' in-kernel scale folds (bf16 only)
//   hm_attn_bwd_dq   <- _bwd_impl (:304) / _dq_kernel (:160)
//   hm_attn_bwd_dkv  <- _bwd_impl (:304) / _dkv_kernel (:204)
//
// Layout. q, k, v, out, dout, dq, dk and dv are (BH, N, D) contiguous with
// D one of the built head dims 16, 32, 64, 128, 192 and 256
// (wgmma_tiles.cuh's by_head_dim) or, above 256, any multiple of 64 (the
// column-split kernels of wgmma_attn_split.cuh and wgmma_tf32_split.cuh,
// D at run time); the wrapper pads any other D with zero columns: 64 for
// the ViT-S pretrain decoder's 3 x 64 heads,
// which take the head-major route of models/layers.Attention because
// A = 192 is not a multiple of 128, 32 and 16 for the tiny presets' encoder
// and decoder heads, the others for an attn_head_dim whose A is not a
// multiple of 128 (48 pads to 64). Every kernel and its shared memory take
// D as a template parameter; the entry points dispatch on it. The forward
// writes a (BH, N) f32 LSE in natural-log units;
// the backward takes delta = rowsum(dO * O), (BH, N) f32, from the caller:
// in bf16 from the prep pass, which also writes q * scale (BH, N, D) once
// for both backward kernels.
//
// What bounds it on this card. At the ViT-S decoder (BH = 96, N = 1568) each
// head does N^2 D multiply-adds per product on 2 N D bytes per operand: the
// kernels are bound by operations (the bf16 tensor-core rate), not bytes; the
// prep pass (3 reads, 1 write of N D values) is bound by bytes.
//
// What the design does about it. Every product of the bf16 kernels runs on
// the tensor cores, bf16 in, f32 accumulate. The TPU rounds the normalized
// p / l before P.V, which an online softmax cannot do (it rounds
// exp(s - m_running)): so the forward makes two passes over kv, the first
// for the row max and sum, the second for P = exp(s - m) / l and P.V, one
// product more than an online softmax (3 products are the floor).
//   - The bf16 forward (redesigned for Hopper, wgmma_tiles.cuh) runs two
//     consumer warpgroups of 64 query rows each and a producer warpgroup
//     whose first warp keeps a ring of 3 shared-memory stages full by TMA
//     (its registers go to the consumers by setmaxnreg) (K alone in pass
//     1, K and V in pass 2), so tile j + 1 is in flight while tile j is
//     multiplied. Every product is one wgmma.mma_async chain (m64n64 for
//     S, m64nD for P.V, D / 16 k-steps in S): q's fragments (times the
//     scale) stay in registers across both passes and P goes from registers
//     to P.V; K and V are read from swizzled shared memory (128-, 64- or
//     32-byte swizzle: a row is 2 D bytes, two 64-column boxes at D = 128),
//     V MN-major. At D = 16, 32 and 128 the tiles are narrower or wider and
//     the kernels are the same; they are right first and not tuned. At
//     D = 192 and 256 q's fragments and a 64 x D output do not fit beside
//     each other in a thread's registers: there the forward is
//     hm_fwd_wide_bf16, the same two passes on wgmma_attn_wide.cuh's strips
//     (q stays in shared memory, scaled in place; the producer's lanes stage
//     -inf past N for the ragged tile). The exponentials are ex2 of
//     log2(e)-scaled
//     f32 differences and pass 2 multiplies by 1/l: an ulp or two of the
//     f32 value before the bf16 rounding. The LSE stays in natural-log
//     units. The 3D tensor maps (BH, N, D) zero-fill rows past N per head.
//   - The bf16 backward (redesigned for Hopper) is the design of the
//     fused-qkv backward, whose kernels it shares (wgmma_attn_bwd.cuh) with
//     the softmax base and the layout as parameters: a prep pass over q, O
//     and dO writes delta and q * scale, so that no torch reduction runs on
//     the card and neither kernel reads O or rescales a tile; dK/dV (two
//     consumer warpgroups of 64 kv rows each, K fragments in registers, V
//     the A operand from shared memory) streams (q * scale, dO) tiles with
//     their LSE and delta through a 2-stage TMA ring and forms S^T = K Q^T
//     and dP^T = V dO^T, so P^T and dS^T go from the accumulators into
//     dV += P^T dO and dK += dS^T Q; dQ (128 q rows a block) streams (K, V)
//     tiles. Each output has one writer and no atomics. P is exp2 of the
//     log2(e)-scaled f32 difference to the natural-log LSE (scaled once
//     where it is staged). The scale 0.125 is a power of two, so dQ scales
//     its f32 accumulator at the store; another scale reads k * scale from
//     a copy the prep pass writes. At D = 192 and 256 the backward is
//     wgmma_attn_wide.cuh's strip kernels in base e, which fold another
//     scale into their K strip instead (the prep pass writes no copy).
//   - Above D = 256 every kernel is wgmma_attn_split.cuh's column-split
//     one in base e: D streamed through the score products, the output in
//     groups of 256 columns over the grid (the forward's two passes and the
//     backward's S and dP formed again by every group); dQ reads the prep
//     pass's k * scale copy unless the scale is a power of two.
//   - The f32 forward runs its products in 3xTF32 on wgmma (each operand
//     split into TF32 hi and lo parts, three products: as accurate as
//     f32), in two passes (p / l before P.V): up to D = 128 K1's and K3's
//     narrow kernel with its two-pass flag (wgmma_tf32_fwd.cuh; the
//     (BH, N, D) planes as BH planes of one head), at 192 and 256 and
//     above wgmma_tf32_split.cuh's column-split one (one output group of
//     3 or 4 chunks at 192 and 256: no recompute), shared with K3. The
//     f32 dK/dV and dQ up to D = 256 still use FMAs (flash_tiles.cuh; the
//     ROADMAP's f32 queue); above D = 128 their tiles shrink to 32 rows.
//     Above D = 256 they are wgmma_tf32_split.cuh's 3xTF32 column-split
//     kernels too.
// Ragged N is masked in-kernel: kv columns >= N and q rows >= N get P = 0;
// nothing is padded in HBM.
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

#include <type_traits>

#include "flash_tiles.cuh"
#include "wgmma_attn_bwd.cuh"
#include "wgmma_attn_split.cuh"
#include "wgmma_attn_wide.cuh"
#include "wgmma_tf32_fwd.cuh"
#include "wgmma_tf32_split.cuh"
#include "wgmma_tiles.cuh"

namespace {

// Rows of the f32 kernels' streamed tiles (and q tiles): 64 up to D = 128,
// 32 above (a padded 32 x 257 f32 tile is 33 KB).
template <int D>
constexpr int f32_rows() { return D <= 128 ? 64 : 32; }

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
// f32: FMA kernels of the backward up to D = 256 (flash_tiles.cuh's 16 x 16
// thread layout); the f32 forward is wgmma_tf32_fwd.cuh's and
// wgmma_tf32_split.cuh's (3xTF32, two passes)
// -------------------------------------------------------------------------

template <int BQ, int BK, int D>
constexpr size_t smem_dq_f32() {
  return ((size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + 2 * BQ) *
         sizeof(float);
}

// Grid (ceil(N / BQ), BH). One block: BQ query rows of one head; loops over
// all kv tiles and accumulates dQ = dS (K * scale) in registers.
template <int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads)
    hm_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int N, float q_scale, float k_scale) {
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

template <int BKV, int BQ, int D>
constexpr size_t smem_dkv_f32() {
  return ((size_t)(2 * BKV + 2 * BQ) * (D + 1) + 2 * BKV * (BQ + 1) +
          2 * BQ) * sizeof(float);
}

// Grid (ceil(N / BKV), BH). One block: BKV key/value rows of one head; loops
// over all q tiles and accumulates dK and dV in registers. It forms
// S^T = K Q^T and dP^T = V dO^T directly (rows kv, columns q), so P^T and
// dS^T are row-major A operands of dV += P^T dO and dK += dS^T Q.
template <int BKV, int BQ, int D>
__global__ void __launch_bounds__(kThreads)
    hm_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, float q_scale) {
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
// bf16: tensor-core kernels (wgmma; a warp's 16 accumulator rows are in
// mma.sync's m16n8 layout, see wgmma_tiles.cuh)
// -------------------------------------------------------------------------

// The redesigned bf16 forward: kWG consumer warpgroups, each the 64 query
// rows of one wgmma strip, then the producer warpgroup, whose first warp
// keeps a ring of kStages kv stages filled by TMA (K alone in pass 1, K and
// V in pass 2).
constexpr int kStages = 3;
template <int D>
constexpr size_t smem_fwd_bf16() {
  return 1024 + (size_t)(kWG + 2 * kStages) * tile_bytes<D>() +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// Grid (ceil(N / (64 kWG)), BH). One block: 64 kWG query rows of one head
// against all N keys, in two passes over 64-row kv tiles. Each consumer
// warpgroup keeps its q fragments (q times the scale, in bf16) in registers;
// warp w of it owns rows 16w..16w+15 of the strip, in mma.sync's accumulator
// layout. D up to 128 (wgmma_tiles.cuh's *_d helpers).
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    hm_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                bf16* __restrict__ out, float* __restrict__ lse, int N,
                float q_scale) {
  constexpr int kTE = tile_elems<D>(), kTB = tile_bytes<D>();
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sK = sQ + kWG * kTE;
  bf16* sV = sK + kStages * kTE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTE);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int bh = blockIdx.y, q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        tma_tile_d<D>(sQ + w * kTE, &tq, qbar, 0, q0 + kTileRows * w, bh);
      for (int it = 0; it < 2 * T; ++it) {
        const int s = it % kStages;
        const bool second = it >= T;
        const int k0 = (second ? it - T : it) * kTileRows;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], second ? 2 * kTB : kTB);
        tma_tile_d<D>(sK + s * kTE, &tk, &full[s], 0, k0, bh);
        if (second) tma_tile_d<D>(sV + s * kTE, &tv, &full[s], 0, k0, bh);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int t = lane & 3;
    mbar_wait(qbar, 0);
    uint32_t qa[D / 16][4];
    load_a_sw(qa, sQ + wg * kTE, r0, q_scale);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    int it = 0;
    for (int j = 0; j < T; ++j, ++it) {  // pass 1: row max and sum
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      float sc[8][4] = {};
      wgmma_tile_d<0, D>(sc, qa, sK + s * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if ((j + 1) * kTileRows > N) {  // the ragged last tile
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * kTileRows + 8 * nt + 2 * t + (e & 1) >= N)
              sc[nt][e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // finite: the tile holds a column < N
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        l[r] *= exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        ml[r] = m_new * kLog2e;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rs[e >> 1] += exp2f(fmaf(sc[nt][e], kLog2e, -ml[e >> 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] += quad_sum(rs[r]);
    }

    float ml[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ml[r] = m[r] * kLog2e, inv_l[r] = 1.f / l[r];
    float o[D / 8][4] = {};
    for (int j = 0; j < T; ++j, ++it) {  // pass 2: P = exp(s - m) / l, P.V
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      float sc[8][4] = {};
      wgmma_tile_d<0, D>(sc, qa, sK + s * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      const bool ragged = (j + 1) * kTileRows > N;
      uint32_t pa[4][4];  // p / l rounded to bf16: the A fragments of P.V
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int col = j * kTileRows + 8 * nt + 2 * t;
          const int r = e >> 1;
          float p0 = exp2f(fmaf(sc[nt][e], kLog2e, -ml[r])) * inv_l[r];
          float p1 = exp2f(fmaf(sc[nt][e + 1], kLog2e, -ml[r])) * inv_l[r];
          if (ragged) {
            p0 = col < N ? p0 : 0.f;
            p1 = col + 1 < N ? p1 : 0.f;
          }
          pa[nt >> 1][2 * (nt & 1) + (e >> 1)] = bf16x2(p0, p1);
        }
      wgmma_tile_d<1, D>(o, pa, sV + s * kTE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t base = (size_t)bh * N * D;
    const int row0 = q0 + kTileRows * wg + r0;
    store_acc(out + base, D, o, row0, N, 1.f);
    const int g = lane >> 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (t == 0 && row < N)
        lse[(size_t)bh * N + row] = m[half] + logf(l[half]);
    }
  }
}

// The forward at D = 192 and 256: hm_fwd_bf16's two passes on
// wgmma_attn_wide.cuh's strips. Grid (ceil(N / (64 kWG)), BH). Each consumer
// warpgroup owns a 64-row q strip in shared memory, which it scales in
// place once; S = Q K^T reads both operands from shared memory. The
// producer warp's lanes stage 0 or -inf (past N) for each kv tile beside it,
// which masks the ragged tile in both passes; lane 0 issues the loads (K
// alone in pass 1, K and V in pass 2).
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    hm_fwd_wide_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ out, float* __restrict__ lse, int N,
                     float q_scale) {
  using S = Strip<D>;
  constexpr int NB = S::kBoxes, NT = S::kNT, kStrip = S::kElems;
  constexpr int kSt = FwdShape<D>::kStages;
  extern __shared__ unsigned char wsmem[];
  unsigned char* sm = smem_1024(wsmem);
  bf16* sQ = reinterpret_cast<bf16*>(sm);
  bf16* sKV = sQ + kWG * kStrip;  // per stage: a K strip, a V strip
  float* sMask = reinterpret_cast<float*>(sKV + 2 * kSt * kStrip);
  uint64_t* full = reinterpret_cast<uint64_t*>(sMask + kSt * kTileRows);
  uint64_t* empty = full + kSt;
  uint64_t* qbar = empty + kSt;
  const int bh = blockIdx.y, q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and the mask's lanes
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
        mbar_expect_tx(qbar, kWG * S::kBytes);
        for (int w = 0; w < kWG; ++w)
          tma_tile_d<D>(sQ + w * kStrip, &tq, qbar, 0, q0 + kTileRows * w,
                        bh);
      }
      for (int it = 0; it < 2 * T; ++it) {
        const int s = it % kSt;
        const bool second = it >= T;
        const int j = second ? it - T : it;
        mbar_wait(&empty[s], ((it / kSt) & 1) ^ 1);
        if (lane == 0) {
          bf16* stage = sKV + s * 2 * kStrip;
          mbar_expect_tx(&full[s], (second ? 2 : 1) * S::kBytes);
          tma_tile_d<D>(stage, &tk, &full[s], 0, j * kTileRows, bh);
          if (second)
            tma_tile_d<D>(stage + kStrip, &tv, &full[s], 0, j * kTileRows,
                          bh);
        }
        stage_bias(sMask + s * kTileRows, nullptr, j, N, lane);
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    bf16* strip = sQ + wg * kStrip;
    mbar_wait(qbar, 0);
    strip_scale<D>(strip, q_scale, 1 + wg);  // q * scale, in bf16
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S of the tile in stage s, its columns past N at -inf
    auto scores = [&](float (&sc)[8][4], int s) {
      strip_product<D>(sc, strip, sKV + s * 2 * kStrip);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      const float* sb = sMask + s * kTileRows;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += (e & 1) ? b2.y : b2.x;
      }
    };

    int it = 0;
    for (int j = 0; j < T; ++j, ++it) {  // pass 1: row max and sum
      const int s = it % kSt;
      mbar_wait(&full[s], (it / kSt) & 1);
      float sc[8][4] = {};
      scores(sc, s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // finite: the tile holds a column < N
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        l[r] *= exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        ml[r] = m_new * kLog2e;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rs[e >> 1] += exp2f(fmaf(sc[nt][e], kLog2e, -ml[e >> 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] += quad_sum(rs[r]);
    }

    float ml[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ml[r] = m[r] * kLog2e, inv_l[r] = 1.f / l[r];
    float o[NB][NT][4] = {};
    for (int j = 0; j < T; ++j, ++it) {  // pass 2: P = exp(s - m) / l, P.V
      const int s = it % kSt;
      mbar_wait(&full[s], (it / kSt) & 1);
      float sc[8][4] = {};
      scores(sc, s);
      uint32_t pa[4][4];  // p / l rounded to bf16: the A fragments of P.V
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = e >> 1;
          pa[nt >> 1][2 * (nt & 1) + r] =
              bf16x2(exp2f(fmaf(sc[nt][e], kLog2e, -ml[r])) * inv_l[r],
                     exp2f(fmaf(sc[nt][e + 1], kLog2e, -ml[r])) * inv_l[r]);
        }
      strip_accumulate<D>(o, pa, sKV + s * 2 * kStrip + kStrip);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const size_t base = (size_t)bh * N * D;
    const int row0 = q0 + kTileRows * wg + r0;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
      store_acc(out + base + S::kBox * jb, D, o[jb], row0, N, 1.f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (t == 0 && row < N)
        lse[(size_t)bh * N + row] = m[half] + logf(l[half]);
    }
  }
}

// The bf16 backward is wgmma_attn_bwd.cuh's prep pass and dK/dV and dQ
// kernels (shared with qkv_flash_attention.cu) up to D = 128 and
// wgmma_attn_wide.cuh's strip kernels above, in base e on the head-major
// layout: every operand its own (BH, N, D) tensor map, one head a plane.
template <int D>
int hm_map(CUtensorMap* map, const void* base, int BH, int N) {
  return tile_map(map, base, D, N, BH, D, (long)N * D, box_cols<D>());
}

bool bad(int BH, int N) { return BH < 1 || BH > 65535 || N < 1; }

template <int D>
int run_fwd(const void* q, const void* k, const void* v, void* out, float* l,
            int BH, int N, float q_scale, int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    CUtensorMap tq, tk, tv;
    if (int e = hm_map<D>(&tq, q, BH, N)) return e;
    if (int e = hm_map<D>(&tk, k, BH, N)) return e;
    if (int e = hm_map<D>(&tv, v, BH, N)) return e;
    auto launch = [&](auto kernel, size_t smem) {
      if (int e = max_smem((const void*)kernel, smem)) return e;
      kernel<<<hopper_grid(1, N, BH), kHopperThreads, smem, st>>>(
          tq, tk, tv, static_cast<bf16*>(out), l, N, q_scale);
      return 0;
    };
    if constexpr (D > 128)
      return launch(hm_fwd_wide_bf16<D>, FwdShape<D>::kSmem);
    else
      return launch(hm_fwd_bf16<D>, smem_fwd_bf16<D>());
  } else if constexpr (D <= 128) {
    // 3xTF32 on wgmma in two passes (wgmma_tf32_fwd.cuh, K1's and K3's
    // kernel): the (BH, N, D) planes as BH planes of one head
    return launch_fwd_f32<D, false, true>(q, k, v, nullptr, out, l, BH, N, 1,
                                          D, D, D, q_scale, st);
  } else {
    // 192 and 256: the column-split kernel in two passes at one output
    // group (wgmma_tf32_split.cuh; NG 3 or 4 chunks, no recompute)
    return launch_split_fwd_tf32<true>(q, k, v, nullptr, out, l, BH, N, 1, D,
                                       D, D, D, q_scale, st);
  }
}

template <int D>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* l, const float* d, const void* qs, void* dk,
            void* dv, int BH, int N, float q_scale, int is_bf16,
            cudaStream_t st) {
  if (is_bf16) {
    if (!qs) return kBadArgument;
    CUtensorMap tk, tv, tqs, tdo;
    if (int e = hm_map<D>(&tk, k, BH, N)) return e;
    if (int e = hm_map<D>(&tv, v, BH, N)) return e;
    if (int e = hm_map<D>(&tqs, qs, BH, N)) return e;
    if (int e = hm_map<D>(&tdo, dout, BH, N)) return e;
    if constexpr (D <= 128)
      return launch_bwd_dkv<true, false, D>(tk, tv, tqs, tdo, 0, 0, l, d,
                                            nullptr, dk, dv, D, BH, N, 1, 1.f,
                                            st);
    else
      return launch_strip_dkv<D, true>(tk, tv, tqs, tdo, nullptr, l, d, dk,
                                       dv, D, BH, N, 1, 1.f, st);
  }
  constexpr int T = f32_rows<D>();
  constexpr size_t smem = smem_dkv_f32<T, T, D>();
  auto kernel = hm_bwd_dkv_f32<T, T, D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3(cdiv(N, T), BH), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
      static_cast<float*>(dk), static_cast<float*>(dv), N, q_scale);
  return 0;
}

template <int D>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* l, const float* d, const void* qs, const void* ks,
           void* dq_out, int BH, int N, float q_scale, float k_scale,
           int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    if (!qs) return kBadArgument;
    CUtensorMap tk, tv, tqs, tdo, tks;
    if (int e = hm_map<D>(&tk, k, BH, N)) return e;
    if (int e = hm_map<D>(&tv, v, BH, N)) return e;
    if (int e = hm_map<D>(&tqs, qs, BH, N)) return e;
    if (int e = hm_map<D>(&tdo, dout, BH, N)) return e;
    if constexpr (D <= 128) {
      if (ks)
        if (int e = hm_map<D>(&tks, ks, BH, N)) return e;
      return launch_bwd_dq<true, false, D>(tk, tv, tqs, tdo,
                                           ks ? &tks : nullptr, 0, 0, l, d,
                                           nullptr, dq_out, D, BH, N, 1,
                                           k_scale, st);
    } else {
      return launch_strip_dq<D, true>(tk, tv, tqs, tdo, nullptr, l, d,
                                      dq_out, D, BH, N, 1, k_scale, st);
    }
  }
  constexpr int T = f32_rows<D>();
  constexpr size_t smem = smem_dq_f32<T, T, D>();
  auto kernel = hm_bwd_dq_f32<T, T, D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3(cdiv(N, T), BH), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
      static_cast<float*>(dq_out), N, q_scale, k_scale);
  return 0;
}

// ---- above head dim 256: the column-split kernels, D at run time ----------
// (wgmma_attn_split.cuh in bf16, base e with two forward passes; in f32
// wgmma_tf32_split.cuh's 3xTF32 kernels, the forward in two passes too),
// every operand a (BH, N, D) plane a head

int split_fwd(const void* q, const void* k, const void* v, void* out,
              float* l, int BH, int N, int D, float q_scale, int is_bf16,
              cudaStream_t st) {
  return is_bf16 ? launch_split_fwd<true>(q, k, v, D, D, D, nullptr, out, l,
                                          BH, N, 1, D, q_scale, st)
                 : launch_split_fwd_tf32<true>(q, k, v, nullptr, out, l, BH,
                                               N, 1, D, D, D, D, q_scale, st);
}

int split_dkv(const void* q, const void* k, const void* v, const void* dout,
              const float* l, const float* d, const void* qs, void* dk,
              void* dv, int BH, int N, int D, float q_scale, int is_bf16,
              cudaStream_t st) {
  return is_bf16 ? launch_split_dkv<true>(k, v, D, D, qs, dout, nullptr, l,
                                          d, dk, dv, D, BH, N, 1, D, 1.f, st)
                 : launch_split_dkv_tf32(q, k, v, nullptr, dout, l, d, dk,
                                         dv, BH, N, 1, D, D, D, D, D,
                                         q_scale, st);
}

int split_dq(const void* q, const void* k, const void* v, const void* dout,
             const float* l, const float* d, const void* qs, const void* ks,
             void* dq, int BH, int N, int D, float q_scale, float k_scale,
             int is_bf16, cudaStream_t st) {
  return is_bf16 ? launch_split_dq<true>(k, v, D, D, qs, ks, dout, nullptr, l,
                                         d, dq, D, BH, N, 1, D, k_scale, st)
                 : launch_split_dq_tf32(q, k, v, nullptr, dout, l, d, dq,
                                        BH, N, 1, D, D, D, D, D, q_scale,
                                        k_scale, st);
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take (a head dim up to 256 that is not
// built, or one above it that is no multiple of 64). `is_bf16` selects
// __nv_bfloat16 (the tensor-core kernels) over float (the 3xTF32 forward;
// the FMA backward up to 256, 3xTF32 above).
// q_scale and k_scale are already rounded to
// the element type. Every (BH, N, D) tensor is contiguous and 16-byte
// aligned; lse and delta are (BH, N) f32.

extern "C" int hm_attn_fwd(const void* q, const void* k, const void* v,
                           void* out, void* lse, int BH, int N, int D,
                           float q_scale, int is_bf16, void* stream) {
  if (bad(BH, N)) return kBadArgument;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  if (int e = D > kStripMaxDim
                  ? split_fwd(q, k, v, out, l, BH, N, D, q_scale, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_fwd<decltype(d)::value>(
                          q, k, v, out, l, BH, N, q_scale, is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// The bf16 backward's prep pass: delta (BH, N) f32 and q * q_scale (BH, N,
// D) bf16, and k * k_scale into ks unless ks is null (k_scale a power of
// two: the dQ kernel then scales its accumulator).
extern "C" int hm_attn_bwd_prep(const void* q, const void* k,
                                const void* out, const void* dout,
                                void* delta, void* qs, void* ks, int BH,
                                int N, int D, float q_scale, float k_scale,
                                void* stream) {
  if (bad(BH, N)) return kBadArgument;
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? launch_prep_wide(q, k, D, D, out, dout, delta, qs, ks, BH,
                                     N, 1, D, q_scale, k_scale, st)
                  : by_head_dim(D, [&](auto d) {
                      constexpr int kD = decltype(d)::value;
                      return launch_bwd_prep<kD / 8>(
                          q, k, kD, kD, out, dout, delta, qs, ks, BH, N, 1,
                          q_scale, k_scale, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta and qs come from hm_attn_bwd_prep (q is not read); f32: qs is
// null and the kernel scales q itself.
extern "C" int hm_attn_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* qs, void* dk,
                               void* dv, int BH, int N, int D, float q_scale,
                               int is_bf16, void* stream) {
  if (bad(BH, N)) return kBadArgument;
  const auto l = static_cast<const float*>(lse);
  const auto d_ = static_cast<const float*>(delta);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? split_dkv(q, k, v, dout, l, d_, qs, dk, dv, BH, N, D,
                              q_scale, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_dkv<decltype(d)::value>(
                          q, k, v, dout, l, d_, qs, dk, dv, BH, N, q_scale,
                          is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}

// bf16: delta, qs and (unless k_scale is a power of two) ks come from
// hm_attn_bwd_prep; f32: qs and ks are null and the kernel scales q and k.
extern "C" int hm_attn_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qs,
                              const void* ks, void* dq, int BH, int N, int D,
                              float q_scale, float k_scale, int is_bf16,
                              void* stream) {
  if (bad(BH, N)) return kBadArgument;
  const auto l = static_cast<const float*>(lse);
  const auto d_ = static_cast<const float*>(delta);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int e = D > kStripMaxDim
                  ? split_dq(q, k, v, dout, l, d_, qs, ks, dq, BH, N, D,
                             q_scale, k_scale, is_bf16, st)
                  : by_head_dim(D, [&](auto d) {
                      return run_dq<decltype(d)::value>(
                          q, k, v, dout, l, d_, qs, ks, dq, BH, N, q_scale,
                          k_scale, is_bf16, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}
