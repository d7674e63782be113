// The strip design of the bf16 attention kernels for Hopper: a consumer
// warpgroup keeps its 64-row operands in shared memory, as strips of
// swizzled boxes, and holds nothing of the head dim's size in registers but
// its output accumulator. Built from wgmma_tiles.cuh (TMA, mbarriers,
// wgmma) and wgmma_attn_bwd.cuh's softmax-base helpers. It serves:
//   - the K3 forward at every head dim (mh_flash_attention.cu), and the K1
//     forward at 192 and 256 through K3's entry points, on column views of
//     the fused (B, N, 3A) qkv (qkv_flash_attention.cu);
//   - the backward at head dims 192 and 256 of K3, of K2 (through K3's
//     entry points, base 2) and of K4 (hm_flash_attention.cu, base e), after
//     wgmma_attn_bwd.cuh's prep pass.
// It stops at D = 256: above it the 64 x D output accumulator does not fit
// a warpgroup's registers, and every family runs wgmma_attn_split.cuh's
// column-split kernels, which stream D and split the output over the grid.
//
// Layout. A 64-row strip of D bf16 columns is Strip<D>::kBoxes swizzled
// boxes of box_cols<D>() columns, one after the other (one box of D columns
// at D = 16 and 32, D / 64 boxes of 64 above): wgmma_tiles.cuh's tile of D
// columns, loaded by tma_tile_d. Every operand is reached through a 3D
// tensor map (columns, rows, planes) with its own row stride; block (x, y)
// works on plane b = y / H at columns h * D, h = y % H (K4: H = 1, one head
// a plane). Rows past N arrive as zeros. A (planes, N) f32 bias row (or
// null: zeros) is added to the scores after the scale fold; the producer
// warp's lanes stage -inf past N, which masks the ragged kv tile's columns.
//
// Why strips. D = 256 is the hard part: a 64 x 256 f32 accumulator is 128
// registers a thread of a warpgroup, and a 64-row operand strip is 32 KB
// of shared memory. So q's fragments (D / 4 registers more) never move to
// registers: S = Q K^T reads both operands from shared memory, 16 k-steps
// over four 64-column boxes, and P goes from the accumulators into P.V,
// one m64n64k16 chain per 64 output columns.
//   - The forward runs two consumer warpgroups of 64 query rows each (232
//     registers: D / 2 of output, 32 of a 64 x 64 score tile, 16 of P) and
//     a producer warpgroup (40) whose first warp keeps a ring of (K, V)
//     stages full by TMA, so tile j + 1 is in flight while tile j is
//     multiplied. Each warpgroup folds scale * log2 e into its q strip in
//     place, once. Shared memory bounds the ring above D = 128: two q strips
//     (64 KB at 256) and two stages of K and V (128 KB) fit a block's
//     227 KB, a third stage does not; up to D = 128 it takes four.
//   - The backward at D = 192 and 256: one warpgroup has registers for one
//     64 x D accumulator and a block has shared memory for six strips
//     (192 KB at 256): a resident pair and a 2-stage ring of streamed
//     pairs, both operands of S and dP read from shared memory. dK/dV holds
//     a K and a V strip and streams (q * scale, dO); its two consumer
//     warpgroups split the outputs, not the rows: one forms S^T = K Q^T and
//     dV += P^T dO, the other S^T again, dP^T = V dO^T and dK += dS^T Q (5
//     products against the floor's 4, no hand-over of P^T between
//     warpgroups). dQ holds a q * scale and a dO strip (64 query rows) and
//     streams (K, V); its warpgroups split the kv tiles, each on its own
//     stage, and their two partial sums are added in a fixed order through
//     shared memory at the end. A k scale that is a power of two (1/16 at
//     D = 256) scales dQ's f32 accumulator at the store; any other is folded
//     into the K strip in place between S and dS K (there is no room for a
//     strip of the prep pass's k * scale, which therefore writes none).
//     Each output has one writer: no atomics, deterministic sums.
//
// Base. kBaseE (K4): the LSE is a natural log and the scores carry the
// plain scale, P = exp2(s * log2 e - lse * log2 e); otherwise (K2, K3) the
// scores carry scale * log2 e, the LSE is in log2 units and the caller's
// dk_fix = 1 / log2 e rescales dK.
//
// Numerics: the scale is folded into q in bf16; scores and statistics are
// f32; P is rounded to bf16 before P.V and 1/l divides the output; dS =
// bf16(P) * bf16(dP - delta), the subtraction in f32; dQ takes k times the
// scale rounded to bf16 (or the power-of-two scale on its f32 sum, the same
// number).

#pragma once

#include <math.h>

#include "wgmma_attn_bwd.cuh"
#include "wgmma_tiles.cuh"

namespace {

// A 64-row strip of D bf16 columns.
template <int D>
struct Strip {
  static constexpr int kBox = box_cols<D>();  // columns of one box
  static constexpr int kBoxes = D / kBox;
  static constexpr int kBoxElems = kTileRows * kBox;
  static constexpr int kNT = kBox / 8;  // 8-column groups of a box's output
  static constexpr int kElems = kTileRows * D;
  static constexpr int kBytes = kElems * 2;
};

template <int D>
struct FwdShape {
  static constexpr int kStages = D <= 128 ? 4 : 2;
  static constexpr size_t kSmem =
      1024 + (size_t)(kWG + 2 * kStages) * Strip<D>::kBytes +
      kStages * kTileRows * sizeof(float) +
      (2 * kStages + 1) * sizeof(uint64_t);
};

// c (64 x 64) += A . B^T over the D columns of two strips, both read from
// shared memory: one m64n64k16 chain of D / 16 steps.
template <int D>
__device__ __forceinline__ void strip_product(float (&c)[8][4],
                                              const bf16* a_strip,
                                              const bf16* b_strip) {
  if constexpr (D < 64) {
    wgmma_tile_ss<0, 2 * D>(c, a_strip, b_strip);
  } else {
#pragma unroll
    for (int jb = 0; jb < D / 64; ++jb)
      wgmma_tile_ss<0>(c, a_strip + jb * kTileElems,
                       b_strip + jb * kTileElems);
  }
}

// acc (64 x D, one accumulator per box) += a (64 x 64 from registers) .
// strip, whose 64 rows are the contraction; committed and waited for.
template <int D>
__device__ __forceinline__ void strip_accumulate(
    float (&acc)[Strip<D>::kBoxes][Strip<D>::kNT][4],
    const uint32_t (&a)[4][4], const bf16* strip) {
  using S = Strip<D>;
#pragma unroll
  for (int jb = 0; jb < S::kBoxes; ++jb)
    wgmma_tile<1, 2 * S::kBox>(acc[jb], a, strip + jb * S::kBoxElems);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int jb = 0; jb < S::kBoxes; ++jb) fence_acc(acc[jb]);
}

// Multiplies a strip by mul in place, rounded to bf16 (elementwise, so the
// swizzle does not matter), and makes it visible to wgmma: one warpgroup's
// threads, then its barrier `bar`.
template <int D>
__device__ __forceinline__ void strip_scale(bf16* strip, float mul, int bar) {
  for (int i = threadIdx.x & (kWarpgroup - 1); i < Strip<D>::kElems / 8;
       i += kWarpgroup) {
    uint4 v = reinterpret_cast<uint4*>(strip)[i];
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    reinterpret_cast<uint4*>(strip)[i] = v;
  }
  fence_proxy_async();
  warpgroup_sync(bar);
}

// The 64 bias values of kv tile j (null: zeros), -inf past N, into sb: the
// producer warp's lanes.
__device__ __forceinline__ void stage_bias(float* sb, const float* bias_b,
                                           int j, int N, int lane) {
  for (int r = lane; r < kTileRows; r += 32) {
    const int col = j * kTileRows + r;  // -inf masks columns >= N
    sb[r] = col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
  }
}

// P of a score and its row's staged LSE (see "Base").
template <bool kBaseE>
__device__ __forceinline__ float p_of(float s, float lse) {
  return kBaseE ? exp2f(fmaf(s, kLog2e, -lse)) : exp2f(s - lse);
}

// Grid (ceil(N / (64 kWG)), B * H). One block: 64 kWG query rows of one head
// against all N keys, streamed in 64-row (K, V) strips with an online
// softmax (base 2). Each consumer warpgroup owns a 64-row q strip, which
// stays in shared memory: the warpgroup folds the scale into it in place,
// once, and S = Q K^T reads it as wgmma's A operand. The producer warp's
// lanes copy each tile's 64 bias values into the stage (-inf past N), lane
// 0 issues the TMA loads.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    strip_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   float* __restrict__ lse, int N, int H, float q_scale) {
  using S = Strip<D>;
  constexpr int NB = S::kBoxes, NT = S::kNT, kStrip = S::kElems;
  constexpr int kStages = FwdShape<D>::kStages;
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
        mbar_expect_tx(qbar, kWG * S::kBytes);
        for (int w = 0; w < kWG; ++w)
          tma_tile_d<D>(sQ + w * kStrip, &tq, qbar, h * D,
                        q0 + kTileRows * w, b);
      }
      const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
      for (int j = 0; j < T; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (lane == 0) {
          bf16* stage = sKV + s * 2 * kStrip;
          mbar_expect_tx(&full[s], 2 * S::kBytes);
          tma_tile_d<D>(stage, &tk, &full[s], h * D, j * kTileRows, b);
          tma_tile_d<D>(stage + kStrip, &tv, &full[s], h * D, j * kTileRows,
                        b);
        }
        stage_bias(sBias + s * kTileRows, bias_b, j, N, lane);
        mbar_arrive(&full[s]);
      }
    }
  } else {
    consumer_registers();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    bf16* strip = sQ + wg * kStrip;
    mbar_wait(qbar, 0);
    strip_scale<D>(strip, q_scale, 1 + wg);  // q * q_scale, in bf16

    float o[NB][NT][4] = {}, m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    for (int j = 0; j < T; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const bf16* k_strip = sKV + s * 2 * kStrip;
      const bf16* v_strip = k_strip + kStrip;
      float sc[8][4] = {};
      strip_product<D>(sc, strip, k_strip);
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
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[jb][nt][e] *= corr[e >> 1];
      strip_accumulate<D>(o, pa, v_strip);
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
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(dst + S::kBox * jb + 8 * nt) =
              __floats2bfloat162_rn(o[jb][nt][2 * half] / l[half],
                                    o[jb][nt][2 * half + 1] / l[half]);
      // LSE in log2 units: the scores carry log2(e)
      if (t == 0) lse[(size_t)bh * N + row] = m[half] + log2f(l[half]);
    }
  }
}

template <int D>
struct BwdShape {
  static_assert(D % 64 == 0 && D > 128, "the strip backward: D = 192, 256");
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

// Grid (ceil(N / 64), B * H). One block: 64 key/value rows of one head (a K
// and a V strip in shared memory); streams (q * scale, dO) strips with their
// LSE and delta through a 2-stage TMA ring. The two consumer warpgroups
// split the outputs, not the rows: warpgroup 0 forms S^T = K Q^T and
// dV += P^T dO, warpgroup 1 forms S^T again, dP^T = V dO^T and
// dK += dS^T Q: one writer per output, no atomics, and no hand-over of P^T
// between warpgroups, for one repeated S^T (5 products against the floor's
// 4). P^T and dS^T go from the accumulators into the last products. dk and
// dv share the row stride lddkv.
template <int D, bool kBaseE>
__global__ void __launch_bounds__(kHopperThreads, 1)
    strip_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tqs,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int lddkv, int N, int H, float dk_fix) {
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
          st[r] = row < N ? staged_lse<kBaseE>(lse_bh[row]) : INFINITY;
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
      strip_product<D>(st, sK, q_strip);
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
              bf16x2(p_of<kBaseE>(s0, l2.x), p_of<kBaseE>(s1, l2.y));
        }
      }
      if (wg == 0) {
        strip_accumulate<D>(acc, pa, do_strip);  // dV += P^T dO
      } else {
        float dpt[8][4] = {};
        strip_product<D>(dpt, sV, do_strip);
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
        strip_accumulate<D>(acc, pa, q_strip);  // dK += dS^T Q
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
// adds and stores (row stride lddq), in that fixed order. acc_mul = k_scale
// (a power of two) scales the sum at the store; with kRescaleK (any other
// scale) the warpgroup multiplies its K strip by k_scale in place, rounded
// to bf16, between S and dS K, and acc_mul = 1.
template <int D, bool kBaseE, bool kRescaleK>
__global__ void __launch_bounds__(kHopperThreads, 1)
    strip_bwd_dq_bf16(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tqs,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int lddq, int N, int H, float k_scale) {
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
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
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
        stage_bias(sBias + s * kTileRows, bias_b, j, N, lane);
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
      lse_r[half] = row < N ? staged_lse<kBaseE>(lse[(size_t)bh * N + row])
                            : INFINITY;
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
      strip_product<D>(sc, sQ, k_strip);
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
          pa[nt >> 1][2 * (nt & 1) + (e >> 1)] =
              bf16x2(p_of<kBaseE>(s0, lse_r[e >> 1]),
                     p_of<kBaseE>(s1, lse_r[e >> 1]));
        }
      }
      if (kRescaleK) {
        // every warp's S has read the strip; scale it in place
        warpgroup_sync(1 + wg);
        strip_scale<D>(k_strip, k_scale, 1 + wg);
      }
      float dp[8][4] = {};
      strip_product<D>(dp, sdO, v_strip);
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
      strip_accumulate<D>(acc, pa, k_strip);  // dQ += dS K
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
        store_acc(dq + (size_t)b * N * lddq + h * D + 64 * jb, lddq,
                  acc[jb], q0 + r0, N, kRescaleK ? 1.f : k_scale);
      }
    }
  }
}

// -------------------------------------------------------------------------
// Launchers: B planes of N rows, H heads of D columns a plane; each returns
// 0 or a cudaError_t from the launch set-up (the caller reads
// cudaGetLastError after).
// -------------------------------------------------------------------------

template <int D>
int launch_strip_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
                     const CUtensorMap& tv, const float* bias, void* out,
                     float* lse, int B, int N, int H, float q_scale,
                     cudaStream_t st) {
  constexpr size_t smem = FwdShape<D>::kSmem;
  auto kernel = strip_fwd_bf16<D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<hopper_grid(B, N, H), kHopperThreads, smem, st>>>(
      tq, tk, tv, bias, static_cast<bf16*>(out), lse, N, H, q_scale);
  return 0;
}

template <int D, bool kBaseE>
int launch_strip_dkv(const CUtensorMap& tk, const CUtensorMap& tv,
                     const CUtensorMap& tqs, const CUtensorMap& tdo,
                     const float* bias, const float* lse, const float* delta,
                     void* dk, void* dv, int lddkv, int B, int N, int H,
                     float dk_fix, cudaStream_t st) {
  constexpr size_t smem = BwdShape<D>::kSmemDkv;
  auto kernel = strip_bwd_dkv_bf16<D, kBaseE>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + kTileRows - 1) / kTileRows, B * H), kHopperThreads,
           smem, st>>>(tk, tv, tqs, tdo, bias, lse, delta,
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), lddkv,
                       N, H, dk_fix);
  return 0;
}

template <int D, bool kBaseE, bool kRescaleK>
int launch_strip_dq_as(const CUtensorMap& tk, const CUtensorMap& tv,
                       const CUtensorMap& tqs, const CUtensorMap& tdo,
                       const float* bias, const float* lse,
                       const float* delta, void* dq, int lddq, int B, int N,
                       int H, float k_scale, cudaStream_t st) {
  constexpr size_t smem = BwdShape<D>::kSmemDq;
  auto kernel = strip_bwd_dq_bf16<D, kBaseE, kRescaleK>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + kTileRows - 1) / kTileRows, B * H), kHopperThreads,
           smem, st>>>(tk, tv, tqs, tdo, bias, lse, delta,
                       static_cast<bf16*>(dq), lddq, N, H, k_scale);
  return 0;
}

// A k_scale that is a power of two scales the f32 sum at the store; any
// other is folded into the K strip (no prep-pass copy is read).
template <int D, bool kBaseE>
int launch_strip_dq(const CUtensorMap& tk, const CUtensorMap& tv,
                    const CUtensorMap& tqs, const CUtensorMap& tdo,
                    const float* bias, const float* lse, const float* delta,
                    void* dq, int lddq, int B, int N, int H, float k_scale,
                    cudaStream_t st) {
  return power_of_two(k_scale)
             ? launch_strip_dq_as<D, kBaseE, false>(
                   tk, tv, tqs, tdo, bias, lse, delta, dq, lddq, B, N, H,
                   k_scale, st)
             : launch_strip_dq_as<D, kBaseE, true>(
                   tk, tv, tqs, tdo, bias, lse, delta, dq, lddq, B, N, H,
                   k_scale, st);
}

}  // namespace
