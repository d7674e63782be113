// The column-split bf16 attention kernels for Hopper: every head dim D above
// 256 (a multiple of 64, at run time), for K1/K2 (through K3's entry
// points), K3 and K4. Built from wgmma_tiles.cuh (TMA, mbarriers, wgmma),
// wgmma_attn_bwd.cuh's softmax-base helpers and wgmma_attn_wide.cuh's.
//
// Why a split. The strip kernels (wgmma_attn_wide.cuh) keep a 64 x D f32
// output accumulator in a warpgroup's registers: at D = 256 that is already
// 128 registers a thread, and above it there is no room. Here D is streamed
// and only the output is split: block (x, y, z) owns output columns
// [256 z, 256 z + 256) of its head (a group of kGroupBoxes 64-column boxes;
// the last group may hold fewer), G = ceil(D / 256) groups over the grid's
// z. A contraction over D (S = Q K^T, dP = dO V^T) streams 64-column boxes
// of both operands through a ring of shared-memory slots and sums them in
// one f32 accumulator; a product whose N is D (P.V, dS K, P^T dO, dS^T Q)
// runs on the group's own boxes only.
//
// The price: every group forms the same S (and dP) again, G times in all.
// Every group does so with the same products in the same order, so its
// softmax statistics agree with every other group's bit for bit, and group
// 0 alone writes the LSE. Each output has one writer: no atomics,
// deterministic sums.
//
// Why 256 columns a group. A 64 x 256 f32 accumulator is the most that fits
// beside S and P in a consumer warpgroup's 232 registers (the strip kernels
// at D = 256 show it); a group of 128 would form S twice as often.
//
// Layout. Every operand is reached through a 3D tensor map (columns, rows,
// planes) of 64 x 64 boxes (128-byte swizzle) with its own row stride; block
// (x, y, z) works on plane b = y / H at columns h D, h = y % H (K4: H = 1,
// one head a plane). Rows past N arrive as zeros. The consumers read the
// bias row, the LSE and delta from device memory themselves: a kv column
// >= N scores -inf, a q row >= N carries +inf LSE (P = 0).
//
// The ring. A producer warp's lane 0 walks the sequence of slots that the
// consumers walk (one slot: up to kSlotBoxes boxes that one step consumes
// together) and fills slot i % kSplitStages once its consumers have released
// it. Every consumer warp waits for every slot and releases it, whether its
// warpgroup reads the slot or not (dK/dV's warpgroup 0 skips the dP^T
// slots), so the empty barrier's phases stay aligned.
//
// Numerics: those of the strip kernels. K1/K3 (base 2): q * scale * log2 e
// folded in bf16 (the forward folds each q box in place as it arrives; the
// backward reads the prep pass's copy), the bias added after the fold, an
// online softmax, P rounded to bf16 before P.V, 1/l dividing the output, the
// LSE in log2 units, dK rescaled by the caller's dk_fix. K4 (kBaseE): two
// passes over kv (row max and sum, then p / l rounded to bf16 before P.V),
// the LSE a natural log. dS = bf16(P) * bf16(dP - delta), the subtraction in
// f32; dQ takes the prep pass's k * k_scale copy, or a power-of-two k_scale
// on its f32 sum (the same number).

#pragma once

#include <math.h>

#include <algorithm>

#include "wgmma_attn_bwd.cuh"
#include "wgmma_attn_wide.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kGroupBoxes = 4;     // 64-column boxes of a block's output
constexpr int kSlotBoxes = 3;      // boxes a ring slot holds
constexpr int kSlotElems = kSlotBoxes * kTileElems;
constexpr int kSplitStages = 8;
constexpr size_t kSplitSmem = 1024 +
                              (size_t)kSplitStages * kSlotElems * sizeof(bf16) +
                              2 * kSplitStages * sizeof(uint64_t);

// The ring of slots and its full / empty barriers.
struct Ring {
  bf16* slots;
  uint64_t* full;
  uint64_t* empty;

  // Producer: waits until slot `it` is released, announces `boxes` boxes of
  // TMA traffic into it; returns the slot (its barrier in bar).
  __device__ __forceinline__ bf16* fill(int it, int boxes, uint64_t*& bar) {
    const int s = it % kSplitStages;
    mbar_wait(&empty[s], ((it / kSplitStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], boxes * kTileBytes);
    bar = &full[s];
    return slots + s * kSlotElems;
  }

  // Consumer: waits until slot `it` has arrived.
  __device__ __forceinline__ bf16* wait(int it) {
    const int s = it % kSplitStages;
    mbar_wait(&full[s], (it / kSplitStages) & 1);
    return slots + s * kSlotElems;
  }

  // Consumer: this warp is done with slot `it` (its products waited for).
  __device__ __forceinline__ void release(int it) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % kSplitStages]);
  }
};

// Carves the ring out of the dynamic shared memory and (thread 0) sets up its
// barriers: one TMA arrival fills a slot, `releases` warps release it.
__device__ __forceinline__ Ring split_ring(unsigned char* raw, int releases) {
  unsigned char* sm = smem_1024(raw);
  Ring r;
  r.slots = reinterpret_cast<bf16*>(sm);
  r.full = reinterpret_cast<uint64_t*>(r.slots + kSplitStages * kSlotElems);
  r.empty = r.full + kSplitStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], releases);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// Multiplies a 64 x 64 box by mul in place, rounded to bf16, and makes it
// visible to wgmma: one warpgroup's threads, then its barrier `bar`.
__device__ __forceinline__ void box_scale(bf16* box, float mul, int bar) {
  for (int i = threadIdx.x & (kWarpgroup - 1); i < kTileElems / 8;
       i += kWarpgroup) {
    uint4 v = reinterpret_cast<uint4*>(box)[i];
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    reinterpret_cast<uint4*>(box)[i] = v;
  }
  fence_proxy_async();
  warpgroup_sync(bar);
}

// The score's additive term of kv column col: the bias (null: 0), -inf past N.
__device__ __forceinline__ float kv_term(const float* bias_b, int col,
                                         int N) {
  return col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
}

// c (64 x 64) += the product over `boxes` slots of the ring, from slot `it`
// on, of slot box a (A, K-major) and slot box b (B^T, K-major): a
// contraction over the head dim. Advances it.
__device__ __forceinline__ void ring_product(float (&c)[8][4], Ring& ring,
                                             int& it, int boxes, int a,
                                             int b) {
  for (int bx = 0; bx < boxes; ++bx, ++it) {
    const bf16* s = ring.wait(it);
    wgmma_tile_ss<0>(c, s + a * kTileElems, s + b * kTileElems);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(c);
    ring.release(it);
  }
}

// acc[c] (64 x 64 each, c < ng) += a (64 x 64 from registers) . slot box
// `box` of the ng slots from `it` on (MN-major: its rows the contraction).
// Advances it.
__device__ __forceinline__ void ring_accumulate(
    float (&acc)[kGroupBoxes][8][4], const uint32_t (&a)[4][4], Ring& ring,
    int& it, int ng, int box) {
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) {
    if (c >= ng) break;
    const bf16* s = ring.wait(it);
    wgmma_tile<1>(acc[c], a, s + box * kTileElems);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc[c]);
    ring.release(it);
    ++it;
  }
}

// Grid (ceil(N / (64 kWG)), B * H, G). One block: 64 kWG query rows of one
// head against all N keys, output columns of group z. For each kv tile the
// ring brings NB slots (warpgroup w's q box, then the K box, of each of the
// NB boxes of the head dim), then the group's V boxes. Each consumer
// warpgroup folds the scale into its q box in place as it arrives. Base 2
// (K1/K3): an online softmax; kBaseE (K4): two passes, the first without V.
template <bool kBaseE>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   float* __restrict__ lse, int N, int H, int NB,
                   float q_scale) {
  extern __shared__ unsigned char wsmem[];
  Ring ring = split_ring(wsmem, 4 * kWG);
  constexpr int kPasses = kBaseE ? 2 : 1;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = 64 * NB, A = H * D;
  const int g0 = kGroupBoxes * blockIdx.z;
  const int ng = min(kGroupBoxes, NB - g0);
  const int q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG && lane == 0) {
      int it = 0;
      uint64_t* bar;
      for (int pass = 0; pass < kPasses; ++pass)
        for (int j = 0; j < T; ++j) {
          for (int bx = 0; bx < NB; ++bx) {
            bf16* s = ring.fill(it++, kWG + 1, bar);
            for (int w = 0; w < kWG; ++w)
              tma_tile(s + w * kTileElems, &tq, bar, h * D + 64 * bx,
                       q0 + kTileRows * w, b);
            tma_tile(s + kWG * kTileElems, &tk, bar, h * D + 64 * bx,
                     j * kTileRows, b);
          }
          if (pass == kPasses - 1)
            for (int c = 0; c < ng; ++c)
              tma_tile(ring.fill(it++, 1, bar), &tv, bar,
                       h * D + 64 * (g0 + c), j * kTileRows, b);
        }
    }
    return;
  }

  consumer_registers();
  const int wg = warp >> 2, r0 = 16 * (warp & 3);
  const int g = lane >> 2, t = lane & 3;
  const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
  int it = 0;

  // S of kv tile j: the scale folded into this warpgroup's q box of each
  // slot, the products summed over the head dim, then the bias (K3) and
  // -inf past N added
  auto scores = [&](float (&sc)[8][4], int j) {
    for (int bx = 0; bx < NB; ++bx, ++it) {
      bf16* s = ring.wait(it);
      box_scale(s + wg * kTileElems, q_scale, 1 + wg);
      wgmma_tile_ss<0>(sc, s + wg * kTileElems, s + kWG * kTileElems);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      ring.release(it);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = j * kTileRows + 8 * nt + 2 * t;
      const float b0 = kv_term(bias_b, col, N);
      const float b1 = kv_term(bias_b, col + 1, N);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] += (e & 1) ? b1 : b0;
    }
  };

  float o[kGroupBoxes][8][4] = {}, m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  if constexpr (kBaseE) {
    for (int j = 0; j < T; ++j) {  // pass 1: row max and sum
      float sc[8][4] = {};
      scores(sc, j);
      float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
    for (int j = 0; j < T; ++j) {  // pass 2: P = exp(s - m) / l, P.V
      float sc[8][4] = {};
      scores(sc, j);
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
      ring_accumulate(o, pa, ring, it, ng, 0);
    }
  } else {
    for (int j = 0; j < T; ++j) {
      float sc[8][4] = {};
      scores(sc, j);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
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
      for (int c = 0; c < kGroupBoxes; ++c)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][nt][e] *= corr[e >> 1];
      ring_accumulate(o, pa, ring, it, ng, 0);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + kTileRows * wg + r0 + g + 8 * half;
    if (row >= N) continue;
    bf16* dst = out + ((size_t)b * N + row) * A + h * D + 64 * g0 + 2 * t;
#pragma unroll
    for (int c = 0; c < kGroupBoxes; ++c) {
      if (c >= ng) break;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float x = o[c][nt][2 * half], y = o[c][nt][2 * half + 1];
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * nt) =
            kBaseE ? __floats2bfloat162_rn(x, y)
                   : __floats2bfloat162_rn(x / l[half], y / l[half]);
      }
    }
    if (blockIdx.z == 0 && t == 0)
      lse[(size_t)bh * N + row] =
          kBaseE ? m[half] + logf(l[half]) : m[half] + log2f(l[half]);
  }
}

// Grid (ceil(N / 64), B * H, G). One block: 64 key/value rows of one head,
// output columns of group z of dK and dV. For each q tile j the ring brings
// NB slots of (K box, q * scale box), NB of (V box, dO box), then ng of the
// group's (dO box, q * scale box). The two consumer warpgroups split the
// outputs, as the strip kernels' do: warpgroup 0 forms S^T = K Q^T and
// dV += P^T dO, warpgroup 1 forms S^T again, dP^T = V dO^T and
// dK += dS^T Q; P^T and dS^T go from the accumulators into the last
// products. dk and dv share the row stride lddkv.
template <bool kBaseE>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tqs,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int lddkv, int N, int H, int NB, float dk_fix) {
  static_assert(kWG == 2, "one warpgroup per output");
  extern __shared__ unsigned char wsmem[];
  Ring ring = split_ring(wsmem, 4 * kWG);
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = 64 * NB;
  const int g0 = kGroupBoxes * blockIdx.z;
  const int ng = min(kGroupBoxes, NB - g0);
  const int k0 = blockIdx.x * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG && lane == 0) {
      int it = 0;
      uint64_t* bar;
      for (int j = 0; j < T; ++j) {
        const int j0 = j * kTileRows;
        for (int part = 0; part < 2; ++part)  // (K, q * scale), (V, dO)
          for (int bx = 0; bx < NB; ++bx) {
            bf16* s = ring.fill(it++, 2, bar);
            tma_tile(s, part ? &tv : &tk, bar, h * D + 64 * bx, k0, b);
            tma_tile(s + kTileElems, part ? &tdo : &tqs, bar,
                     h * D + 64 * bx, j0, b);
          }
        for (int c = 0; c < ng; ++c) {
          bf16* s = ring.fill(it++, 2, bar);
          tma_tile(s, &tdo, bar, h * D + 64 * (g0 + c), j0, b);
          tma_tile(s + kTileElems, &tqs, bar, h * D + 64 * (g0 + c), j0, b);
        }
      }
    }
    return;
  }

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
  const float* lse_bh = lse + (size_t)bh * N;
  const float* delta_bh = delta + (size_t)bh * N;
  float acc[kGroupBoxes][8][4] = {};  // warpgroup 0: dV, warpgroup 1: dK
  int it = 0;

  for (int j = 0; j < T; ++j) {
    float st[8][4] = {};
    ring_product(st, ring, it, NB, 0, 1);  // S^T = K Q^T
    uint32_t pa[4][4];  // P^T rounded to bf16, then (warpgroup 1) dS^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      // the q columns; +inf LSE past N
      const int col = j * kTileRows + 8 * nt + 2 * t;
      const float l0 = col < N ? staged_lse<kBaseE>(lse_bh[col]) : INFINITY;
      const float l1 =
          col + 1 < N ? staged_lse<kBaseE>(lse_bh[col + 1]) : INFINITY;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float s0 = st[nt][e] + bias_r[e >> 1];  // after the fold
        const float s1 = st[nt][e + 1] + bias_r[e >> 1];
        pa[nt >> 1][2 * (nt & 1) + (e >> 1)] =
            bf16x2(p_of<kBaseE>(s0, l0), p_of<kBaseE>(s1, l1));
      }
    }
    if (wg == 0) {  // the dP^T slots are warpgroup 1's
      for (int bx = 0; bx < NB; ++bx, ++it) {
        ring.wait(it);
        ring.release(it);
      }
    } else {
      float dpt[8][4] = {};
      ring_product(dpt, ring, it, NB, 0, 1);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = j * kTileRows + 8 * nt + 2 * t;
        const float d0 = col < N ? delta_bh[col] : 0.f;
        const float d1 = col + 1 < N ? delta_bh[col + 1] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          uint32_t& w = pa[nt >> 1][2 * (nt & 1) + (e >> 1)];
          const uint32_t dd = bf16x2(dpt[nt][e] - d0, dpt[nt][e + 1] - d1);
          w = bf16x2(bf16_lo(w) * bf16_lo(dd), bf16_hi(w) * bf16_hi(dd));
        }
      }
    }
    // warpgroup 0: dV += P^T dO (box 0), warpgroup 1: dK += dS^T Q (box 1)
    ring_accumulate(acc, pa, ring, it, ng, wg);
  }

  bf16* dst = (wg == 0 ? dv : dk) + (size_t)b * N * lddkv + h * D + 64 * g0;
  const float mul = wg == 0 ? 1.f : dk_fix;
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) {
    if (c >= ng) break;
    store_acc(dst + 64 * c, lddkv, acc[c], k0 + r0, N, mul);
  }
}

// Grid (ceil(N / (64 kWG)), B * H, G). One block: 64 kWG query rows of one
// head (64 a consumer warpgroup), output columns of group z of dQ. For each
// kv tile j the ring brings NB slots of (warpgroup 0's and 1's q * scale
// boxes, the K box), NB of (their dO boxes, the V box), then ng of the
// group's K boxes from tkg (the prep pass's k * k_scale, or K itself with a
// power-of-two k_scale in acc_mul, which scales the f32 sum at the store).
template <bool kBaseE>
__global__ void __launch_bounds__(kHopperThreads, 1)
    split_bwd_dq_bf16(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tqs,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tkg,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int lddq, int N, int H, int NB, float acc_mul) {
  extern __shared__ unsigned char wsmem[];
  Ring ring = split_ring(wsmem, 4 * kWG);
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = 64 * NB;
  const int g0 = kGroupBoxes * blockIdx.z;
  const int ng = min(kGroupBoxes, NB - g0);
  const int q0 = blockIdx.x * kWG * kTileRows;
  const int T = (N + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 4 * kWG) {  // producer
    producer_registers();
    if (warp == 4 * kWG && lane == 0) {
      int it = 0;
      uint64_t* bar;
      for (int j = 0; j < T; ++j) {
        const int j0 = j * kTileRows;
        for (int part = 0; part < 2; ++part)  // (q * scale, K), (dO, V)
          for (int bx = 0; bx < NB; ++bx) {
            bf16* s = ring.fill(it++, kWG + 1, bar);
            for (int w = 0; w < kWG; ++w)
              tma_tile(s + w * kTileElems, part ? &tdo : &tqs, bar,
                       h * D + 64 * bx, q0 + kTileRows * w, b);
            tma_tile(s + kWG * kTileElems, part ? &tv : &tk, bar,
                     h * D + 64 * bx, j0, b);
          }
        for (int c = 0; c < ng; ++c)
          tma_tile(ring.fill(it++, 1, bar), &tkg, bar, h * D + 64 * (g0 + c),
                   j0, b);
      }
    }
    return;
  }

  consumer_registers();
  const int wg = warp >> 2, r0 = 16 * (warp & 3);
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + kTileRows * wg + r0;
  float lse_r[2], delta_r[2];  // rows >= N: P = 0, dS = 0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    lse_r[half] = row < N ? staged_lse<kBaseE>(lse[(size_t)bh * N + row])
                          : INFINITY;
    delta_r[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
  }
  const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
  float acc[kGroupBoxes][8][4] = {};
  int it = 0;

  for (int j = 0; j < T; ++j) {
    float sc[8][4] = {};
    ring_product(sc, ring, it, NB, wg, kWG);  // S = Q K^T
    uint32_t pa[4][4];  // P rounded to bf16, then dS
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = j * kTileRows + 8 * nt + 2 * t;
      const float b0 = kv_term(bias_b, col, N);  // after the scale fold
      const float b1 = kv_term(bias_b, col + 1, N);
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        pa[nt >> 1][2 * (nt & 1) + (e >> 1)] =
            bf16x2(p_of<kBaseE>(sc[nt][e] + b0, lse_r[e >> 1]),
                   p_of<kBaseE>(sc[nt][e + 1] + b1, lse_r[e >> 1]));
    }
    float dp[8][4] = {};
    ring_product(dp, ring, it, NB, wg, kWG);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        uint32_t& w = pa[nt >> 1][2 * (nt & 1) + (e >> 1)];
        const uint32_t dd = bf16x2(dp[nt][e] - delta_r[e >> 1],
                                   dp[nt][e + 1] - delta_r[e >> 1]);
        w = bf16x2(bf16_lo(w) * bf16_lo(dd), bf16_hi(w) * bf16_hi(dd));
      }
    ring_accumulate(acc, pa, ring, it, ng, 0);  // dQ += dS K
  }

  bf16* dst = dq + (size_t)b * N * lddq + h * D + 64 * g0;
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) {
    if (c >= ng) break;
    store_acc(dst + 64 * c, lddq, acc[c], row0, N, acc_mul);
  }
}

// The prep pass at head dims above 256: one warp a (row, head), its lanes
// striding over the head's D / 8 chunks of 8 values (4 each at D = 1024),
// delta a sum over the whole warp. Otherwise bwd_prep_bf16: chunk c of row
// i is q[i, h D + 8c ..] (row stride ldq; k the same with ldk) and the same
// columns of dO, O, qs and ks (row stride A = H D); ks (when not null) gets
// k * k_scale rounded to bf16.
__global__ void __launch_bounds__(kPrepThreads)
    bwd_prep_wide_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       int ldq, int ldk, const bf16* __restrict__ out,
                       const bf16* __restrict__ dout, float* __restrict__ delta,
                       bf16* __restrict__ qs, bf16* __restrict__ ks, int BN,
                       int N, int H, int D, float q_scale, float k_scale) {
  const int A = H * D, chunks = D / 8, lane = threadIdx.x & 31;
  const long heads = (long)BN * H;
  const long warps = (long)gridDim.x * blockDim.x / 32;
  for (long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32; w < heads;
       w += warps) {  // uniform across the warp
    const int row = (int)(w / H), hh = (int)(w - (long)row * H);
    float acc = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const size_t at = (size_t)row * A + hh * D + 8 * c;
      const uint4 a = *reinterpret_cast<const uint4*>(dout + at);
      const uint4 o = *reinterpret_cast<const uint4*>(out + at);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(x[e]);
        const float2 fy = __bfloat1622float2(y[e]);
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
      for (int part = 0; part < (ks ? 2 : 1); ++part) {
        const size_t from = (size_t)row * (part ? ldk : ldq) + hh * D + 8 * c;
        uint4 v = *reinterpret_cast<const uint4*>((part ? k : q) + from);
        const float mul = part ? k_scale : q_scale;
        __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(z[e]);
          z[e] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
        }
        *reinterpret_cast<uint4*>((part ? ks : qs) + at) = v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const int bb = row / N, n = row - bb * N;
      delta[((size_t)bb * H + hh) * N + n] = acc;
    }
  }
}

// -------------------------------------------------------------------------
// Launchers: B planes of N rows, H heads of D columns a plane (D a multiple
// of 64); q, k, v (and dk, dv, dq) at their own row strides, out, dout and
// the prep pass's copies (B, N, H D) contiguous. Each returns 0,
// kBadArgument or a cudaError_t from the launch set-up (the caller reads
// cudaGetLastError after).
// -------------------------------------------------------------------------

// A (planes, rows, cols) bf16 operand at row stride ld, 64 x 64 boxes.
int split_map(CUtensorMap* map, const void* base, int planes, int rows,
              int cols, int ld) {
  return tile_map(map, base, cols, rows, planes, ld, (long)rows * ld, 64);
}

dim3 split_grid(int rows_a_block, int B, int N, int H, int D) {
  return dim3((N + rows_a_block - 1) / rows_a_block, B * H,
              (D / 64 + kGroupBoxes - 1) / kGroupBoxes);
}

template <bool kBaseE>
int launch_split_fwd(const void* q, const void* k, const void* v, int ldq,
                     int ldk, int ldv, const float* bias, void* out,
                     float* lse, int B, int N, int H, int D, float q_scale,
                     cudaStream_t st) {
  if (D % 64) return kBadArgument;
  CUtensorMap tq, tk, tv;
  if (int e = split_map(&tq, q, B, N, H * D, ldq)) return e;
  if (int e = split_map(&tk, k, B, N, H * D, ldk)) return e;
  if (int e = split_map(&tv, v, B, N, H * D, ldv)) return e;
  auto kernel = split_fwd_bf16<kBaseE>;
  if (int e = max_smem((const void*)kernel, kSplitSmem)) return e;
  kernel<<<split_grid(kWG * kTileRows, B, N, H, D), kHopperThreads,
           kSplitSmem, st>>>(tq, tk, tv, bias, static_cast<bf16*>(out), lse,
                             N, H, D / 64, q_scale);
  return 0;
}

// The backward's maps: k and v at their row strides, q * scale and dO
// contiguous.
int split_bwd_maps(CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tqs,
                   CUtensorMap* tdo, const void* k, const void* v, int ldk,
                   int ldv, const void* qs, const void* dout, int B, int N,
                   int A) {
  if (int e = split_map(tk, k, B, N, A, ldk)) return e;
  if (int e = split_map(tv, v, B, N, A, ldv)) return e;
  if (int e = split_map(tqs, qs, B, N, A, A)) return e;
  return split_map(tdo, dout, B, N, A, A);
}

template <bool kBaseE>
int launch_split_dkv(const void* k, const void* v, int ldk, int ldv,
                     const void* qs, const void* dout, const float* bias,
                     const float* lse, const float* delta, void* dk,
                     void* dv, int lddkv, int B, int N, int H, int D,
                     float dk_fix, cudaStream_t st) {
  if (D % 64 || !qs) return kBadArgument;  // qs: the prep pass's
  CUtensorMap tk, tv, tqs, tdo;
  if (int e = split_bwd_maps(&tk, &tv, &tqs, &tdo, k, v, ldk, ldv, qs, dout,
                             B, N, H * D))
    return e;
  auto kernel = split_bwd_dkv_bf16<kBaseE>;
  if (int e = max_smem((const void*)kernel, kSplitSmem)) return e;
  kernel<<<split_grid(kTileRows, B, N, H, D), kHopperThreads, kSplitSmem,
           st>>>(tk, tv, tqs, tdo, bias, lse, delta, static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), lddkv, N, H, D / 64, dk_fix);
  return 0;
}

// ks: the prep pass's k * k_scale, or null when k_scale is a power of two
// (the f32 sum is scaled instead); any other k_scale needs the copy.
template <bool kBaseE>
int launch_split_dq(const void* k, const void* v, int ldk, int ldv,
                    const void* qs, const void* ks, const void* dout,
                    const float* bias, const float* lse, const float* delta,
                    void* dq, int lddq, int B, int N, int H, int D,
                    float k_scale, cudaStream_t st) {
  if (D % 64 || !qs || (!ks && !power_of_two(k_scale))) return kBadArgument;
  CUtensorMap tk, tv, tqs, tdo, tks;
  if (int e = split_bwd_maps(&tk, &tv, &tqs, &tdo, k, v, ldk, ldv, qs, dout,
                             B, N, H * D))
    return e;
  if (ks)
    if (int e = split_map(&tks, ks, B, N, H * D, H * D)) return e;
  auto kernel = split_bwd_dq_bf16<kBaseE>;
  if (int e = max_smem((const void*)kernel, kSplitSmem)) return e;
  kernel<<<split_grid(kWG * kTileRows, B, N, H, D), kHopperThreads,
           kSplitSmem, st>>>(tk, tv, tqs, tdo, ks ? tks : tk, bias, lse,
                             delta, static_cast<bf16*>(dq), lddq, N, H,
                             D / 64, ks ? 1.f : k_scale);
  return 0;
}

int launch_prep_wide(const void* q, const void* k, int ldq, int ldk,
                     const void* out, const void* dout, void* delta, void* qs,
                     void* ks, int B, int N, int H, int D, float q_scale,
                     float k_scale, cudaStream_t st) {
  if (D % 64 || (long)B * N * std::max(ldq, ldk) >= (1l << 31))
    return kBadArgument;
  const long lanes = (long)B * N * H * 32;
  const int blocks = (int)std::min<long>(
      (lanes + kPrepThreads - 1) / kPrepThreads, 132 * 16);
  bwd_prep_wide_bf16<<<blocks, kPrepThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), ldq, ldk,
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<bf16*>(qs),
      static_cast<bf16*>(ks), B * N, N, H, D, q_scale, k_scale);
  return 0;
}

}  // namespace
