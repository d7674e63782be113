// The column-split f32 kernels for Hopper: the forward, dK/dV and dQ at
// every head dim D above 256 (a multiple of 64, at run time), for K1/K2
// (through K3's entry points), K3 and K4 (whose two-pass forward also runs
// here at 192 and 256, one output group), with products in 3xTF32 on wgmma
// (wgmma_tf32.cuh's splits, descriptors and products) fed by TMA, and
// wgmma_tf32_wide.cuh's ring, producer walk and chains. They replace the
// FMA kernels that flash_split_f32.cuh had (split_fwd_f32 and the backward
// before it), and compute what mofo_tpu's _mh_fwd_impl (flash_attention.py
// :653, call :678), _fwd_impl (:262, call :275), _mh_bwd_impl (:737, call
// :783) and _bwd_impl (:304, calls :332 and :359) compute above head dim
// 256.
//
// No resident strip. wgmma_tf32_wide.cuh keeps one 64 x D (hi, lo) strip
// resident: 512 D bytes, 128 KB at D = 256. At 384 it would be 192 KB and
// at 768 384 KB, beside a ring of 32 KB entries in 227 KB. So here both
// operands of a contraction over D (S^T = K Q^T, dP^T = V dO^T, S = Q K^T,
// dP = dO V^T) stream as ring entries, a chunk pair at a time (A, then B),
// and only the output product (O_g += P V_g, dV_g += P^T dO_g, dK_g +=
// dS^T (q * q_scale)_g, dQ_g += dS (K * k_scale)_g) runs on the group's own
// chunks.
//
// Groups and roles over z. D is kC = D / 64 chunks, and the output is split
// into G = ceil(kC / 4) groups of at most 256 columns, balanced: group g
// takes chunks [g kC / G, (g + 1) kC / G), so at 384 two groups of 192
// columns (not 256 + 128), at 768 three of 256, at 320 128 + 192. The
// widest group has NG = ceil(kC / G) chunks, 3 or 4 (kC / G > 2.5 above
// 256; K4's forward at 192 and 256 is one group of 3 or 4): the kernels
// are templates on NG, and a narrower group skips its
// last chunk. 64 x 256 of dK and dV together would be 256 registers a
// thread, so dK/dV splits the roles over z as mh_dkv_tf32 does: block (x,
// y, 2 g + role) writes dV (role 0) or dK (role 1) of group g of its 64 kv
// rows, 2 G blocks a kv tile; a dQ block (x, y, g) group g of dQ of its 64
// query rows, a forward block (x, y, g) group g of out of its 64 query rows
// (group 0 alone writes the LSE: every group forms the same S in the same
// order). Each output column has one writer. A tile's walk:
//   - the forward block: kC pairs (q_c * q_scale, K_c) -> S, the bias row,
//     the online softmax (base e), then the group's V chunks transposed ->
//     O_g += P V_g: kC + n chunk products; K4 (kTwoPass) in two passes, as
//     its reference: pass 1 the kC pairs alone (the row's m and l), pass 2
//     the whole walk with P = exp(s - m) / l: 2 kC + n;
//   - the dV block: kC pairs (K_c, q_c * q_scale) -> S^T, P^T = exp(S^T +
//     bias - lse), then the group's dO chunks transposed -> dV_g: kC + n
//     chunk products;
//   - the dK block: kC pairs (V_c, dO_c) -> dP^T - delta (dp_walk), kC
//     pairs (K_c, q_c * q_scale) -> S^T, dS^T = P^T (dP^T - delta), then
//     the group's q * q_scale chunks transposed -> dK_g: 2 kC + n;
//   - the dQ block: kC pairs (dO_c, V_c) -> dP - delta, kC pairs (q_c *
//     q_scale, K_c) -> S, dS = P (dP - delta), then the group's K *
//     k_scale chunks transposed -> dQ_g: 2 kC + n.
// Summed over groups and roles that is (G + 1) kC chunk products a (kv, q)
// tile pair for the forward ((2 G + 1) kC in two passes), (3 G + 2) kC for
// dK/dV and (2 G + 1) kC for dQ: chip_smoke.products(G), so its
// bound_recompute_ms is these kernels' bound (the least work is 2 kC, 4 kC
// and 3 kC).
//
// The streamed bytes. A chunk product of a pair walk reads two 16 KB raw
// entries where the wide kernels read one (their A is the resident strip).
// A (kv, q) tile pair costs 6 G kC + 2 kC entries over its 2 G dK/dV blocks
// (dV: 2 kC + n a block, dK: 4 kC + n) and its G dQ blocks take 4 kC + n
// each: at 384 (kC = 6, G = 2) 84 entries (1.31 MiB) for 48 chunk products
// of dK/dV and 54 (0.84 MiB) for 30 of dQ. Its G forward blocks take 2 kC +
// n each (4 kC + n in two passes): 30 entries (0.47 MiB) for 18 chunk
// products at 384, 84 (1.31 MiB) for 48 at 768 (kC = 12, G = 3), and K4 at
// 512 (kC = 8, G = 2) 40 (0.63 MiB) for 40. A chunk product is 3 x 64^3
// multiply-adds, 0.42 us of one SM's share of the TF32 rate (495e12 / 132
// FLOP/s), so a dV block's tile (15 entries, 9 chunk products; a forward
// block's at 384 is the same walk) asks for
// 240 KB in 3.8 us: 63 GB/s an SM, 8.4 TB/s over 132 SMs, more than the L2
// gives. Shared memory is tighter still: a pair's chain reads 96 KB of
// operands (24 wgmma k-steps, A and B 2 KB each), and the producer reads 32
// KB and writes 64 KB splitting the pair, beside TMA's 32 KB: 224 KB a
// chunk product, about 1750 clocks at 128 bytes a clock against the
// products' ~740. So these kernels are expected at 2-3x their recompute
// bound, above the wide kernels' 3.2-3.5x only by what the L2 adds. The 2
// G blocks of a kv tile read the same q-side entries: a thread-block
// cluster with TMA multicast could load each once; it is not built (a
// later change, if it measures faster).
//
// Registers. One consumer warpgroup (the wide kernels' split): the output
// accumulator is NG * 32 registers a thread (96 at NG = 3, 128 at 4);
// beside it the dK and dQ blocks hold dP's tile, S's and a fresh
// accumulator (96), then dS's (hi, lo) fragments and a fresh accumulator
// (96): 192 / 224 at the peak; the forward block holds S's tile and a
// fresh accumulator (64), then P's (hi, lo) fragments and a fresh
// accumulator (96): 224 at the peak. The producer warpgroup splits each
// landed
// entry, as loaded or transposed (32-bit wgmma operands are K-major only),
// and stages the tile's per-row values with its first entry.
//
// Shared memory: 1024 bytes of alignment, a ring of kSplitEntries = 7
// (hi, lo) entries (229,376 bytes), the per-tile values (1 KB: dK/dV's LSE
// and delta of the q tile and dQ's bias row of the kv tile, -inf past N,
// two tiles deep; the forward's bias row four tiles deep: at 192 (kC = 3)
// pass 1's walk is 6 entries a tile, so the producer may stage tile t + 2's
// row while the consumer still reads tile t's)
// and 15 barriers: 231,544 of 232,448 bytes.
//
// Precision (wgmma_tf32_wide.cuh's note): every chunk's chain
// runs into a fresh accumulator, added in f32, small terms first (lo.hi,
// hi.lo, then hi.hi); dP and dP^T take one k-step a fresh accumulator
// (where P is 1, dS is rounding noise) and start from -delta with each
// chunk's rounding error carried into the next (dp_walk: that noise grows
// with D); K * k_scale is scaled before its split.
//
// Numerics: those of the FMA kernels they replace. f32 in base e; q times
// q_scale as it is split; the (B, N) bias added after the fold (K4: none),
// kv columns >= N score -inf, q rows >= N carry +inf LSE (P = 0); the
// forward's P not rounded, 1 / l dividing the output (K4: p / l before
// P V), the LSE m + log(l) a natural log; the backward's P = exp(s + bias
// - lse); dS = P (dP - delta) with delta (B H, N) from the caller
// (fa.mh_delta, K4's fa.hm_delta); dQ takes K * k_scale, dK the scaled q.
//
// Layout: every operand through a 3D tensor map (columns, rows, planes) of
// 32 x 64 boxes at its own row stride: q, k and v as column views of K1's
// fused qkv (ld = 3A), K3's k and v as views of one fused kv, K4's (B H, N,
// D) planes (H = 1); plane b = y / H at columns h D, h = y % H; out and
// dout (B, N, A) contiguous; dk, dv at row stride lddkv, dq at lddq. Rows
// past N arrive as zeros and are never stored.

#pragma once

#include <math.h>

#include "wgmma_tf32_wide.cuh"

namespace {

constexpr int kSplitEntries = 7;      // the ring's (hi, lo) entries
constexpr int kSplitGroupChunks = 4;  // chunks of the widest group: 256 columns
constexpr size_t kSplitTf32Smem =
    1024 + (size_t)(kSplitEntries * kPairElems + 4 * kChunk) * sizeof(float) +
    (2 * kSplitEntries + 1) * sizeof(uint64_t);

// The output groups of kC chunks: G of them, group g's first chunk and
// chunk count, the widest group's chunks.
__host__ __device__ constexpr int split_groups_tf32(int kC) {
  return (kC + kSplitGroupChunks - 1) / kSplitGroupChunks;
}
struct SplitGroup {
  int c0, n;
};
__host__ __device__ constexpr SplitGroup split_group_tf32(int kC, int g) {
  return {g * kC / split_groups_tf32(kC),
          (g + 1) * kC / split_groups_tf32(kC) -
              g * kC / split_groups_tf32(kC)};
}
__host__ __device__ constexpr int split_widest_tf32(int kC) {
  return (kC + split_groups_tf32(kC) - 1) / split_groups_tf32(kC);
}

constexpr int kRoleDV = 0, kRoleDK = 1, kRoleDQ = 2, kRoleFwd = 3;

// Pair entries of a tile's walk: one pair walk (dV, the forward), or two.
__host__ __device__ constexpr int split_pairs_tf32(int role, int kC) {
  return (role == kRoleDV || role == kRoleFwd ? 2 : 4) * kC;
}

// Entries a tile's walk takes: the pair walks, then the group's n chunks.
__host__ __device__ constexpr int split_entries_tf32(int role, int kC,
                                                     int n) {
  return split_pairs_tf32(role, kC) + n;
}

// Entry r of a tile's walk: which tensor (0 q, 1 k, 2 v, 3 dO), its chunk,
// transposed or as loaded, at the block's own rows or the tile's. A pair
// is (A, B): the A operand at the block's own rows (K or V of dK/dV's kv
// rows, q or dO of dQ's and the forward's query rows), B at the tile's.
// The dV block's kC pairs (K_c, q_c) form S^T; the dK block's first kC
// pairs (V_c, dO_c) dP^T, the next kC S^T; the dQ block's (dO_c, V_c) dP,
// then (q_c, K_c) S; the forward's (q_c, K_c) S. The group's chunks close
// the walk, transposed: dO's (dV), q's (dK), K's (dQ), V's (the forward).
struct SplitEntry {
  int tensor, chunk;
  bool transposed, own;
};
__host__ __device__ constexpr SplitEntry split_entry_tf32(int role, int kC,
                                                          int c0, int r) {
  const int pair_entries = split_pairs_tf32(role, kC);
  if (r >= pair_entries)
    return {role == kRoleDQ    ? 1
            : role == kRoleDV  ? 3
            : role == kRoleFwd ? 2
                               : 0,
            c0 + r - pair_entries, true, false};
  const bool b = r & 1;
  const bool scores = role == kRoleDV || role == kRoleFwd || r >= 2 * kC;
  // q (S) or dO (dP) if set
  const bool x = b != (role == kRoleDQ || role == kRoleFwd);
  return {scores ? (x ? 0 : 1) : (x ? 3 : 2), (r >> 1) % kC, false, !b};
}

// What the producer multiplies an entry by as it splits it: q by q_scale,
// K transposed (dQ's B) by k_scale.
__device__ __forceinline__ float split_mul_tf32(const SplitEntry& w,
                                                float q_scale,
                                                float k_scale) {
  return w.tensor == 0 ? q_scale
                       : (w.tensor == 1 && w.transposed) ? k_scale : 1.f;
}

// s += A B^T over the kC chunk pairs from entry e, each chunk's chain into
// a fresh accumulator (add_chunk).
template <int kE, typename Load>
__device__ __forceinline__ void score_walk(float (&s)[8][4],
                                           const WideRing<kE>& ring, int e,
                                           int kC, Load load) {
#pragma unroll 1
  for (int c = 0; c < kC; ++c) {
    const float* at = ring.wait(e + 2 * c);
    const float* bt = ring.wait(e + 2 * c + 1);
    add_chunk(s, 0, [&](auto& f) {
      chain_ss(
          f, [&](int kk) { return chunk_k8(at, kk); },
          [&](int kk) { return chunk_k8(bt, kk); }, kChunkLo, kChunkLo);
    });
    ring_refill(ring, e + 2 * c, 2, load);
  }
}

// dp = A B^T over the kC chunk pairs from entry e, minus delta (delta(nt,
// i): accumulator element i of column group nt's): the sum starts at
// -delta, each k-step's three products go into a fresh accumulator summed
// in f32 into its chunk's part, and each chunk's part joins dp by an
// exact two-sum whose rounding error opens the next chunk's part. Where P
// is 1 (a one-column sample, N = 1) dS = P (dP - delta) is rounding noise
// around 0, and with the cotangent 2 out dP and delta are about 2 |v|^2 =
// 2 D: added to dP alone, that sum's roundings at 2 D are the noise (2.4e-4
// an ulp at D = 1024); from -delta with the errors carried, what is left
// is the k-step sums' own. Those the tensor cores cut toward zero (to 26
// bits below the largest addend's leading bit, then to f32:
// tools/tf32_sum_probe.py), which biases a sum of like-signed terms low,
// as does the split's dropped lo.lo term: at D = 1024 that row's dS is
// 2.2e-4 low, beside the plain version's 6.1e-4 from rounding dP at 2048
// (PERF.md §6; the row rule of main_path.f32_rows_beyond holds
// the row to float64 there). Only a delta formed from the same products
// in the same order would cancel it exactly (ROADMAP, Queue 3, S3).
template <int kE, typename Load, typename Delta>
__device__ __forceinline__ void dp_walk(float (&dp)[8][4],
                                        const WideRing<kE>& ring, int e,
                                        int kC, Load load, Delta delta) {
  float part[8][4];  // a chunk's share, then the error carried on
#pragma unroll 1
  for (int c = 0; c < kC; ++c) {
    const float* at = ring.wait(e + 2 * c);
    const float* bt = ring.wait(e + 2 * c + 1);
    if (c == 0) {  // the tile's values are staged with its first entry
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[nt][i] = -delta(nt, i), part[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float f[8][4] = {};
      wgmma_fence();
      wgmma_tf32_ss(f, chunk_k8(at, kk) + kChunkLo, chunk_k8(bt, kk));
      wgmma_tf32_ss(f, chunk_k8(at, kk), chunk_k8(bt, kk) + kChunkLo);
      wgmma_tf32_ss(f, chunk_k8(at, kk), chunk_k8(bt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(f);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[nt][i] += f[nt][i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // two-sum: dp + part = s + err exactly
        const float s = dp[nt][i] + part[nt][i], bb = s - dp[nt][i];
        part[nt][i] = (dp[nt][i] - (s - bb)) + (part[nt][i] - bb);
        dp[nt][i] = s;
      }
    ring_refill(ring, e + 2 * c, 2, load);
  }
}

// One block of either kernel (role kRoleDV, kRoleDK or kRoleDQ): the 64
// rows x of head y, group grp of its output (NG chunks at most), written
// at dst (row stride ld). dK/dV: bias (B, N) or null, lse and delta of the
// q tiles; dQ: the bias row of the kv tiles, lse and delta of its rows.
template <int NG, int kRole>
__device__ __forceinline__ void split_tf32_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dst, int ld, int N, int H, int D, SplitGroup grp,
    float q_scale, float k_scale, unsigned char* wsmem) {
  constexpr int kE = kSplitEntries;
  constexpr bool kDQ = kRole == kRoleDQ;
  const int kC = D / kChunk;
  const int ept = split_entries_tf32(kRole, kC, grp.n);
  float* sE = reinterpret_cast<float*>(smem_1024(wsmem));
  float* sSide = sE + kE * kPairElems;  // [tile parity][2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sSide + 4 * kChunk);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int own0 = blockIdx.x * kChunk;
  const int T = (N + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WideRing<kE> ring = wide_ring<kE>(sE, bars, ept * T);
  auto load = [&](int e, float* hi, uint64_t* bar) {
    const SplitEntry w = split_entry_tf32(kRole, kC, grp.c0, e % ept);
    tma_f32<kChunk, kChunk, kChunk>(
        hi + (w.transposed ? kChunkElems : 0),
        w.tensor == 0 ? tq : w.tensor == 1 ? tk : w.tensor == 2 ? tv : tdo,
        bar, h * D + kChunk * w.chunk, w.own ? own0 : e / ept * kChunk, b);
  };
  if (threadIdx.x == 0)
    for (int e = 0; e < kE; ++e) ring_issue(ring, e, load);

  if (warp >= 4) {  // producer
    const float* lse_bh = lse + (size_t)bh * N;
    const float* delta_bh = delta + (size_t)bh * N;
    const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
    produce(
        ring, threadIdx.x - kWarpgroup,
        [&](int e) {
          return split_entry_tf32(kRole, kC, grp.c0, e % ept).transposed;
        },
        [&](int e) {
          return split_mul_tf32(split_entry_tf32(kRole, kC, grp.c0, e % ept),
                                q_scale, k_scale);
        },
        [&](int e, int p) {
          if (e % ept || p >= kChunk) return;
          const int j = e / ept, row = j * kChunk + p;
          float* sd = sSide + (j & 1) * 2 * kChunk;
          if constexpr (kDQ) {  // the kv tile's bias row, -inf past N
            sd[p] = row < N ? (bias_b ? bias_b[row] : 0.f) : -INFINITY;
          } else {  // the q tile's rows >= N: P = 0, dS = 0
            sd[p] = row < N ? lse_bh[row] : INFINITY;
            sd[kChunk + p] = row < N ? delta_bh[row] : 0.f;
          }
        });
    return;
  }

  const int r0 = 16 * warp, g = lane >> 2, t = lane & 3;
  // the block's own rows: dK/dV the bias of its kv rows (rows >= N are
  // never stored: any finite value will do), dQ the LSE and delta of its
  // query rows (rows >= N: P = 0)
  float own_a[2], own_b[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = own0 + r0 + g + 8 * half;
    if constexpr (kDQ) {
      own_a[half] = row < N ? lse[(size_t)bh * N + row] : INFINITY;
      own_b[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
    } else {
      own_a[half] = (bias && row < N) ? bias[(size_t)b * N + row] : 0.f;
    }
  }
  float acc[NG * 8][4] = {};  // dV, dK or dQ of the group

  for (int j = 0; j < T; ++j) {
    const int e0 = ept * j;
    const float* sd = sSide + (j & 1) * 2 * kChunk;
    float dp[8][4];  // dP^T - delta or dP - delta
    if constexpr (kRole != kRoleDV)
      dp_walk(dp, ring, e0, kC, load, [&](int nt, int i) {
        return kDQ ? own_b[i >> 1] : sd[kChunk + 8 * nt + 2 * t + (i & 1)];
      });
    float sc[8][4] = {};  // S^T or S
    score_walk(sc, ring, kRole == kRoleDV ? e0 : e0 + 2 * kC, kC, load);
    // P^T (dV), dS^T (dK) or dS (dQ) into sc: the bias after the fold
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(sd + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float col = (e & 1) ? l2.y : l2.x;  // lse, or dQ's bias
        const float pv = kDQ ? expf(sc[nt][e] + col - own_a[e >> 1])
                             : expf(sc[nt][e] + own_a[e >> 1] - col);
        sc[nt][e] = kRole == kRoleDV ? pv : pv * dp[nt][e];
      }
    }
    uint32_t ph[8][4], pl[8][4];  // as (hi, lo) A fragments
    acc_to_a(sc, ph, pl);
    // the group's chunks, transposed: out_c += (P^T or dS^T or dS) B_c
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      if (c >= grp.n) break;
      const int e = e0 + ept - grp.n + c;
      const float* bt = ring.wait(e);
      add_chunk(acc, c, [&](auto& f) {
        chain_rs(f, ph, pl, [&](int kk) { return chunk_k8(bt, kk); });
      });
      fence_frag(ph);
      fence_frag(pl);
      ring_refill(ring, e, 1, load);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = own0 + r0 + g + 8 * half;
    if (row >= N) continue;
    float* d = dst + ((size_t)b * N + row) * ld + h * D + kChunk * grp.c0 +
               2 * t;
#pragma unroll
    for (int nt = 0; nt < NG * 8; ++nt)
      if (nt < 8 * grp.n)
        *reinterpret_cast<float2*>(d + 8 * nt) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// Grid (ceil(N / 64), B * H, 2 G). Block (x, y, 2 g + role): the 64 kv
// rows x of head y, group g of dV (role 0) or dK (role 1), each streaming
// every q tile. dk and dv at row stride lddkv; delta (B, H, N) from the
// caller.
template <int NG>
__global__ void __launch_bounds__(kWideThreads, 1)
    split_dkv_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int lddkv, int N, int H, int D,
                   float q_scale) {
  extern __shared__ unsigned char wsmem[];
  const SplitGroup grp = split_group_tf32(D / kChunk, blockIdx.z >> 1);
  if (blockIdx.z & 1)
    split_tf32_block<NG, kRoleDK>(&tq, &tk, &tv, &tdo, bias, lse, delta, dk,
                                  lddkv, N, H, D, grp, q_scale, 1.f, wsmem);
  else
    split_tf32_block<NG, kRoleDV>(&tq, &tk, &tv, &tdo, bias, lse, delta, dv,
                                  lddkv, N, H, D, grp, q_scale, 1.f, wsmem);
}

// Grid (ceil(N / 64), B * H, G). Block (x, y, g): the 64 query rows x of
// head y against every kv tile, group g of dQ (row stride lddq); delta
// (B, H, N) from the caller.
template <int NG>
__global__ void __launch_bounds__(kWideThreads, 1)
    split_dq_tf32(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int lddq, int N, int H, int D, float q_scale,
                  float k_scale) {
  extern __shared__ unsigned char wsmem[];
  split_tf32_block<NG, kRoleDQ>(&tq, &tk, &tv, &tdo, bias, lse, delta, dq,
                                lddq, N, H, D,
                                split_group_tf32(D / kChunk, blockIdx.z),
                                q_scale, k_scale, wsmem);
}

// The forward's walk: step e of a block's walk as (tile, r): the tile it
// belongs to, counted over the passes (K4's pass 1 takes its T tiles' pair
// entries alone, pass 2 the whole walk of each), and the entry of that
// tile's walk; kv tile tile % T.
struct FwdStep {
  int tile, r;
};
__host__ __device__ constexpr FwdStep split_fwd_step(bool two_pass, int kC,
                                                     int n, int T, int e) {
  const int pairs = split_pairs_tf32(kRoleFwd, kC);
  const int e1 = two_pass ? pairs * T : 0;  // pass 1's entries
  return e < e1 ? FwdStep{e / pairs, e % pairs}
                : FwdStep{(two_pass ? T : 0) + (e - e1) / (pairs + n),
                          (e - e1) % (pairs + n)};
}

// Grid (ceil(N / 64), B * H, G). Block (x, y, g): the 64 query rows x of
// head y against every kv tile, group g of the output. Each kv tile: kC
// pairs (q_c * q_scale, K_c) -> S, the bias row (-inf past N), the softmax
// in base e, then O_g += P V_c over the group's chunks (V transposed).
// K3 and K1 (one pass): an online softmax, 1 / l dividing the output at
// the end. K4 (kTwoPass): pass 1 takes the row statistics alone (S, no
// P V), pass 2 forms P = exp(s - m) / l before P V. Every group forms the
// same S in the same order, so group 0 alone writes the LSE (a natural
// log); out (B, N, H D) contiguous, lse (B H, N); bias (B, N) or null.
template <int NG, bool kTwoPass>
__global__ void __launch_bounds__(kWideThreads, 1)
    split_fwd_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ lse, int N, int H, int D,
                   float q_scale) {
  constexpr int kE = kSplitEntries;
  extern __shared__ unsigned char wsmem[];
  const int kC = D / kChunk;
  const int pairs = split_pairs_tf32(kRoleFwd, kC);
  const SplitGroup grp = split_group_tf32(kC, blockIdx.z);
  float* sE = reinterpret_cast<float*>(smem_1024(wsmem));
  float* sSide = sE + kE * kPairElems;  // [tile % 4][64]: the bias row
  uint64_t* bars = reinterpret_cast<uint64_t*>(sSide + 4 * kChunk);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kChunk;
  const int T = (N + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WideRing<kE> ring = wide_ring<kE>(
      sE, bars, (kTwoPass ? pairs * T : 0) + (pairs + grp.n) * T);
  auto entry = [&](int e) {
    const FwdStep st = split_fwd_step(kTwoPass, kC, grp.n, T, e);
    return split_entry_tf32(kRoleFwd, kC, grp.c0, st.r);
  };
  auto load = [&](int e, float* hi, uint64_t* bar) {
    const FwdStep st = split_fwd_step(kTwoPass, kC, grp.n, T, e);
    const SplitEntry w = split_entry_tf32(kRoleFwd, kC, grp.c0, st.r);
    tma_f32<kChunk, kChunk, kChunk>(
        hi + (w.transposed ? kChunkElems : 0),
        w.tensor == 0 ? &tq : w.tensor == 1 ? &tk : &tv, bar,
        h * D + kChunk * w.chunk, w.own ? q0 : st.tile % T * kChunk, b);
  };
  if (threadIdx.x == 0)
    for (int e = 0; e < kE; ++e) ring_issue(ring, e, load);

  if (warp >= 4) {  // producer
    const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
    produce(
        ring, threadIdx.x - kWarpgroup,
        [&](int e) { return entry(e).transposed; },
        [&](int e) { return split_mul_tf32(entry(e), q_scale, 1.f); },
        [&](int e, int p) {
          const FwdStep st = split_fwd_step(kTwoPass, kC, grp.n, T, e);
          if (st.r || p >= kChunk) return;
          const int col = st.tile % T * kChunk + p;
          sSide[(st.tile & 3) * kChunk + p] =
              col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
        });
    return;
  }

  const int r0 = 16 * warp, g = lane >> 2, t = lane & 3;
  float o[NG * 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int e0 = 0;  // the tile's first entry
  for (int tile = 0; tile < (kTwoPass ? 2 : 1) * T; ++tile) {
    const bool stats = kTwoPass && tile < T;  // pass 1: m and l alone
    float sc[8][4] = {};
    score_walk(sc, ring, e0, kC, load);
    // the bias after the fold; -inf past N (every tile holds a column < N)
    const float* sb = sSide + (tile & 3) * kChunk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] += (e & 1) ? b2.y : b2.x;
    }
    if (kTwoPass && !stats) {  // pass 2: P = exp(s - m) / l
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = expf(sc[nt][e] - m[e >> 1]) / l[e >> 1];
    } else {
      float mx[2] = {-INFINITY, -INFINITY}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
          rs[e >> 1] += sc[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
      if (stats) {
        e0 += pairs;
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < NG * 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
    }
    uint32_t ph[8][4], pl[8][4];  // P, unrounded, as (hi, lo)
    acc_to_a(sc, ph, pl);
    // the group's chunks of V, transposed: O_c += P V_c
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      if (c >= grp.n) break;
      const int e = e0 + pairs + c;
      const float* bt = ring.wait(e);
      add_chunk(o, c, [&](auto& f) {
        chain_rs(f, ph, pl, [&](int kk) { return chunk_k8(bt, kk); });
      });
      fence_frag(ph);
      fence_frag(pl);
      ring_refill(ring, e, 1, load);
    }
    e0 += pairs + grp.n;
  }

  const int A = H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= N) continue;
    float* d = out + ((size_t)b * N + row) * A + h * D + kChunk * grp.c0 +
               2 * t;
#pragma unroll
    for (int nt = 0; nt < NG * 8; ++nt)
      if (nt < 8 * grp.n)
        *reinterpret_cast<float2*>(d + 8 * nt) = make_float2(
            kTwoPass ? o[nt][2 * half] : o[nt][2 * half] / l[half],
            kTwoPass ? o[nt][2 * half + 1] : o[nt][2 * half + 1] / l[half]);
    if (blockIdx.z == 0 && t == 0)
      lse[(size_t)bh * N + row] = m[half] + logf(l[half]);
  }
}

// -------------------------------------------------------------------------
// Launchers: B planes of N rows, H heads of D columns a plane (D above 256,
// a multiple of 64); each returns 0, kBadArgument or a cudaError_t from the
// set-up.
// -------------------------------------------------------------------------

// The four tensor maps of a launch (dout contiguous: row stride A).
int split_maps_tf32(CUtensorMap (&m)[4], const void* q, const void* k,
                    const void* v, const void* dout, int B, int N, int A,
                    int ldq, int ldk, int ldv) {
  if (int e = wide_map(&m[0], q, B, N, A, ldq)) return e;
  if (int e = wide_map(&m[1], k, B, N, A, ldk)) return e;
  if (int e = wide_map(&m[2], v, B, N, A, ldv)) return e;
  return wide_map(&m[3], dout, B, N, A, A);
}

// The kernel instance of D (NG = 3 or 4) after its shared-memory limit is
// set, through run(kernel). D above 256, or with strip_dims at 192 and 256
// too (one output group of 3 or 4 chunks: K4's two-pass forward).
template <typename Kernel3, typename Kernel4, typename Run>
int split_launch_tf32(int D, Kernel3 k3, Kernel4 k4, Run run,
                      bool strip_dims = false) {
  if (D % kChunk || D <= (strip_dims ? 2 : 4) * kChunk) return kBadArgument;
  const int ng = split_widest_tf32(D / kChunk);
  if (ng == 3) {
    if (int e = max_smem((const void*)k3, kSplitTf32Smem)) return e;
    return run(k3);
  }
  if (int e = max_smem((const void*)k4, kSplitTf32Smem)) return e;
  return run(k4);
}

int launch_split_dkv_tf32(const void* q, const void* k, const void* v,
                          const float* bias, const void* dout,
                          const float* lse, const float* delta, void* dk,
                          void* dv, int B, int N, int H, int D, int ldq,
                          int ldk, int ldv, int lddkv, float q_scale,
                          cudaStream_t st) {
  CUtensorMap m[4];
  if (D % kChunk) return kBadArgument;
  if (int e = split_maps_tf32(m, q, k, v, dout, B, N, H * D, ldq, ldk, ldv))
    return e;
  const dim3 grid((N + kChunk - 1) / kChunk, B * H,
                  2 * split_groups_tf32(D / kChunk));
  return split_launch_tf32(
      D, split_dkv_tf32<3>, split_dkv_tf32<4>, [&](auto kernel) {
        kernel<<<grid, kWideThreads, kSplitTf32Smem, st>>>(
            m[0], m[1], m[2], m[3], bias, lse, delta,
            static_cast<float*>(dk), static_cast<float*>(dv), lddkv, N, H, D,
            q_scale);
        return 0;
      });
}

int launch_split_dq_tf32(const void* q, const void* k, const void* v,
                         const float* bias, const void* dout,
                         const float* lse, const float* delta, void* dq,
                         int B, int N, int H, int D, int ldq, int ldk,
                         int ldv, int lddq, float q_scale, float k_scale,
                         cudaStream_t st) {
  CUtensorMap m[4];
  if (D % kChunk) return kBadArgument;
  if (int e = split_maps_tf32(m, q, k, v, dout, B, N, H * D, ldq, ldk, ldv))
    return e;
  const dim3 grid((N + kChunk - 1) / kChunk, B * H,
                  split_groups_tf32(D / kChunk));
  return split_launch_tf32(
      D, split_dq_tf32<3>, split_dq_tf32<4>, [&](auto kernel) {
        kernel<<<grid, kWideThreads, kSplitTf32Smem, st>>>(
            m[0], m[1], m[2], m[3], bias, lse, delta,
            static_cast<float*>(dq), lddq, N, H, D, q_scale, k_scale);
        return 0;
      });
}

// The forward (kTwoPass: K4's two passes, which also take D = 192 and 256
// at one group; K1/K2 and K3 run wgmma_tf32_wide.cuh's forward there): q,
// k, v at row strides ldq, ldk, ldv; out (B, N, H D) contiguous; lse (B H,
// N); bias (B, N) or null.
template <bool kTwoPass>
int launch_split_fwd_tf32(const void* q, const void* k, const void* v,
                          const float* bias, void* out, float* lse, int B,
                          int N, int H, int D, int ldq, int ldk, int ldv,
                          float q_scale, cudaStream_t st) {
  CUtensorMap m[3];
  if (D % kChunk) return kBadArgument;
  const int A = H * D;
  if (int e = wide_map(&m[0], q, B, N, A, ldq)) return e;
  if (int e = wide_map(&m[1], k, B, N, A, ldk)) return e;
  if (int e = wide_map(&m[2], v, B, N, A, ldv)) return e;
  const dim3 grid((N + kChunk - 1) / kChunk, B * H,
                  split_groups_tf32(D / kChunk));
  return split_launch_tf32(
      D, split_fwd_tf32<3, kTwoPass>, split_fwd_tf32<4, kTwoPass>,
      [&](auto kernel) {
        kernel<<<grid, kWideThreads, kSplitTf32Smem, st>>>(
            m[0], m[1], m[2], bias, static_cast<float*>(out), lse, N, H, D,
            q_scale);
        return 0;
      },
      kTwoPass);
}

}  // namespace
