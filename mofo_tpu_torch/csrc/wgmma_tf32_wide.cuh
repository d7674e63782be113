// K3's f32 forward, dK/dV and dQ at head dims 192 and 256 for Hopper:
// products in 3xTF32 on wgmma (wgmma_tf32.cuh's splits, descriptors and
// products), fed by TMA, with D streamed in 64-column chunks.
// mh_flash_attention.cu runs them for K3 and, through K3's entry points,
// for K1/K2 above head dim 128 (q, k and v column views of the fused qkv);
// hm_flash_attention.cu runs the dK/dV and dQ for K4's f32 backward (one
// head a plane, no bias). They replace the FMA kernels mh_fwd_f32,
// mh_bwd_dkv_f32 and mh_bwd_dq_f32 (and K4's hm_bwd_dkv_f32 and
// hm_bwd_dq_f32) at these widths (dQ up to 128 is wgmma_tf32_dq.cuh's).
//
// Why chunks. A 64 x D f32 (hi, lo) pair is 512 D bytes: 128 KB at D = 256.
// A block can keep one such strip in its 227 KB of shared memory, not two,
// so the rest is streamed through a ring of 64 x 64 (hi, lo) entries (32
// KB each) beside the resident strip: the ring holds kEntries = 3 entries
// at 256 (128 + 96 KB) and 4 at 192 (96 + 128 KB). Every product is one
// chunk: a chain of 8 k-steps (64 values of its contraction) that writes a
// 64 x 64 f32 tile, 32 registers a thread of the warpgroup.
//
// Registers. A 64 x D f32 output accumulator is D / 2 registers a thread
// of a warpgroup (128 at 256). Beside it a chunk step holds a 64 x 64 score
// tile (32), the chunk's fresh accumulator (32), or the (hi, lo) A
// fragments of a 64 x 64 P (64) and a fresh accumulator (32): 224 at D =
// 256. So a block runs one consumer warpgroup and one producer warpgroup
// (256 threads, up to 255 registers each; the producer's transposed split
// holds 32 values, which spilled below 104 registers in K2's kernels).
//   - The forward: a block owns 64 query rows of one head. The consumer
//     splits its q * q_scale strip into a resident (hi, lo) pair once and
//     walks the kv tiles: S = sum over chunks c of Q_c K_c^T (A and B from
//     shared memory), the bias, an online softmax (base e), P's fragments,
//     then O_c += P V_c for each chunk c (A from registers). 4 D / 64 chunk
//     products a kv tile: the floor.
//   - The dK/dV kernel: dK and dV of 64 kv rows at D = 256 are 256
//     registers together, more than a warpgroup holds beside anything
//     else. So the grid's z splits the outputs: block (x, y, 0) writes dV
//     of its 64 kv rows, block (x, y, 1) dK. Both keep K * 1 as the
//     resident (hi, lo) strip (the A operand of S^T = K Q^T) and stream the
//     q side. The dV block: q * q_scale chunks (S^T), then dO chunks
//     transposed (dV_c += P^T dO_c). The dK block: V and dO chunks (dP^T =
//     V dO^T), q * q_scale chunks (S^T again), then q * q_scale chunks
//     transposed (dK_c += dS^T (q * q_scale)_c). 5 D / 64 chunk products
//     per (kv, q) tile pair against the floor's 4: S^T is formed twice. The
//     alternatives cost more: two consumer warpgroups with column groups
//     over the grid form S^T and dP^T once per group (G = 2 at 256: 8 D /
//     64), and 384 threads leave the producer 64 registers. The dK block
//     forms dP^T before S^T, so dP^T's tile, S^T's and a fresh accumulator
//     are live together (224 registers), not P^T's besides.
//   - The dQ kernel: a block owns 64 query rows of one head; 64 x D of dQ
//     is 128 registers at D = 256. S = (q * q_scale) K^T needs q * q_scale
//     over all of D and dP = dO V^T needs dO over all of D: two resident
//     (hi, lo) strips would take 256 KB at D = 256. So q * q_scale stays
//     the resident strip (the A operand of S), and dO is streamed again
//     with each kv tile as ring entries beside V, K and K transposed: the
//     walk of the dK block with q and K trading places (dO's chunks are
//     this block's rows, V's and K's the tile's). For each kv tile: V and
//     dO chunks in turn (dP, one k-step a chain), K's chunks as loaded (S),
//     then K * k_scale transposed (dQ_c += dS (K * k_scale)_c). 3 D / 64
//     chunk products a kv tile, the floor; the cost of the layout is D /
//     64 more splits a tile (dO's, again) and dO's bytes read again from
//     L2. The other choice, q * q_scale and dO resident as raw f32 strips
//     (128 KB) with each chunk's A fragments split in registers, would put
//     a chunk's 64 fragment registers beside the 224 above. The registers
//     are the dK block's: dQ, dP's tile, S's and a fresh accumulator (224),
//     then dS's (hi, lo) fragments and a fresh accumulator beside dQ.
//
// Shared memory at D = 256 (D = 192): 1024 bytes of alignment, the (hi,
// lo) strip 131,072 (98,304), the ring 98,304 (131,072), 1 KB of per-tile
// values (the forward's and dQ's bias row, dK/dV's LSE and delta, two
// tiles deep) and the barriers: 231,480 (231,496) bytes of 232,448.
//
// The ring. Entry e of the walk lives in slot e % kEntries. Its TMA load
// (16 KB of raw f32 into the entry's hi tile, or into its lo tile when the
// entry is to be transposed) is started by the consumer's first thread as
// soon as the consumer's chains on entry e - kEntries have landed; all 128
// producer threads split each landed entry into its (hi, lo) pair, as
// loaded (split_rows) or transposed (split_transposed: wgmma takes 32-bit
// operands K-major only, so a chunk of V, dO or q whose product contracts
// over its rows is transposed), stage the tile's per-row values with its
// first entry, and announce it (one arrival per producer warp).
//
// Precision. The tensor cores' accumulation truncates to the running
// sum's magnitude. Each chunk's chain runs into a fresh accumulator, added
// in f32, and issues every small term (lo.hi, then hi.lo) before the hi.hi
// terms: the small terms sum while the accumulator is small, and the hi.hi
// chain that truncates against the whole chunk's sum is 8 products long at
// every D (K2's kernels at D = 128: 16 in S, with its small terms apart).
// dP^T goes further, one k-step a chain (add_dp_chunk): where P is 1 (N =
// 1, or a kv column that a sample's queries alone attend), dS = P (dP -
// delta) is rounding noise around 0, and an 8-product chain's truncation
// left dK there at 3-8 times the plain version's error against float64.
// Operands are hi + lo to 2^-22 of their size (f32: 2^-24), so a long sum
// of like-signed terms (dV of such a column: 1568 equal terms at the MCA)
// carries about 2^-22 of its size.
//
// Numerics (those of mh_flash_attention.cu's f32 kernels): q * q_scale in
// f32, the (B, N) bias added after the fold (kv columns >= N score -inf),
// base e, P not rounded, 1 / l dividing the output; dS^T = P^T (dP^T -
// delta) with delta (B, H, N) from the caller (fa.mh_delta); dK needs no
// fix in base e; dQ takes K * k_scale (k times the true scale), scaled
// before its split. Rows past N arrive as zeros from TMA; q rows >= N
// carry +inf LSE in the backward (P = 0) and are never stored.

#pragma once

#include <math.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kChunk = 64;  // columns of a chunk, rows of a tile
constexpr int kChunkElems = kChunk * kChunk;  // floats of a 64 x 64 tile
constexpr int kPairElems = 2 * kChunkElems;   // an entry: hi, then lo
constexpr uint64_t kChunkLo = kChunkElems * 4 >> 4;  // hi -> lo, desc units
constexpr int kWideThreads = 2 * kWarpgroup;  // consumer, then producer
constexpr int kWideProducerBar = 1, kWideConsumerBar = 2;

template <int D>
struct WideF32 {
  static_assert(D == 192 || D == 256, "the strip head dims");
  static constexpr int kC = D / kChunk;       // chunks of a row
  static constexpr int kStrip = kChunk * D;   // floats of a 64 x D tile
  static constexpr uint64_t kStripLo = kStrip * 4 >> 4;
  static constexpr int kEntries = D == 256 ? 3 : 4;
  static constexpr int kSide = 4 * kChunk;    // per-tile values, two deep
  static constexpr size_t smem() {
    return 1024 +
           (size_t)(2 * kStrip + kEntries * kPairElems + kSide) *
               sizeof(float) +
           (2 * kEntries + 1) * sizeof(uint64_t);
  }
};

// The ring of a block: kE entries of (hi, lo) 64 x 64 tiles, each with two
// barriers: landed (its TMA load) and full (split: one arrival per
// producer warp). The consumer refills a slot itself once its chains on
// the slot's entry have landed, so the next load into it starts at once.
template <int kE>
struct WideRing {
  float* entries;
  uint64_t* full;
  uint64_t* landed;
  int n;  // entries of the block's walk

  __device__ __forceinline__ float* entry(int e) const {
    return entries + (e % kE) * kPairElems;
  }
  __device__ __forceinline__ uint32_t parity(int e) const {
    return (e / kE) & 1;
  }
  // Consumer: waits until entry e is split; returns its hi tile.
  __device__ __forceinline__ const float* wait(int e) const {
    mbar_wait(&full[e % kE], parity(e));
    return entry(e);
  }
};

// Starts entry e's TMA load (none past the walk): load(e, hi, bar) puts
// kChunkElems floats into the entry's hi tile hi, or into its lo tile when
// the entry is split transposed, and reports them to bar.
template <int kE, typename Load>
__device__ __forceinline__ void ring_issue(const WideRing<kE>& ring, int e,
                                           Load load) {
  if (e >= ring.n) return;
  uint64_t* bar = &ring.landed[e % kE];
  mbar_expect_tx(bar, kChunkElems * sizeof(float));
  load(e, ring.entry(e), bar);
}

// Consumer: every warp's chains on entries e .. e + count - 1 have landed;
// their slots take entries e + kE, ... (thread 0 starts the loads).
template <int kE, typename Load>
__device__ __forceinline__ void ring_refill(const WideRing<kE>& ring, int e,
                                            int count, Load load) {
  warpgroup_sync(kWideConsumerBar);
  if (threadIdx.x == 0)
    for (int i = 0; i < count; ++i) ring_issue(ring, e + kE + i, load);
}

// The producer's walk: all 128 threads split each landed entry into its
// (hi, lo) pair, as loaded or (transposed(e)) transposed, times mul(e);
// side(e, p) stages per-tile values (thread p of 128) before the entry is
// announced.
template <int kE, typename Transposed, typename Mul, typename Side>
__device__ __forceinline__ void produce(const WideRing<kE>& ring, int p,
                                        Transposed transposed, Mul mul,
                                        Side side) {
  for (int e = 0; e < ring.n; ++e) {
    float* hi = ring.entry(e);
    mbar_wait(&ring.landed[e % kE], ring.parity(e));
    if (transposed(e))
      split_transposed<kChunk, kChunk>(hi + kChunkElems, hi,
                                       hi + kChunkElems, mul(e), p,
                                       kWideProducerBar);
    else
      split_rows<kChunk, kChunk>(hi, hi + kChunkElems, mul(e), p);
    side(e, p);
    fence_proxy_async();
    __syncwarp();
    if ((p & 31) == 0) mbar_arrive(&ring.full[e % kE]);
  }
}

// One chunk's product in 3xTF32 over 8 k-steps into f: every small term
// first (lo.hi, then hi.lo), then the hi.hi terms. a(kk), b(kk): the
// descriptors of k-step kk of the hi tiles; the lo tiles lie lo_a, lo_b
// (descriptor units) further on.
template <typename ADesc, typename BDesc>
__device__ __forceinline__ void chain_ss(float (&f)[8][4], ADesc a, BDesc b,
                                         uint64_t lo_a, uint64_t lo_b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(f, a(kk) + lo_a, b(kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(f, a(kk), b(kk) + lo_b);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss(f, a(kk), b(kk));
}

// The same with A's (hi, lo) fragments in registers.
template <typename BDesc>
__device__ __forceinline__ void chain_rs(float (&f)[8][4],
                                         const uint32_t (&hi)[8][4],
                                         const uint32_t (&lo)[8][4], BDesc b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs(f, lo[kk], b(kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs(f, hi[kk], b(kk) + kChunkLo);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs(f, hi[kk], b(kk));
}

// acc[8 grp .. 8 grp + 7] (64 output columns) += the chain `chain` issues
// into a fresh accumulator, after the wait that lands it.
template <int NT, typename Chain>
__device__ __forceinline__ void add_chunk(float (&acc)[NT][4], int grp,
                                          Chain chain) {
  float f[8][4] = {};
  wgmma_fence();
  chain(f);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(f);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[8 * grp + nt][e] += f[nt][e];
}

// acc (+)= dP^T's chunk, one k-step at a time: each k-step's three
// products into a fresh accumulator (small terms first), summed in f32
// into the chunk's own sum `part`, which goes to acc (= at chunk 0). dP^T
// sets dS = P (dP - delta), which cancels dP's size: where P is 1 (a row
// with one unmasked kv column, or N = 1) dS is rounding noise around 0,
// and a chain that truncates against its running sum makes that noise
// biased and several times f32's; f32 sums of short partial sums keep it
// at f32's.
template <typename ADesc, typename BDesc>
__device__ __forceinline__ void add_dp_chunk(float (&acc)[8][4],
                                             float (&part)[8][4], int c,
                                             ADesc a, BDesc b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    float f[8][4] = {};
    wgmma_fence();
    wgmma_tf32_ss(f, a(kk) + kChunkLo, b(kk));
    wgmma_tf32_ss(f, a(kk), b(kk) + kChunkLo);
    wgmma_tf32_ss(f, a(kk), b(kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(f);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[nt][e] = kk ? part[nt][e] + f[nt][e] : f[nt][e];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = c ? acc[nt][e] + part[nt][e] : part[nt][e];
}

// Descriptor of k-step kk of chunk c of a resident 64 x D strip, and of a
// 64 x 64 entry tile.
template <int D>
__device__ __forceinline__ uint64_t strip_k8(const float* strip, int c,
                                             int kk) {
  return desc_k8<kChunk, D>(strip, 8 * c + kk);
}
__device__ __forceinline__ uint64_t chunk_k8(const float* tile, int kk) {
  return desc_k8<kChunk, kChunk>(tile, kk);
}

// Sets up the barriers (thread 0) and returns the ring of an n-entry walk
// carved out of sE; bars[2 kE] is the resident strip's barrier.
template <int kE>
__device__ __forceinline__ WideRing<kE> wide_ring(float* sE, uint64_t* bars,
                                                  int n) {
  WideRing<kE> r{sE, bars, bars + kE, n};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kE; ++s) {
      mbar_init(&r.full[s], 4);
      mbar_init(&r.landed[s], 1);
    }
    mbar_init(bars + 2 * kE, 1);
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// -------------------------------------------------------------------------
// Forward
// -------------------------------------------------------------------------

// Grid (ceil(N / 64), B * H). One block: 64 query rows of one head against
// all N keys, streamed once in 64-row tiles with an online softmax (base
// e). The walk of kv tile j: K_j's chunks as loaded (entries 2 kC j + c),
// then V_j's chunks transposed (2 kC j + kC + c); K_j's first entry stages
// the tile's bias row (-inf past N).
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    mh_fwd_tf32(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ bias, float* __restrict__ out,
                float* __restrict__ lse, int N, int H, float q_scale) {
  using P = WideF32<D>;
  constexpr int kC = P::kC, kE = P::kEntries;
  extern __shared__ unsigned char wsmem[];
  float* sQ = reinterpret_cast<float*>(smem_1024(wsmem));  // hi, then lo
  float* sE = sQ + 2 * P::kStrip;
  float* sBias = sE + kE * kPairElems;  // [tile parity][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sBias + P::kSide);
  uint64_t* qbar = bars + 2 * kE;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kChunk;
  const int T = (N + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WideRing<kE> ring = wide_ring<kE>(sE, bars, 2 * kC * T);
  auto load = [&](int e, float* hi, uint64_t* bar) {
    const int r = e % (2 * kC);  // K_j chunk r, or V_j chunk r - kC
    tma_f32<kChunk, kChunk, kChunk>(hi + (r < kC ? 0 : kChunkElems),
                                    r < kC ? &tk : &tv, bar,
                                    h * D + kChunk * (r % kC),
                                    e / (2 * kC) * kChunk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, P::kStrip * sizeof(float));
    tma_f32<kChunk, D, kChunk>(sQ, &tq, qbar, h * D, q0, b);
    for (int e = 0; e < kE; ++e) ring_issue(ring, e, load);
  }

  if (warp >= 4) {  // producer
    const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
    produce(
        ring, threadIdx.x - kWarpgroup,
        [&](int e) { return e % (2 * kC) >= kC; },
        [&](int) { return 1.f; },
        [&](int e, int p) {
          const int j = e / (2 * kC);
          if (e % (2 * kC) == 0 && p < kChunk) {
            const int col = j * kChunk + p;
            sBias[(j & 1) * kChunk + p] =
                col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
          }
        });
    return;
  }

  const int r0 = 16 * warp, g = lane >> 2, t = lane & 3;
  mbar_wait(qbar, 0);
  split_rows<kChunk, D>(sQ, sQ + P::kStrip, q_scale, threadIdx.x);
  fence_proxy_async();
  warpgroup_sync(kWideConsumerBar);
  float o[D / 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < T; ++j) {
    const int e0 = 2 * kC * j;
    float sc[8][4] = {};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* kt = ring.wait(e0 + c);
      add_chunk(sc, 0, [&](auto& f) {
        chain_ss(
            f, [&](int kk) { return strip_k8<D>(sQ, c, kk); },
            [&](int kk) { return chunk_k8(kt, kk); }, P::kStripLo, kChunkLo);
      });
      ring_refill(ring, e0 + c, 1, load);
    }
    // the bias after the fold; -inf past N (every tile holds a column < N)
    const float* sb = sBias + (j & 1) * kChunk;
    float mx[2] = {-INFINITY, -INFINITY}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] += (e & 1) ? b2.y : b2.x;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
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
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
    uint32_t ph[8][4], pl[8][4];  // P, unrounded, as (hi, lo)
    acc_to_a(sc, ph, pl);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* vt = ring.wait(e0 + kC + c);  // V_j chunk c, transposed
      add_chunk(o, c, [&](auto& f) {
        chain_rs(f, ph, pl, [&](int kk) { return chunk_k8(vt, kk); });
      });
      fence_frag(ph);
      fence_frag(pl);
      ring_refill(ring, e0 + kC + c, 1, load);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= N) continue;
    float* dst = out + ((size_t)b * N + row) * A + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(
          o[nt][2 * half] / l[half], o[nt][2 * half + 1] / l[half]);
    if (t == 0) lse[(size_t)bh * N + row] = m[half] + logf(l[half]);
  }
}

// -------------------------------------------------------------------------
// dK/dV
// -------------------------------------------------------------------------

// Entries a q tile of the dV block (kDV) and of the dK block walks.
template <int kC, int kRole>
__host__ __device__ constexpr int wide_entries() {
  return kRole == 0 ? 2 * kC : 4 * kC;
}

// The walk of q tile j, entry r of wide_entries(): the dV block (kRole 0)
// reads q * q_scale chunk r as loaded (r < kC), then dO chunk r - kC
// transposed; the dK block (1) V chunk r / 2 and dO chunk r / 2 as loaded
// in turn (r < 2 kC), q * q_scale chunk r - 2 kC as loaded, then chunk
// r - 3 kC transposed. Which tensor: 0 q, 1 v, 2 dO; the chunk; transposed.
// The dQ kernel walks a kv tile as the dK block walks a q tile, with K in
// q's place (tensor 0: K, and K * k_scale when transposed).
struct WideEntry {
  int tensor, chunk;
  bool transposed;
};
template <int kC, int kRole>
__host__ __device__ constexpr WideEntry wide_entry(int r) {
  if (kRole == 0)
    return r < kC ? WideEntry{0, r, false} : WideEntry{2, r - kC, true};
  if (r < 2 * kC) return WideEntry{(r & 1) ? 2 : 1, r / 2, false};
  return r < 3 * kC ? WideEntry{0, r - 2 * kC, false}
                    : WideEntry{0, r - 3 * kC, true};
}

// One role of the dK/dV kernel (see mh_dkv_tf32).
template <int D, int kRole>
__device__ __forceinline__ void dkv_tf32_role(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dst_base, int lddkv, int N, int H, float q_scale,
    unsigned char* wsmem) {
  using P = WideF32<D>;
  constexpr int kC = P::kC, kE = P::kEntries;
  constexpr int kEPT = wide_entries<kC, kRole>();
  float* sK = reinterpret_cast<float*>(smem_1024(wsmem));  // hi, then lo
  float* sE = sK + 2 * P::kStrip;
  float* sStat = sE + kE * kPairElems;  // [tile parity][lse, delta][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sStat + P::kSide);
  uint64_t* kbar = bars + 2 * kE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kChunk;
  const int T = (N + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WideRing<kE> ring = wide_ring<kE>(sE, bars, kEPT * T);
  auto load = [&](int e, float* hi, uint64_t* bar) {
    const WideEntry w = wide_entry<kC, kRole>(e % kEPT);
    // V's chunks are this block's kv rows; q's and dO's the tile's
    tma_f32<kChunk, kChunk, kChunk>(
        hi + (w.transposed ? kChunkElems : 0),
        w.tensor == 0 ? tq : w.tensor == 1 ? tv : tdo, bar,
        h * D + kChunk * w.chunk, w.tensor == 1 ? k0 : e / kEPT * kChunk,
        b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kbar, P::kStrip * sizeof(float));
    tma_f32<kChunk, D, kChunk>(sK, tk, kbar, h * D, k0, b);
    for (int e = 0; e < kE; ++e) ring_issue(ring, e, load);
  }

  if (warp >= 4) {  // producer
    const float* lse_bh = lse + (size_t)bh * N;
    const float* delta_bh = delta + (size_t)bh * N;
    produce(
        ring, threadIdx.x - kWarpgroup,
        [&](int e) { return wide_entry<kC, kRole>(e % kEPT).transposed; },
        [&](int e) {
          return wide_entry<kC, kRole>(e % kEPT).tensor == 0 ? q_scale : 1.f;
        },
        [&](int e, int p) {
          const int j = e / kEPT;
          if (e % kEPT == 0 && p < kChunk) {
            const int row = j * kChunk + p;  // rows >= N: P = 0, dS = 0
            float* st = sStat + (j & 1) * 2 * kChunk;
            st[p] = row < N ? lse_bh[row] : INFINITY;
            st[kChunk + p] = row < N ? delta_bh[row] : 0.f;
          }
        });
    return;
  }

  const int r0 = 16 * warp, g = lane >> 2, t = lane & 3;
  // this block's kv rows >= N are never stored: any finite bias will do
  float brow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + r0 + g + 8 * half;
    brow[half] = (bias && row < N) ? bias[(size_t)b * N + row] : 0.f;
  }
  mbar_wait(kbar, 0);
  split_rows<kChunk, D>(sK, sK + P::kStrip, 1.f, threadIdx.x);
  fence_proxy_async();
  warpgroup_sync(kWideConsumerBar);
  float acc[D / 8][4] = {};  // dV (kRole 0) or dK (1)

  // S^T = K (q * q_scale)^T over the chunks of entries e .. e + kC - 1
  auto scores_t = [&](float (&st)[8][4], int e) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* qt = ring.wait(e + c);
      add_chunk(st, 0, [&](auto& f) {
        chain_ss(
            f, [&](int kk) { return strip_k8<D>(sK, c, kk); },
            [&](int kk) { return chunk_k8(qt, kk); }, P::kStripLo, kChunkLo);
      });
      ring_refill(ring, e + c, 1, load);
    }
  };

  for (int j = 0; j < T; ++j) {
    const int e0 = kEPT * j;
    const float* sl = sStat + (j & 1) * 2 * kChunk;  // lse, then delta
    float st[8][4] = {};
    uint32_t ph[8][4], pl[8][4];  // P^T (dV) or dS^T (dK), as (hi, lo)
    if constexpr (kRole == 0) {
      scores_t(st, e0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(sl + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[nt][e] = expf(st[nt][e] + brow[e >> 1] - ((e & 1) ? l2.y : l2.x));
      }
      acc_to_a(st, ph, pl);
    } else {
      float dpt[8][4], part[8][4];  // dP^T = V dO^T, a chunk's share
      // kept rolled: unrolled, this walk spilled 1.6 KB at D = 192
#pragma unroll 1
      for (int c = 0; c < kC; ++c) {
        const float* vt = ring.wait(e0 + 2 * c);
        const float* ot = ring.wait(e0 + 2 * c + 1);
        add_dp_chunk(
            dpt, part, c, [&](int kk) { return chunk_k8(vt, kk); },
            [&](int kk) { return chunk_k8(ot, kk); });
        ring_refill(ring, e0 + 2 * c, 2, load);
      }
      scores_t(st, e0 + 2 * kC);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(sl + 8 * nt + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(sl + kChunk + 8 * nt + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv =
              expf(st[nt][e] + brow[e >> 1] - ((e & 1) ? l2.y : l2.x));
          dpt[nt][e] = pv * (dpt[nt][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      acc_to_a(dpt, ph, pl);
    }
    // dV_c += P^T dO_c, or dK_c += dS^T (q * q_scale)_c, from the
    // transposed chunks that close the tile's walk
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int e = e0 + kEPT - kC + c;
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
    const int row = k0 + r0 + g + 8 * half;
    if (row >= N) continue;
    float* dst = dst_base + ((size_t)b * N + row) * lddkv + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// Grid (ceil(N / 64), B * H, 2). One block: the 64 kv rows x of one head
// y; z = 0 writes their dV, z = 1 their dK, each streaming every q tile.
// dk and dv at row stride lddkv; delta (B, H, N) from the caller.
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    mh_dkv_tf32(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int lddkv, int N, int H,
                float q_scale) {
  extern __shared__ unsigned char wsmem[];
  if (blockIdx.z == 0)
    dkv_tf32_role<D, 0>(&tq, &tk, &tv, &tdo, bias, lse, delta, dv, lddkv, N,
                        H, q_scale, wsmem);
  else
    dkv_tf32_role<D, 1>(&tq, &tk, &tv, &tdo, bias, lse, delta, dk, lddkv, N,
                        H, q_scale, wsmem);
}

// -------------------------------------------------------------------------
// dQ
// -------------------------------------------------------------------------

// Grid (ceil(N / 64), B * H). One block: the 64 query rows x of one head
// y against all N keys, streamed in 64-row tiles; dQ at row stride lddq;
// delta (B, H, N) from the caller. The walk of kv tile j (kEPT = 4 kC
// entries from e0 = kEPT j, wide_entry<kC, 1> with K for q): V_j and dO
// chunks in turn, K_j's chunks as loaded, then K_j * k_scale's chunks
// transposed; the tile's first entry stages its bias row (-inf past N).
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
    mh_dq_tf32(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ bias, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               int lddq, int N, int H, float q_scale, float k_scale) {
  using P = WideF32<D>;
  constexpr int kC = P::kC, kE = P::kEntries;
  constexpr int kEPT = wide_entries<kC, 1>();
  extern __shared__ unsigned char wsmem[];
  float* sQ = reinterpret_cast<float*>(smem_1024(wsmem));  // hi, then lo
  float* sE = sQ + 2 * P::kStrip;
  float* sBias = sE + kE * kPairElems;  // [tile parity][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sBias + P::kSide);
  uint64_t* qbar = bars + 2 * kE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kChunk;
  const int T = (N + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WideRing<kE> ring = wide_ring<kE>(sE, bars, kEPT * T);
  auto load = [&](int e, float* hi, uint64_t* bar) {
    const WideEntry w = wide_entry<kC, 1>(e % kEPT);
    // dO's chunks are this block's q rows; K's and V's the tile's
    tma_f32<kChunk, kChunk, kChunk>(
        hi + (w.transposed ? kChunkElems : 0),
        w.tensor == 0 ? &tk : w.tensor == 1 ? &tv : &tdo, bar,
        h * D + kChunk * w.chunk, w.tensor == 2 ? q0 : e / kEPT * kChunk,
        b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, P::kStrip * sizeof(float));
    tma_f32<kChunk, D, kChunk>(sQ, &tq, qbar, h * D, q0, b);
    for (int e = 0; e < kE; ++e) ring_issue(ring, e, load);
  }

  if (warp >= 4) {  // producer
    const float* bias_b = bias ? bias + (size_t)b * N : nullptr;
    produce(
        ring, threadIdx.x - kWarpgroup,
        [&](int e) { return wide_entry<kC, 1>(e % kEPT).transposed; },
        [&](int e) {
          return wide_entry<kC, 1>(e % kEPT).transposed ? k_scale : 1.f;
        },
        [&](int e, int p) {
          const int j = e / kEPT;
          if (e % kEPT == 0 && p < kChunk) {
            const int col = j * kChunk + p;
            sBias[(j & 1) * kChunk + p] =
                col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
          }
        });
    return;
  }

  const int r0 = 16 * warp, g = lane >> 2, t = lane & 3;
  float lse_r[2], delta_r[2];  // rows >= N: P = 0, dS = 0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    lse_r[half] = row < N ? lse[(size_t)bh * N + row] : INFINITY;
    delta_r[half] = row < N ? delta[(size_t)bh * N + row] : 0.f;
  }
  mbar_wait(qbar, 0);
  split_rows<kChunk, D>(sQ, sQ + P::kStrip, q_scale, threadIdx.x);
  fence_proxy_async();
  warpgroup_sync(kWideConsumerBar);
  float acc[D / 8][4] = {};  // dQ

  for (int j = 0; j < T; ++j) {
    const int e0 = kEPT * j;
    float dp[8][4], part[8][4];  // dP = dO V^T, a chunk's share
    // kept rolled, as the dK block's walk
#pragma unroll 1
    for (int c = 0; c < kC; ++c) {
      const float* vt = ring.wait(e0 + 2 * c);
      const float* ot = ring.wait(e0 + 2 * c + 1);
      add_dp_chunk(
          dp, part, c, [&](int kk) { return chunk_k8(ot, kk); },
          [&](int kk) { return chunk_k8(vt, kk); });
      ring_refill(ring, e0 + 2 * c, 2, load);
    }
    // S = (q * q_scale) K^T over the chunks
    float sc[8][4] = {};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* kt = ring.wait(e0 + 2 * kC + c);
      add_chunk(sc, 0, [&](auto& f) {
        chain_ss(
            f, [&](int kk) { return strip_k8<D>(sQ, c, kk); },
            [&](int kk) { return chunk_k8(kt, kk); }, P::kStripLo, kChunkLo);
      });
      ring_refill(ring, e0 + 2 * kC + c, 1, load);
    }
    // the bias after the fold (-inf past N); P and dS = P (dP - delta)
    const float* sb = sBias + (j & 1) * kChunk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(sc[nt][e] + ((e & 1) ? b2.y : b2.x) -
                              lse_r[e >> 1]);
        dp[nt][e] = pv * (dp[nt][e] - delta_r[e >> 1]);
      }
    }
    uint32_t ph[8][4], pl[8][4];  // dS, as (hi, lo)
    acc_to_a(dp, ph, pl);
    // dQ_c += dS (K * k_scale)_c, from the transposed chunks
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int e = e0 + 3 * kC + c;
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
    const int row = q0 + r0 + g + 8 * half;
    if (row >= N) continue;
    float* dst = dq + ((size_t)b * N + row) * lddq + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

// A (B, N, A) f32 operand at row stride ld (a multiple of 4: TMA wants
// 16-byte rows) in 32 x 64 boxes.
int wide_map(CUtensorMap* map, const void* base, int B, int N, int A,
             int ld) {
  if (ld % 4) return kBadArgument;
  return tile_map_f32(map, base, A, N, B, ld, (long)N * ld, 32, kChunk);
}

template <int D>
int launch_fwd_tf32(const void* q, const void* k, const void* v,
                    const float* bias, void* out, float* lse, int B, int N,
                    int H, int ldq, int ldk, int ldv, float q_scale,
                    cudaStream_t st) {
  const int A = H * D;
  CUtensorMap tq, tk, tv;
  if (int e = wide_map(&tq, q, B, N, A, ldq)) return e;
  if (int e = wide_map(&tk, k, B, N, A, ldk)) return e;
  if (int e = wide_map(&tv, v, B, N, A, ldv)) return e;
  constexpr size_t smem = WideF32<D>::smem();
  auto kernel = mh_fwd_tf32<D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + kChunk - 1) / kChunk, B * H), kWideThreads, smem, st>>>(
      tq, tk, tv, bias, static_cast<float*>(out), lse, N, H, q_scale);
  return 0;
}

template <int D>
int launch_dkv_tf32(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, int B, int N,
                    int H, int ldq, int ldk, int ldv, int lddkv,
                    float q_scale, cudaStream_t st) {
  const int A = H * D;
  CUtensorMap tq, tk, tv, tdo;
  if (int e = wide_map(&tq, q, B, N, A, ldq)) return e;
  if (int e = wide_map(&tk, k, B, N, A, ldk)) return e;
  if (int e = wide_map(&tv, v, B, N, A, ldv)) return e;
  if (int e = wide_map(&tdo, dout, B, N, A, A)) return e;
  constexpr size_t smem = WideF32<D>::smem();
  auto kernel = mh_dkv_tf32<D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + kChunk - 1) / kChunk, B * H, 2), kWideThreads, smem,
           st>>>(tq, tk, tv, tdo, bias, lse, delta, static_cast<float*>(dk),
                 static_cast<float*>(dv), lddkv, N, H, q_scale);
  return 0;
}

template <int D>
int launch_dq_tf32_wide(const void* q, const void* k, const void* v,
                        const float* bias, const void* dout, const float* lse,
                        const float* delta, void* dq, int B, int N, int H,
                        int ldq, int ldk, int ldv, int lddq, float q_scale,
                        float k_scale, cudaStream_t st) {
  const int A = H * D;
  CUtensorMap tq, tk, tv, tdo;
  if (int e = wide_map(&tq, q, B, N, A, ldq)) return e;
  if (int e = wide_map(&tk, k, B, N, A, ldk)) return e;
  if (int e = wide_map(&tv, v, B, N, A, ldv)) return e;
  if (int e = wide_map(&tdo, dout, B, N, A, A)) return e;
  constexpr size_t smem = WideF32<D>::smem();
  auto kernel = mh_dq_tf32<D>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + kChunk - 1) / kChunk, B * H), kWideThreads, smem, st>>>(
      tq, tk, tv, tdo, bias, lse, delta, static_cast<float*>(dq), lddq, N, H,
      q_scale, k_scale);
  return 0;
}

}  // namespace
