// The f32 forward of K1, K3 and K4 up to head dim 128 for Hopper: products
// in 3xTF32 on wgmma (wgmma_tf32.cuh's splits, descriptors and products),
// fed by TMA. qkv_flash_attention.cu's qkv_attn_fwd runs it for K1 (q, k
// and v the column views of the fused (B, N, 3A) qkv at row stride 3A, no
// bias), mh_flash_attention.cu's mh_attn_fwd for K3 (q at its own row
// stride, k and v the column views of one fused (B, N, 2A) kv, the (B, N)
// kv bias row) and hm_flash_attention.cu's hm_attn_fwd for K4 in two
// passes (its (B H, N, D) planes as B H planes of one head, row stride D).
// It replaces the FMA kernels mh_fwd_f32 (K3) and hm_fwd_f32 (K4) and
// computes what mofo_tpu's _mh_fwd_kernel (mofo_tpu/ops/flash_attention.py
// :460, called by _mh_fwd_impl at :678 for K3 and by _qkv_fwd_impl at
// :1173 for K1) and _fwd_kernel (:130, called by _fwd_impl at :275 for
// K4) compute in f32. Above 128 K3's entry point runs wgmma_tf32_wide.cuh's
// forward (192, 256) and wgmma_tf32_split.cuh's column-split one; K4's
// runs the column-split one in two passes at 192 and 256 too.
//
// What bounds it. S = (q * q_scale) K^T and O += P V are 4 N^2 D FLOP a
// head on N D values of each operand: at N = 1568 it is bound by
// operations, 0.610 ms at the BB-focused MCA's 8 x 128 and 16 x 64 (B =
// 10) and 0.366 ms at the ViT-S decoder's (96, 1568) x 64 at 495 / 3
// TFLOP/s. K4's two passes form S twice: 6 N^2 D FLOP, 0.549 ms there.
//
// The walk. A block owns 64 kWGs query rows of one head (kWGs consumer
// warpgroups of 64 rows: two up to D = 64, one at 128, where two O
// accumulators and two warpgroups' q pairs do not fit) and streams the kv
// tiles once in 64-row tiles with an online softmax (base e). A producer
// warpgroup keeps a ring of kEntries (hi, lo) entries full: its first
// thread starts each tile's TMA load one entry ahead (K_j into entry 2j,
// split in place; V_j into entry 2j + 1's lo tile, split transposed out of
// it: 32-bit wgmma operands are K-major only, and O += P V contracts over
// the tile's rows), and its 128 threads split each landed tile into its
// (hi, lo) TF32 pair. q * q_scale's fragments stay in registers up to D =
// 64 and as a resident (hi, lo) pair in shared memory at 128. P goes from
// the accumulators into the A fragments of P V, split in registers, in the
// K order permuted within groups of 8 that the transposed V tile shares.
//
// The two passes (kTwoPass, K4). The reference normalizes p / l before
// P V (_fwd_kernel), which an online softmax cannot do, so the walk is
// pass 1, K_j alone as entry j (S, the row's m and l, no P V), then pass
// 2, K_j and V_j again as entries T + 2j and T + 2j + 1 (S once more, P
// = exp(s - m) / l, O += P V, no 1 / l at the end): 3 T entries over T
// kv tiles (fwd_entry_f32), the ring and its slots as in one pass. m and
// l stay in registers (two each a thread) between the passes; pass 2
// forms the same S in the same order, so exp(s - m) <= 1. The LSE m +
// log(l) is pass 1's. wgmma_tf32_split.cuh's split_fwd_tf32<NG, true>
// orders its walk the same way (split_fwd_step).
//
// The bias flag (kBias). K3's producer stages the tile's bias row with
// each K entry (bias, or 0 without one, and -inf for kv columns >= N),
// and the consumer adds it to S after the fold, before it releases the
// K slot. K1's and K4's (kBias false) mask columns >= N of the ragged last
// tile in registers and read no row.
//
// The budget (232,448 bytes of shared memory a block; 200 registers a
// consumer thread with two consumer warpgroups and setmaxnreg, 255 with
// one). A 64 x D f32 tile is 256 D bytes; an entry is a (hi, lo) pair of
// them, 512 D bytes, beside kWGs q tiles (one raw tile a warpgroup up to D
// = 64, split into registers; a (hi, lo) pair at 128), the bias rows
// (kEntries x 64 floats: the row of the tile whose K lies in the slot)
// and 3 kEntries + 1 barriers:
//   D = 16: 2 q tiles + 8 entries of 8 KB: 1024 + 73,728 + 2,048 + 200 =
//     77,000 bytes;
//   D = 32: 2 q tiles + 8 entries of 16 KB: 1024 + 147,456 + 2,048 + 200 =
//     150,728;
//   D = 64: 2 q tiles + 5 entries of 32 KB: 1024 + 196,608 + 1,280 + 128 =
//     199,040;
//   D = 128: one (hi, lo) q pair + 2 entries of 64 KB: 1024 + 196,608 +
//     512 + 56 = 198,200. A third entry (64 KB) would not fit; the bias
//     rows (512 bytes) do.
// The two passes take the same shared memory: an entry holds one tile
// (K_j, or V_j), in pass 1 as in pass 2; the ring streams (K) tiles in
// pass 1 and (K, V) tile pairs in pass 2.
// A consumer holds O (D / 2 registers), S and its small terms (32 each),
// then P's (hi, lo) fragments (64) beside O and a fresh accumulator for
// P V's chain (64 output columns: 32): 112 at D = 64 with q's fragments
// (D / 2 each, hi and lo), 160 at 128 (q read from shared memory); in
// two passes O is live in pass 2 alone.
//
// Precision (wgmma_tf32.cuh's note): S sums its small terms (lo.hi,
// hi.lo) in an accumulator of their own, so the hi.hi chain that truncates
// against the running sum is D / 8 products long; P V's chain over the
// tile's 64 rows runs into a fresh accumulator (64 output columns at a
// time), added to O in f32: the tensor cores' accumulation truncates to
// the running sum, so a sum over N runs in registers in f32.
//
// Numerics (_mh_fwd_kernel's in f32, as mh_fwd_f32 had them; K4's
// _fwd_kernel's, as hm_fwd_f32 had them): q times q_scale in f32 as it is
// split; the bias added after the fold; base e; P = exp(s - m) not
// rounded; 1 / l divides the output (K4: P = exp(s - m) / l before P V);
// the LSE m + log(l) a natural log. Rows past N arrive as zeros from TMA
// and are never stored.

#pragma once

#include <math.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kFwdRows = 64;  // rows of every tile (q and kv)

template <int D>
struct FwdF32 {
  static constexpr int kWGs = D == 128 ? 1 : 2;
  static constexpr bool kQInRegs = D <= 64;
  static constexpr int kQTiles = kQInRegs ? 1 : 2;  // a warpgroup's q
  static constexpr int kTE = kFwdRows * D;  // floats of a 64 x D tile
  static constexpr int kEntries = D == 128 ? 2 : D == 64 ? 5 : 8;
  static constexpr int kThreads = (kWGs + 1) * kWarpgroup;
  static constexpr size_t smem() {
    return 1024 +
           (size_t)(kWGs * kQTiles + 2 * kEntries) * kTE * sizeof(float) +
           (size_t)kEntries * kFwdRows * sizeof(float) +
           (3 * kEntries + 1) * sizeof(uint64_t);
  }
};

// Entry e of a block's walk over T kv tiles: K_j (split as loaded) or V_j
// (split transposed). One pass: K_j and V_j are entries 2j and 2j + 1.
// Two passes (kTwoPass): K_j alone is entry j (pass 1), then K_j and V_j
// are entries T + 2j and T + 2j + 1 (pass 2).
struct FwdEntry {
  bool v;
  int j;
};
__host__ __device__ constexpr FwdEntry fwd_entry_f32(bool two_pass, int T,
                                                     int e) {
  return two_pass && e < T
             ? FwdEntry{false, e}
             : FwdEntry{((two_pass ? e - T : e) & 1) != 0,
                        (two_pass ? e - T : e) >> 1};
}

// Grid (ceil(N / (64 kWGs)), B * H). One block: 64 kWGs query rows of one
// head against all N keys. q, k and v through their own tensor maps
// (columns h * D of plane b = y / H; rows past N arrive as zeros); bias (B,
// N) f32 or null (kBias only); out (B, N, H D) contiguous, lse (B H, N).
// One pass (K1, K3): an online softmax, 1 / l dividing the output at the
// end. Two passes (kTwoPass, K4 on (B H, N, D) planes, H = 1): pass 1 the
// row statistics alone (S, no P V), pass 2 P = exp(s - m) / l before P V.
template <int D, bool kBias, bool kTwoPass>
__global__ void __launch_bounds__(FwdF32<D>::kThreads, 1)
    fwd_f32(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ lse, int N, int H, float q_scale) {
  using P = FwdF32<D>;
  constexpr int kTE = P::kTE, kE = P::kEntries, kWGs = P::kWGs;
  extern __shared__ unsigned char wsmem[];
  float* sQ = reinterpret_cast<float*>(smem_1024(wsmem));
  float* sE = sQ + kWGs * P::kQTiles * kTE;  // entry s: hi, then lo
  float* sBias = sE + 2 * kE * kTE;          // [slot][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + kE * kFwdRows);
  uint64_t* empty = full + kE;
  uint64_t* landed = empty + kE;
  uint64_t* qbar = landed + kE;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kWGs * kFwdRows;
  const int T = (N + kFwdRows - 1) / kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kE; ++s) {
      mbar_init(&full[s], kWarpgroup);  // every producer thread
      mbar_init(&empty[s], 4 * kWGs);   // one arrival per consumer warp
      mbar_init(&landed[s], 1);         // the TMA load
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kWGs) {  // producer: loads and splits
    if constexpr (kWGs == 2) producer_registers_f32();
    const int p = threadIdx.x - 4 * kWGs * 32;
    const int n = (kTwoPass ? 3 : 2) * T;
    // entry e's raw tile: K_j into its hi tile (split in place), V_j into
    // its lo tile (split transposed out of it)
    auto issue = [&](int e) {
      const int s = e % kE;
      const FwdEntry w = fwd_entry_f32(kTwoPass, T, e);
      mbar_wait(&empty[s], ((e / kE) & 1) ^ 1);
      mbar_expect_tx(&landed[s], kTE * sizeof(float));
      tma_f32<kFwdRows, D, kFwdRows>(sE + (2 * s + w.v) * kTE,
                                     w.v ? &tv : &tk, &landed[s], h * D,
                                     w.j * kFwdRows, b);
    };
    if (p == 0) {
      mbar_expect_tx(qbar, kWGs * kTE * sizeof(float));
      for (int w = 0; w < kWGs; ++w)
        tma_f32<kFwdRows, D, kFwdRows>(sQ + w * P::kQTiles * kTE, &tq, qbar,
                                       h * D, q0 + kFwdRows * w, b);
      issue(0);
    }
    const float* bias_b = kBias && bias ? bias + (size_t)b * N : nullptr;
    for (int e = 0; e < n; ++e) {
      if (p == 0 && e + 1 < n) issue(e + 1);
      const int s = e % kE;
      const FwdEntry w = fwd_entry_f32(kTwoPass, T, e);
      float* hi = sE + 2 * s * kTE;
      mbar_wait(&landed[s], (e / kE) & 1);
      if (w.v) {
        split_transposed<kFwdRows, D>(hi + kTE, hi, hi + kTE, 1.f, p,
                                      kProducerBar);
      } else {
        split_rows<kFwdRows, D>(hi, hi + kTE, 1.f, p);
        if (kBias && p < kFwdRows) {  // K_j's slot carries tile j's row
          const int col = w.j * kFwdRows + p;
          sBias[s * kFwdRows + p] =
              col < N ? (bias_b ? bias_b[col] : 0.f) : -INFINITY;
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  } else {
    if constexpr (kWGs == 2) consumer_registers_f32();
    const int wg = warp >> 2, r0 = 16 * (warp & 3);
    const int g = lane >> 2, t = lane & 3;
    float* sq = sQ + wg * P::kQTiles * kTE;
    constexpr int KQ = P::kQInRegs ? D / 8 : 1;
    uint32_t qh[KQ][4], ql[KQ][4];
    mbar_wait(qbar, 0);
    if constexpr (P::kQInRegs) {
      load_a_tf32<D>(qh, ql, sq, r0, q_scale);
    } else {
      split_rows<kFwdRows, D>(sq, sq + kTE, q_scale, threadIdx.x & 127);
      fence_proxy_async();
      warpgroup_sync(2 + wg);
    }
    float o[D / 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S of kv tile j from entry e (K_j's), K_j's slot released after it:
    // the bias after the fold (-inf past N), or without a bias row the
    // ragged last tile's columns past N at -inf
    auto scores = [&](float (&sc)[8][4], int e, int j) {
      const int sk = e % kE;
      const float* kt = sE + 2 * sk * kTE;  // K hi, K lo
      float sc_small[8][4] = {};
      mbar_wait(&full[sk], (e / kE) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t b_hi = desc_k8<kFwdRows, D>(kt, kk);
        const uint64_t b_lo = desc_k8<kFwdRows, D>(kt + kTE, kk);
        if constexpr (P::kQInRegs)
          mma3_rs(sc, sc_small, qh[kk], ql[kk], b_hi, b_lo);
        else
          mma3_ss(sc, sc_small, desc_k8<kFwdRows, D>(sq, kk),
                  desc_k8<kFwdRows, D>(sq + kTE, kk), b_hi, b_lo);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(sc_small);
      add_small(sc, sc_small);
      if constexpr (P::kQInRegs) {
        fence_frag(qh);
        fence_frag(ql);
      }
      if constexpr (kBias) {  // the bias after the fold, -inf past N
        const float* sb = sBias + sk * kFwdRows;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(sb + 8 * nt + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] += (i & 1) ? b2.y : b2.x;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sk]);
      if (!kBias && (j + 1) * kFwdRows > N) {  // the ragged last tile
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (j * kFwdRows + 8 * nt + 2 * t + (i & 1) >= N)
              sc[nt][i] = -INFINITY;
      }
    };
    // O += P V_j from entry e (V_j's transposed pair), V_j's slot released
    // after it; P unrounded, as (hi, lo) A fragments
    auto accumulate = [&](const float (&sc)[8][4], int e) {
      const int sv = e % kE;
      const float* vt = sE + 2 * sv * kTE;  // V^T hi, V^T lo
      uint32_t ph[8][4], pl[8][4];
      acc_to_a(sc, ph, pl);
      mbar_wait(&full[sv], (e / kE) & 1);
      add_fresh<D>(o, [&](auto& f, uint64_t off) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          mma3_rs(f, ph[kk], pl[kk], desc_k8<D, kFwdRows>(vt, kk) + off,
                  desc_k8<D, kFwdRows>(vt + kTE, kk) + off);
      });
      fence_frag(ph);
      fence_frag(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sv]);
    };

    // the online softmax: the whole forward in one pass, or pass 1's row
    // statistics alone
    for (int j = 0; j < T; ++j) {
      const int e = kTwoPass ? j : 2 * j;
      float sc[8][4] = {};
      scores(sc, e, j);
      float mx[2] = {-INFINITY, -INFINITY}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds at least one valid column, so the max is finite
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[nt][i] = expf(sc[nt][i] - m[i >> 1]);
          rs[i >> 1] += sc[nt][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
      if constexpr (!kTwoPass) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[nt][i] *= corr[i >> 1];
        accumulate(sc, e + 1);
      }
    }
    if constexpr (kTwoPass) {
      for (int j = 0; j < T; ++j) {  // pass 2: P = exp(s - m) / l, P V
        const int e = T + 2 * j;
        float sc[8][4] = {};
        scores(sc, e, j);  // the same S as pass 1's, in the same order
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sc[nt][i] = expf(sc[nt][i] - m[i >> 1]) / l[i >> 1];
        accumulate(sc, e + 1);
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + kFwdRows * wg + r0 + g + 8 * half;
      if (row >= N) continue;
      float* dst = out + ((size_t)b * N + row) * A + h * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(dst + 8 * nt) =
            kTwoPass ? make_float2(o[nt][2 * half], o[nt][2 * half + 1])
                     : make_float2(o[nt][2 * half] / l[half],
                                   o[nt][2 * half + 1] / l[half]);
      if (t == 0) lse[(size_t)bh * N + row] = m[half] + logf(l[half]);
    }
  }
}

// The f32 forward at head dim D (16, 32, 64, 128): q, k and v (B, N, H D)
// at row strides ldq, ldk, ldv (multiples of 4: TMA wants 16-byte rows),
// each in boxes of sub_cols<D>() columns and 64 rows; bias (B, N) or null
// with kBias (K3), none without (K1, K4); kTwoPass: K4's two passes (q, k,
// v its (B H, N, D) planes: B = B H, H = 1, row stride D). Returns 0,
// kBadArgument or a cudaError_t from the set-up.
template <int D, bool kBias, bool kTwoPass = false>
int launch_fwd_f32(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int B, int N,
                   int H, int ldq, int ldk, int ldv, float q_scale,
                   cudaStream_t st) {
  using P = FwdF32<D>;
  const int A = H * D;
  const void* base[3] = {q, k, v};
  const int ld[3] = {ldq, ldk, ldv};
  CUtensorMap m[3];
  for (int i = 0; i < 3; ++i) {
    if (ld[i] % 4) return kBadArgument;
    if (int e = tile_map_f32(&m[i], base[i], A, N, B, ld[i], (long)N * ld[i],
                             sub_cols<D>(), kFwdRows))
      return e;
  }
  constexpr size_t smem = P::smem();
  auto kernel = fwd_f32<D, kBias, kTwoPass>;
  if (int e = max_smem((const void*)kernel, smem)) return e;
  kernel<<<dim3((N + P::kWGs * kFwdRows - 1) / (P::kWGs * kFwdRows), B * H),
           P::kThreads, smem, st>>>(m[0], m[1], m[2], kBias ? bias : nullptr,
                                    static_cast<float*>(out), lse, N, H,
                                    q_scale);
  return 0;
}

}  // namespace
