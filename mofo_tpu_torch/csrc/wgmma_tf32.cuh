// Hopper building blocks of the f32 attention kernels on the tensor cores
// (qkv_flash_attention.cu's K1 forward and K2 dK/dV in f32 up to head dim
// 128, wgmma_tf32_dq.cuh's dQ of K3 and K2 up to 128, and
// wgmma_tf32_wide.cuh's K3 forward, dK/dV and dQ at 192 and 256, which
// K1/K2 reach through K3's entry points): products in 3xTF32 on wgmma, f32
// tiles loaded by TMA, the passes that split a tile into its TF32 parts,
// and the blocks' register split and fresh-accumulator chains. Everything
// is in an anonymous namespace: each source that includes it gets its own
// copy.
//
// 3xTF32. wgmma takes f32 operands as TF32 (10 explicit mantissa bits), at
// 495 TFLOP/s dense against 67 TFLOP/s for f32 FMAs. Each operand x is
// split into hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32: round to
// nearest, ties away), and a product x y is taken as lo.hi + hi.lo + hi.hi
// in f32, the small terms first: three TF32 products whose result is as
// accurate as the f32 one (the dropped lo.lo term and the rounding of lo
// are about 2^-22 of x y), at up to 495 / 3 = 165 TFLOP/s. The tensor
// cores' own accumulation truncates to the running sum's magnitude, so the
// kernels keep each chain of products short: a sum over N runs in
// registers in f32, one tile's chain at a time, and a score chain over D
// may sum its small terms apart (mma3_rs / mma3_ss with two accumulators).
//
// K-major only. For 32-bit types wgmma has no transpose: A and B are both
// read with the contraction (K) index contiguous. A tile loaded as it lies
// in memory (rows of D f32 values) is K-major for a product that contracts
// over D (S = Q K^T, S^T = K Q^T, dP^T = V dO^T); a product that contracts
// over the tile's rows (O += P V, dV += P^T dO, dK += dS^T Q) needs the
// tile transposed, which split_transposed writes.
//
// Layout. A K-major tile of R rows and C f32 columns is C / W sub-tiles of
// R x W (W = 32, 128-byte rows; W = C = 16: 64-byte rows), one after the
// other, each with the TMA swizzle of its row width (16-byte chunk c of row
// r at c ^ (r % 8) at 128 bytes, c ^ ((r / 2) % 4) at 64): what a TMA load
// of R x W boxes writes, and what a wgmma descriptor with the same swizzle
// reads (a k-step of 8 f32 values is 32 bytes, as a bf16 k-step of 16).
//
// The A operand from registers. A P (or P^T, dS^T) accumulator goes into
// the A fragments of the next product without a shuffle: a thread's
// accumulator holds columns 2t and 2t + 1 of each group of 8, where the
// TF32 A fragment wants columns t and t + 4. So the K index of those
// products is permuted within each group of 8 (perm8: position t holds
// column 2t, position t + 4 column 2t + 1), in the A fragments and in the
// rows of the transposed B tile alike; the contraction is the same sum.

#pragma once

#include "wgmma_tiles.cuh"  // mbarriers, TMA, desc_kmajor, host helpers

namespace {

// --- the split ---------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (about 2^-22 x), hi and lo TF32 values (low 13 bits 0).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// --- K-major f32 tiles ---------------------------------------------------------

// f32 values in a row of one sub-tile of a tile of C columns.
template <int C>
__host__ __device__ constexpr int sub_cols() {
  static_assert(C == 16 || C % 32 == 0, "16 or a multiple of 32 columns");
  return C < 32 ? C : 32;
}

// The index (in floats) of element (r, c) of an R x C K-major tile.
template <int R, int C>
__device__ __forceinline__ int kmaj_index(int r, int c) {
  constexpr int W = sub_cols<C>(), RB = 4 * W;
  const int swz = ((r * RB) >> 7) & (RB / 16 - 1);
  return (c / W) * R * W + r * W + ((((c % W) >> 2) ^ swz) << 2) + (c & 3);
}

// The descriptor of k-step kk (columns 8 kk .. 8 kk + 7) of an R x C
// K-major tile, as A (R = 64) or as B (R = the product's N).
template <int R, int C>
__device__ __forceinline__ uint64_t desc_k8(const float* tile, int kk) {
  constexpr int W = sub_cols<C>(), KS = W / 8;
  return desc_kmajor<4 * W>(tile + (kk / KS) * R * W, kk % KS);
}

// The position of column k within its group of 8 in the permuted K order
// of the products whose A operand comes from an accumulator.
__device__ __forceinline__ int perm8(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1);
}

// The accumulator value of column group kk that A fragment word i takes:
// words 0-3 are (row g, position t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// and position t holds column 2t (c[kk][0], c[kk][2]), t + 4 column 2t + 1.
__device__ __forceinline__ constexpr int acc_of_word(int i) {
  return i == 1 ? 2 : i == 2 ? 1 : i;
}

// The hi and lo A fragments of an accumulator c (K = 8 KS permuted
// columns).
template <int KS>
__device__ __forceinline__ void acc_to_a(const float (&c)[KS][4],
                                         uint32_t (&hi)[KS][4],
                                         uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32_split(c[kk][acc_of_word(i)], hi[kk][i], lo[kk][i]);
}

// The hi and lo A fragments of rows [r0, r0 + 16) of a 64 x C K-major tile
// (K = C in order), each value times mul first.
template <int C>
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[C / 8][4],
                                            uint32_t (&lo)[C / 8][4],
                                            const float* tile, int r0,
                                            float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < C / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32_split(tile[kmaj_index<64, C>(r0 + g + 8 * (i & 1),
                                        8 * kk + t + 4 * (i >> 1))] * mul,
                 hi[kk][i], lo[kk][i]);
}

// Ties fragment registers to the preceding wgmma wait: an asynchronous
// product reads them until then.
template <int KS>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// --- the f32 kernels' blocks -----------------------------------------------------

// 104 registers a producer thread, 200 a consumer thread: 104 x 128 + 200
// x 256 = 168 x 384. A transposed split holds 32 values across its barrier
// and their addresses: at D = 64 a producer spilled 68-260 bytes with 40 to
// 88 registers, none with 104; the consumers need fewer than 200.
__device__ __forceinline__ void producer_registers_f32() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers_f32() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
}

// The output columns of one product chain into a fresh accumulator: all D
// up to 64, 64 at D = 128 (two chains, one per 64-row half of the B tile).
template <int D>
__host__ __device__ constexpr int chain_cols() {
  return D < 64 ? D : 64;
}

// acc[64 g / 8 + ...] += the product chain of `chain` into a fresh f32
// accumulator (chain(t, desc_offset) issues it; desc_offset moves B's
// descriptors to the rows of group g), group by group of chain_cols<D>()
// output columns: the tensor cores' own accumulation truncates, so a long
// sum (over N) runs in registers in f32, and each chain sums only one
// tile's products.
template <int D, typename Chain>
__device__ __forceinline__ void add_fresh(float (&acc)[D / 8][4],
                                          Chain chain) {
  constexpr int NG = chain_cols<D>() / 8;
#pragma unroll
  for (int grp = 0; grp < D / 8 / NG; ++grp) {
    float t[NG][4] = {};
    wgmma_fence();
    chain(t, (uint64_t)grp * (kTileRows * 128 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t);
#pragma unroll
    for (int nt = 0; nt < NG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[grp * NG + nt][e] += t[nt][e];
  }
}

constexpr int kProducerBar = 1;  // named barriers: 1, and 2 + warpgroup

// --- the split passes (one warpgroup: index p in [0, 128)) -------------------

// An R x C tile in place: each value x (times mul) becomes hi, and lo goes
// to the same place of `lo`. Element-wise, so the swizzle does not matter.
template <int R, int C>
__device__ __forceinline__ void split_rows(float* hi, float* lo, float mul,
                                           int p) {
#pragma unroll 4
  for (int i = p; i < R * C / 4; i += kWarpgroup) {
    const float4 x = reinterpret_cast<const float4*>(hi)[i];
    uint4 h, l;
    tf32_split(x.x * mul, h.x, l.x);
    tf32_split(x.y * mul, h.y, l.y);
    tf32_split(x.z * mul, h.z, l.z);
    tf32_split(x.w * mul, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// The R x C K-major tile `raw` (times mul) transposed into the C x R
// K-major tiles hi_t and lo_t, its R index permuted (perm8). raw may be
// lo_t: each thread holds its R C / 512 float4 chunks in registers across
// barrier `bar` of the warpgroup. Lanes walk down the rows of raw, so both
// the reads (swizzled chunks) and the writes (one row of the transposed
// tile) are free of bank conflicts.
template <int R, int C>
__device__ __forceinline__ void split_transposed(const float* raw,
                                                 float* hi_t, float* lo_t,
                                                 float mul, int p, int bar) {
  constexpr int kChunks = R * C / 4 / kWarpgroup;
  static_assert(kChunks * 4 * kWarpgroup == R * C, "whole chunks");
  float4 v[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int q = p + kWarpgroup * i, r = q % R, c = 4 * (q / R);
    v[i] = *reinterpret_cast<const float4*>(raw + kmaj_index<R, C>(r, c));
  }
  warpgroup_sync(bar);  // raw (lo_t) is read before it is written
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int q = p + kWarpgroup * i, r = perm8(q % R), c = 4 * (q / R);
    const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      tf32_split(x[e] * mul, h, l);
      const int o = kmaj_index<C, R>(c + e, r);
      reinterpret_cast<uint32_t*>(hi_t)[o] = h;
      reinterpret_cast<uint32_t*>(lo_t)[o] = l;
    }
  }
}

// --- TMA ---------------------------------------------------------------------------

// Rows [row, row + R) x columns [col, col + C) of plane `plane` of `map`
// (boxes of sub_cols<C>() columns and kBoxRows rows) into the R x C tile
// dst; rows past the tensor's extent arrive as zeros.
template <int R, int C, int kBoxRows>
__device__ __forceinline__ void tma_f32(float* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int plane) {
  constexpr int W = sub_cols<C>();
#pragma unroll
  for (int s = 0; s < C / W; ++s)
#pragma unroll
    for (int rr = 0; rr < R / kBoxRows; ++rr)
      tma_tile(dst + s * R * W + rr * kBoxRows * W, map, bar, col + s * W,
               row + rr * kBoxRows, plane);
}

// --- wgmma m64nNk8 .tf32 ---------------------------------------------------------

#define TF32_ACC2(c, o)                                                   \
  "+f"(c[o][0]), "+f"(c[o][1]), "+f"(c[o][2]), "+f"(c[o][3]),             \
      "+f"(c[o + 1][0]), "+f"(c[o + 1][1]), "+f"(c[o + 1][2]),            \
      "+f"(c[o + 1][3])
#define TF32_ACC4(c, o) TF32_ACC2(c, o), TF32_ACC2(c, o + 2)
#define TF32_ACC8(c, o) TF32_ACC4(c, o), TF32_ACC4(c, o + 4)
#define TF32_D8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF32_D16 TF32_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF32_D32                                                          \
  TF32_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
           "%28, %29, %30, %31"

// c[O, O + NT') += a (64 x 8 from registers) . B (N x 8 from shared memory,
// K-major through desc), N = 8 NT' (16, 32 or 64).
template <int O, int NT>
__device__ __forceinline__ void wgmma_tf32_rs64(float (&c)[NT][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" TF32_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF32_ACC8(c, O)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&c)[4][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" TF32_D16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TF32_ACC4(c, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&c)[2][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{" TF32_D8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : TF32_ACC2(c, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&c)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_tf32_rs64<0>(c, a, desc);
}

// N = 128 as two n = 64 products, the second on B's rows 64..127 (the B
// tiles of this width have 128-byte rows: 8 KB further on).
__device__ __forceinline__ void wgmma_tf32_rs(float (&c)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_tf32_rs64<0>(c, a, desc);
  wgmma_tf32_rs64<8>(c, a, desc + (64 * 128 >> 4));
}

// c += A . B, A (64 x 8) K-major from shared memory through desc_a.
__device__ __forceinline__ void wgmma_tf32_ss(float (&c)[8][4],
                                              uint64_t desc_a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" TF32_D32 "}, %32, %33, p, 1, 1;\n}\n"
      : TF32_ACC8(c, 0)
      : "l"(desc_a), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&c)[4][4],
                                              uint64_t desc_a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" TF32_D16 "}, %16, %17, p, 1, 1;\n}\n"
      : TF32_ACC4(c, 0)
      : "l"(desc_a), "l"(desc), "r"(1));
}

#undef TF32_ACC2
#undef TF32_ACC4
#undef TF32_ACC8
#undef TF32_D8
#undef TF32_D16
#undef TF32_D32

// One k-step in 3xTF32: c += lo.hi + hi.lo + hi.hi, A from registers.
template <int NT>
__device__ __forceinline__ void mma3_rs(float (&c)[NT][4],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4],
                                        uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32_rs(c, lo, b_hi);
  wgmma_tf32_rs(c, hi, b_lo);
  wgmma_tf32_rs(c, hi, b_hi);
}

// The same with A from shared memory.
template <int NT>
__device__ __forceinline__ void mma3_ss(float (&c)[NT][4], uint64_t a_hi,
                                        uint64_t a_lo, uint64_t b_hi,
                                        uint64_t b_lo) {
  wgmma_tf32_ss(c, a_lo, b_hi);
  wgmma_tf32_ss(c, a_hi, b_lo);
  wgmma_tf32_ss(c, a_hi, b_hi);
}

// mma3_rs with the small terms summed in an accumulator of their own,
// added to c after the chain: the tensor cores' accumulation truncates to
// the running sum's magnitude, so a chain over a long contraction (the
// scores over D) keeps its hi.hi sum a third as long.
template <int NT>
__device__ __forceinline__ void mma3_rs(float (&c)[NT][4],
                                        float (&small)[NT][4],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4],
                                        uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32_rs(small, lo, b_hi);
  wgmma_tf32_rs(small, hi, b_lo);
  wgmma_tf32_rs(c, hi, b_hi);
}

// mma3_rs with its small terms apart, A from shared memory.
template <int NT>
__device__ __forceinline__ void mma3_ss(float (&c)[NT][4],
                                        float (&small)[NT][4], uint64_t a_hi,
                                        uint64_t a_lo, uint64_t b_hi,
                                        uint64_t b_lo) {
  wgmma_tf32_ss(small, a_lo, b_hi);
  wgmma_tf32_ss(small, a_hi, b_lo);
  wgmma_tf32_ss(c, a_hi, b_hi);
}

// c += small, after the wait that lands both.
template <int NT>
__device__ __forceinline__ void add_small(float (&c)[NT][4],
                                          const float (&small)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] += small[i][j];
}

// --- host: f32 tensor maps -----------------------------------------------------

// Swizzled boxes of box_cols x box_rows f32 values of a tensor of `planes`
// planes of `rows` rows of `cols` values (row stride `ld`, plane stride
// `plane`, in elements); box_cols 32 (128-byte swizzle) or 16 (64-byte).
// Rows >= `rows` read as zeros. Returns 0 or a negative error.
int tile_map_f32(CUtensorMap* map, const void* base, long cols, long rows,
                 long planes, long ld, long plane, int box_cols,
                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kNoTensorMapEntry;
  if (box_cols != 32 && box_cols != 16) return kBadTensorMap;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)plane * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

}  // namespace
