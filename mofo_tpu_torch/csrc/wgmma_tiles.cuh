// Hopper building blocks of every bf16 attention kernel (the forwards of
// qkv_flash_attention.cu (K1), mh_flash_attention.cu (K3) and
// hm_flash_attention.cu (K4), the strip kernels of wgmma_attn_wide.cuh and,
// through wgmma_attn_bwd.cuh, the K2, K4 and K3 backwards at head dims up
// to 128): TMA tile
// loads into a ring of shared-memory stages with mbarrier completion,
// warpgroup products
// (wgmma.mma_async m64n64k16, A from registers or shared memory, B from
// 128-byte-swizzled shared memory), the host-side tensor maps and the launch
// helpers every source shares. Everything is in an anonymous namespace: each
// source that includes it gets its own copy.
//
// Tiles are 64 rows x 64 bf16 columns (128 bytes a row), written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r lies at chunk
// c ^ (r % 8), in 1024-byte atoms of 8 rows. A tile is read by wgmma either
// K-major (the row index is the product's N, the 64 columns its contraction:
// B = K^T of S = Q K^T) or MN-major (the rows are the contraction: B = V of
// O = P V), which the descriptor and the trans-b flag select.
//
// Every family also takes head dims 16 and 32 (hm_flash_attention.cu,
// qkv_flash_attention.cu, mh_flash_attention.cu): their tiles are then 64
// rows of 32 or 64 bytes, written with the 32- or 64-byte swizzle (chunk c of the 16-byte chunks at
// byte offset o lies at c ^ ((o >> 7) & (row bytes / 16 - 1)), atoms of 8
// rows of 256 or 512 bytes). Every piece below that depends on the row width
// takes the tile's row bytes (kRowBytes, 2 D) or the count of 16-column
// k-steps (D / 16) as a template parameter, whose default, or whose only
// instantiation from the 64-column callers, is the 128-byte code these
// pieces had before.
//
// A head dim above 64 is wider than one 128-byte swizzle atom: a 64 x D
// tile is then D / 64 sub-tiles of 64 x 64 (8 KB each, one after the
// other), each loaded by its own TMA box. The *_d helpers at the end take
// the head dim D: at D <= 64 they are the one-tile calls above; above it a
// contraction over D runs k-steps 4s..4s+3 on sub-tile s, and (D = 128) a
// product whose N is D (P.V) runs one n = 64 product a sub-tile into its
// half of the accumulator.
//
// Every family is built for the head dims 16, 32, 64, 128, 192 and 256
// (by_head_dim at the end) and takes any multiple of 64 above 256 at run
// time (wgmma_attn_split.cuh's column-split kernels); its wrapper pads any
// other D with zero columns to the next of them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is reached
                   // through cudaGetDriverEntryPoint, so nothing new is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;                // rows of every TMA tile
constexpr int kTileBytes = kTileRows * 128;  // 64 x 64 bf16
constexpr int kTileElems = kTileRows * 64;

// A 64-row tile of D bf16 columns (D in {16, 32} or a multiple of 64).
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTileRows * 2 * D;
}
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kTileRows * D;
}
// The columns of one TMA box and swizzle atom of such a tile: D up to 64,
// else 64 (D / 64 sub-tiles of 64 columns).
template <int D>
__host__ __device__ constexpr int box_cols() {
  return D < 64 ? D : 64;
}
constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Block layout: kWG consumer warpgroups (one 64-row wgmma strip each) and
// one producer warpgroup, whose first warp issues the loads. ptxas gives a
// warpgroup kernel of 384 threads 168 registers a thread; the producer
// hands its share to the consumers (setmaxnreg), 40 + 2 x 232 = 3 x 168.
constexpr int kWG = 2;
constexpr int kHopperThreads = (kWG + 1) * kWarpgroup;

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the 1024 bytes a swizzled tile
// needs (the launch asks for 1024 bytes more than the layout).
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Makes this thread's writes to shared memory visible to the async proxy
// (wgmma and TMA read shared memory through it); a barrier among the
// writers and the readers follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads') among the 128 threads of one
// warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// --- TMA -------------------------------------------------------------------

// The 64 x 64 box at (column c0, row c1, plane c2) of `map` into dst;
// completion (its bytes) is reported to bar. Rows past the tensor's extent
// arrive as zeros.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled operand whose rows are
// kRowBytes (128, 64 or 32) long: start address, leading and stride byte
// offsets (16-byte units), layout 1, 2 or 3 = 128-, 64- or 32-byte swizzle.
// The stride between 8-row atoms is 8 rows in both majors; the leading
// offset is unused at one atom's width (64 columns at 128 bytes, D at D).
template <int kRowBytes = 128>
__device__ __forceinline__ uint64_t desc_sw(const void* tile, uint32_t lbo) {
  static_assert(kRowBytes == 128 || kRowBytes == 64 || kRowBytes == 32,
                "rows of 128, 64 or 32 bytes");
  constexpr uint64_t layout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)lbo << 16) | ((uint64_t)(8 * kRowBytes >> 4) << 32) |
         (layout << 62);
}

// B = tile^T, contraction over the tile's columns (S = Q K^T): k-step kk
// starts 32 bytes further along the row.
template <int kRowBytes = 128>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  return desc_sw<kRowBytes>(tile, 1) + (uint64_t)(2 * kk);
}

// B = tile, contraction over the tile's rows (O = P V): k-step kk starts 16
// rows (16 kRowBytes bytes) further down.
template <int kRowBytes = 128>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  return desc_sw<kRowBytes>(tile, 8 * kRowBytes >> 4) +
         (uint64_t)(kRowBytes * kk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A pair of f32 values rounded to bf16 and packed (low half first), and
// the two halves back as f32.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Ties the accumulator registers to the preceding wait, so that no read of
// them is scheduled before the product lands.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(c[i][j])::"memory");
}

// c (64 x 64, f32, this warp's 16 rows as mma.sync's accumulator layout)
// += a (64 x 16 bf16 from registers, mma.sync's A fragment layout) . B (16 x
// 64 from shared memory through desc). kTransB: 0 for a K-major B, 1 for an
// MN-major one.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&c)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

// The same product at n = 32 and n = 16 (c holds a warp's 16 x 32 or 16 x
// 16 accumulator): the P.V-shaped products at head dims 32 and 16.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&c)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&c)[2][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

// The same product with A (64 x 16) also from shared memory, K-major
// through desc_a.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&c)[8][4], uint64_t desc_a,
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "l"(desc_a), "l"(desc), "r"(1), "n"(kTransB));
}

// c += a (64 x 16 KS from registers, KS k-steps) . B, B read from the
// swizzled tile of kRowBytes-long rows (K-major: KS = kRowBytes / 32;
// MN-major: the tile's 16 KS rows, n = 8 NT = kRowBytes / 2): the whole
// product on one tile, committed and waited for.
template <int kTransB, int kRowBytes = 128, int NT, int KS>
__device__ __forceinline__ void wgmma_tile(float (&c)[NT][4],
                                           const uint32_t (&a)[KS][4],
                                           const void* tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<kTransB>(c, a[kk], kTransB ? desc_mnmajor<kRowBytes>(tile, kk)
                                        : desc_kmajor<kRowBytes>(tile, kk));
}

// c (n = 64) += A . B with A the 64-row tile a_tile (its kRowBytes / 2
// columns the contraction) read from shared memory: for a product whose A
// operand is used once.
template <int kTransB, int kRowBytes = 128>
__device__ __forceinline__ void wgmma_tile_ss(float (&c)[8][4],
                                              const void* a_tile,
                                              const void* tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRowBytes / 32; ++kk)
    wgmma_ss<kTransB>(c, desc_kmajor<kRowBytes>(a_tile, kk),
                      kTransB ? desc_mnmajor<kRowBytes>(tile, kk)
                              : desc_kmajor<kRowBytes>(tile, kk));
}

// A fragments (k = 16 KS: KS k-steps of 16) of rows [r0, r0 + 16) of a
// swizzled tile of 32 KS-byte rows (KS = 8: two 128-byte-row sub-tiles, one
// after the other, k-steps 4-7 in the second), r0 a multiple of 8. With
// mul != 1 each value is multiplied by mul and rounded to bf16 (the scale
// fold).
template <int KS>
__device__ __forceinline__ void load_a_sw(uint32_t (&a)[KS][4],
                                          const __nv_bfloat16* tile, int r0,
                                          float mul) {
  constexpr int kRowBytes = KS < 4 ? 32 * KS : 128, kSteps = kRowBytes / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // i: row + 8 (bit 0), column + 8 (bit 1)
      const int row = r0 + g + 8 * (i & 1);
      const int chunk = 2 * (kk % kSteps) + (i >> 1);
      // the swizzle: address bits 7.. xor into the chunk index (row % 8 at
      // 128-byte rows)
      const int swz = ((row * kRowBytes) >> 7) & (kRowBytes / 16 - 1);
      uint32_t v = *reinterpret_cast<const uint32_t*>(
          base + (kk / kSteps) * kTileRows * kRowBytes + row * kRowBytes +
          ((chunk ^ swz) << 4) + 4 * t);
      if (mul != 1.f) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v));
        const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * mul, f.y * mul);
        v = *reinterpret_cast<const uint32_t*>(&r);
      }
      a[kk][i] = v;
    }
}

// Reductions over the 4 threads that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stores rows [r0, r0 + 16) of a warp's 16 x 8 NT accumulator (times mul)
// as bf16 at dst + row * ld, rows >= n skipped.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* dst, size_t ld,
                                          const float (&c)[NT][4], int r0,
                                          int n, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * ld + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(c[nt][2 * half] * mul,
                                c[nt][2 * half + 1] * mul);
  }
}

// --- head dim D: one tile, or D / 64 sub-tiles above 64 -----------------

// c[8 kHalf, 8 kHalf + 8) (a warp's 16 x 64 half of a 16 x 128
// accumulator) += a . B: the n = 64 product of wgmma_rs on one half.
template <int kTransB, int kHalf>
__device__ __forceinline__ void wgmma_rs_half(float (&c)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  constexpr int o = 8 * kHalf;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(c[o][0]), "+f"(c[o][1]), "+f"(c[o][2]), "+f"(c[o][3]),
        "+f"(c[o + 1][0]), "+f"(c[o + 1][1]), "+f"(c[o + 1][2]),
        "+f"(c[o + 1][3]), "+f"(c[o + 2][0]), "+f"(c[o + 2][1]),
        "+f"(c[o + 2][2]), "+f"(c[o + 2][3]), "+f"(c[o + 3][0]),
        "+f"(c[o + 3][1]), "+f"(c[o + 3][2]), "+f"(c[o + 3][3]),
        "+f"(c[o + 4][0]), "+f"(c[o + 4][1]), "+f"(c[o + 4][2]),
        "+f"(c[o + 4][3]), "+f"(c[o + 5][0]), "+f"(c[o + 5][1]),
        "+f"(c[o + 5][2]), "+f"(c[o + 5][3]), "+f"(c[o + 6][0]),
        "+f"(c[o + 6][1]), "+f"(c[o + 6][2]), "+f"(c[o + 6][3]),
        "+f"(c[o + 7][0]), "+f"(c[o + 7][1]), "+f"(c[o + 7][2]),
        "+f"(c[o + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(kTransB));
}

// The 64-row tile of D columns at (column c0, row c1, plane c2) of `map`
// (boxes of box_cols<D>() columns) into dst: one box up to D = 64, D / 64
// above.
template <int D>
__device__ __forceinline__ void tma_tile_d(bf16* dst, const CUtensorMap* map,
                                           uint64_t* bar, int c0, int c1,
                                           int c2) {
  constexpr int kBox = box_cols<D>();
#pragma unroll
  for (int s = 0; s < D / kBox; ++s)
    tma_tile(dst + s * kTileRows * kBox, map, bar, c0 + s * kBox, c1, c2);
}

// wgmma_tile on a tile of D columns: kTransB 0 contracts over D (KS = D /
// 16 k-steps, c n = 64), kTransB 1 has N = D (c of D / 8 column groups, KS
// = 4 k-steps over the tile's 64 rows).
template <int kTransB, int D, int NT, int KS>
__device__ __forceinline__ void wgmma_tile_d(float (&c)[NT][4],
                                             const uint32_t (&a)[KS][4],
                                             const bf16* tile) {
  if constexpr (D <= 64) {
    wgmma_tile<kTransB, 2 * D>(c, a, tile);
  } else if constexpr (kTransB == 0) {
    static_assert(D == 128 && KS == 8 && NT == 8, "S-shaped at D = 128");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<0>(c, a[kk],
                  desc_kmajor(tile + (kk / 4) * kTileElems, kk % 4));
  } else {
    static_assert(D == 128 && NT == 16 && KS == 4, "P.V-shaped at D = 128");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_rs_half<1, 0>(c, a[kk], desc_mnmajor(tile, kk));
      wgmma_rs_half<1, 1>(c, a[kk], desc_mnmajor(tile + kTileElems, kk));
    }
  }
}

// c (n = 64) += A . B^T, both 64-row tiles of D columns read K-major from
// shared memory (the contraction over D): wgmma_tile_ss at D.
template <int D>
__device__ __forceinline__ void wgmma_tile_ss_d(float (&c)[8][4],
                                                const bf16* a_tile,
                                                const bf16* tile) {
  if constexpr (D <= 64) {
    wgmma_tile_ss<0, 2 * D>(c, a_tile, tile);
  } else {
    static_assert(D % 64 == 0, "sub-tiles of 64 columns");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int sub = (kk / 4) * kTileElems;
      wgmma_ss<0>(c, desc_kmajor(a_tile + sub, kk % 4),
                  desc_kmajor(tile + sub, kk % 4));
    }
  }
}

// --- host: launch helpers and tensor maps ----------------------------------

constexpr int kBadArgument = -1;  // arguments the kernels do not take

int max_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr int kNoTensorMapEntry = -2;  // libcuda has no TMA encoder
constexpr int kBadTensorMap = -3;      // the encoder refused the layout

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 64-row swizzled boxes of a bf16 tensor of `planes` planes of `rows` rows
// of `cols` values: row stride `ld` and plane stride `plane` in elements.
// Box (c0, c1, c2) covers columns [c0, c0 + box_cols) of rows [c1, c1 + 64)
// of plane c2; rows >= `rows` read as zeros. box_cols is 64 (128-byte
// swizzle), 32 (64-byte) or 16 (32-byte). Returns 0 or a negative error.
int tile_map(CUtensorMap* map, const void* base, long cols, long rows,
             long planes, long ld, long plane, int box_cols = 64) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kNoTensorMapEntry;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)plane * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, kTileRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  if (box_cols != 64 && box_cols != 32 && box_cols != 16) return kBadTensorMap;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

// --- host: the built head dims ---------------------------------------------

constexpr int kStripMaxDim = 256;  // the widest built head dim (the strips')

// Runs f(std::integral_constant<int, D>()) for a head dim D the kernels are
// built for (HEAD_DIMS of mofo_tpu_torch/ops/flash_attention.py, the same
// six for K1/K2, K3 and K4); kBadArgument for any other D, which the
// wrappers pad with zero columns to the next built one first (the entry
// points send a D above 256 to the column-split kernels before this).
template <typename F>
int by_head_dim(int D, F f) {
  switch (D) {
    case 16:
      return f(std::integral_constant<int, 16>());
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 192:
      return f(std::integral_constant<int, 192>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return kBadArgument;
  }
}

}  // namespace
