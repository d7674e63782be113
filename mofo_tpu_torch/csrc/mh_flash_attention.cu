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
// 256 wgmma_attn_split.cuh's column-split ones. The f32 kernels' launchers
// are mh_flash_attention_f32.cu's (a source of its own, so that the build
// compiles them beside these), which the entry points call for float:
// every f32 kernel runs 3xTF32 on wgmma (below).
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
//   - The f32 forward, dK/dV and dQ at every D (the parity path's MCA,
//     and K1/K2's f32 at 192 and 256; K2's f32 dQ at every D), run
//     products in 3xTF32 on wgmma (each operand split
//     into TF32 hi and lo, lo.hi + hi.lo + hi.hi in f32: as accurate as
//     f32), fed by TMA: the forward up to 128 is wgmma_tf32_fwd.cuh's
//     (K1's kernel, with the bias flag), dK/dV up to 128
//     wgmma_tf32_dkv.cuh's (K2's kernel, with the bias flag: the kv bias
//     of a thread's two rows in registers), dQ up to 128 wgmma_tf32_dq.cuh's
//     narrow kernel (q * q_scale and dO resident as (hi, lo) pairs, K, V
//     and K transposed streamed, a bias flag), the rest at 192 and 256
//     wgmma_tf32_wide.cuh's, with D streamed in 64-column chunks beside
//     one resident (hi, lo) strip, and dK and dV written by separate
//     blocks. Above 256 the f32 forward, dK/dV and dQ are
//     wgmma_tf32_split.cuh's column-split 3xTF32 kernels (both operands of
//     every contraction over D streamed, balanced groups of at most 256
//     columns, dV, dK and dQ each by its own blocks). All tiles above 48
//     KB are dynamic shared memory.
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

#include "mh_f32.cuh"  // the f32 launchers (mh_flash_attention_f32.cu)
#include "wgmma_attn_bwd.cuh"
#include "wgmma_attn_split.cuh"
#include "wgmma_attn_wide.cuh"
#include "wgmma_tiles.cuh"

namespace {

// -------------------------------------------------------------------------
// Launchers
// -------------------------------------------------------------------------

// D: a built head dim (by_head_dim); ld*: row strides of at least A.
bool bad(int B, int N, int H, int ldq, int ldk, int ldv, int A) {
  return B < 1 || N < 1 || H < 1 || B * H > 65535 || ldq < A || ldk < A ||
         ldv < A;
}

// A (B, N, A) bf16 operand at row stride ld, boxes of box_cols<D>().
template <int D>
int mh_map(CUtensorMap* map, const void* base, int B, int N, int A, int ld) {
  return tile_map(map, base, A, N, B, ld, (long)N * ld, box_cols<D>());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int N, int H, int ldq, int ldk,
        int ldv, float q_scale, cudaStream_t st) {
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

// wgmma_attn_bwd.cuh's kernels with the bias flag up to D = 128,
// wgmma_attn_wide.cuh's strip kernels above.
template <int D>
int bwd_dkv(const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta,
            const void* qs, void* dk, void* dv, int B, int N, int H, int ldk,
            int ldv, int lddkv, float dk_fix, cudaStream_t st) {
  if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
  CUtensorMap tk, tv, tqs, tdo;
  if (int e = bwd_maps<D>(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N, H * D,
                          ldk, ldv))
    return e;
  if constexpr (D <= 128)
    return launch_bwd_dkv<false, true, D>(tk, tv, tqs, tdo, 0, 0, lse, delta,
                                          bias, dk, dv, lddkv, B, N, H,
                                          dk_fix, st);
  else
    return launch_strip_dkv<D, false>(tk, tv, tqs, tdo, bias, lse, delta, dk,
                                      dv, lddkv, B, N, H, dk_fix, st);
}

template <int D>
int bwd_dq(const void* k, const void* v, const float* bias, const void* dout,
           const float* lse, const float* delta, const void* qs,
           const void* ks, void* dq, int B, int N, int H, int ldk, int ldv,
           int lddq, float k_scale, cudaStream_t st) {
  if (!qs) return kBadArgument;  // q * q_scale comes from the prep pass
  const int A = H * D;
  CUtensorMap tk, tv, tqs, tdo, tks;
  if (int e = bwd_maps<D>(&tk, &tv, &tqs, &tdo, k, v, qs, dout, B, N, A, ldk,
                          ldv))
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
    return launch_strip_dq<D, false>(tk, tv, tqs, tdo, bias, lse, delta, dq,
                                     lddq, B, N, H, k_scale, st);
  }
}

}  // namespace

// All entry points return 0 on success, a cudaError_t from the launch, or -1
// for arguments the kernels do not take (a head dim up to 256 that is not
// built, or one above it that is no multiple of 64). `bf16` selects
// __nv_bfloat16 (the tensor-core kernels) over float (3xTF32 on the tensor
// cores at every head dim). q_scale and k_scale are already rounded to
// the element type; rows must be 16-byte aligned (TMA
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
  if (int e = !bf16 ? mh_f32_fwd(q, k, v, b, out, l, B, N, H, D, ldq, ldk,
                                 ldv, q_scale, st)
              : D > kStripMaxDim
                  ? launch_split_fwd<false>(q, k, v, ldq, ldk, ldv, b, out, l,
                                            B, N, H, D, q_scale, st)
                  : by_head_dim(D, [&](auto d) {
                      return fwd<decltype(d)::value>(q, k, v, b, out, l, B, N,
                                                     H, ldq, ldk, ldv, q_scale,
                                                     st);
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
  if (int e = !bf16 ? mh_f32_dkv(q, k, v, b, dout, l, d_, dk, dv, B, N, H, D,
                                 ldq, ldk, ldv, lddkv, q_scale, st)
              : D > kStripMaxDim
                  ? launch_split_dkv<false>(k, v, ldk, ldv, qs, dout, b, l, d_,
                                            dk, dv, lddkv, B, N, H, D, dk_fix,
                                            st)
                  : by_head_dim(D, [&](auto d) {
                      return bwd_dkv<decltype(d)::value>(
                          k, v, b, dout, l, d_, qs, dk, dv, B, N, H, ldk, ldv,
                          lddkv, dk_fix, st);
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
  if (int e = !bf16 ? mh_f32_dq(q, k, v, b, dout, l, d_, dq, B, N, H, D, ldq,
                                ldk, ldv, lddq, q_scale, k_scale, st)
              : D > kStripMaxDim
                  ? launch_split_dq<false>(k, v, ldk, ldv, qs, ks, dout, b, l,
                                           d_, dq, lddq, B, N, H, D, k_scale,
                                           st)
                  : by_head_dim(D, [&](auto d) {
                      return bwd_dq<decltype(d)::value>(
                          k, v, b, dout, l, d_, qs, ks, dq, B, N, H, ldk, ldv,
                          lddq, k_scale, st);
                    }))
    return e;
  return (int)cudaGetLastError();
}
