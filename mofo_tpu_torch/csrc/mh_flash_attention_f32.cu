// K3's f32 kernels' launchers (masked multihead attention, separate q, k,
// v and a kv-bias row; the layout, numerics and designs are
// mh_flash_attention.cu's notes and the headers'), in a source of their
// own so that the build compiles them in an nvcc process of their own
// beside the bf16 kernels' (ops/_build.py starts one a source, together).
// mh_flash_attention.cu's entry points call mh_f32_fwd, mh_f32_dkv and
// mh_f32_dq for float, and hm_flash_attention.cu's backward calls
// mh_f32_dkv and mh_f32_dq for K4 (one head a plane, no bias; mh_f32.cuh
// declares them); each returns 0, kBadArgument for a head dim that is not
// built (up to 256) or no multiple of 64 (above), or a cudaError_t from the
// set-up.
//   - the forward: wgmma_tf32_fwd.cuh's narrow kernel with the bias flag up
//     to 128 (K1's), wgmma_tf32_wide.cuh's at 192 and 256,
//     wgmma_tf32_split.cuh's column-split one above;
//   - dK/dV: wgmma_tf32_dkv.cuh's narrow kernel with the bias flag up to
//     128 (K2's), wgmma_tf32_wide.cuh's at 192 and 256,
//     wgmma_tf32_split.cuh's above;
//   - dQ: wgmma_tf32_dq.cuh's at every head dim up to 256 (the narrow
//     kernel up to 128), wgmma_tf32_split.cuh's above.
// Replaces, in f32, the TPU kernel K3 of mofo_tpu/ops/flash_attention.py
// (_mh_fwd_impl :653 / _mh_fwd_kernel :460, _mh_bwd_impl :737 /
// _mh_dqkv_kernel :523), as mh_flash_attention.cu lists.

#include "mh_f32.cuh"
#include "wgmma_tf32_dkv.cuh"
#include "wgmma_tf32_dq.cuh"
#include "wgmma_tf32_fwd.cuh"
#include "wgmma_tf32_split.cuh"
#include "wgmma_tf32_wide.cuh"
#include "wgmma_tiles.cuh"

namespace {

// -------------------------------------------------------------------------
// Launchers (D a built head dim, or above 256 any multiple of 64)
// -------------------------------------------------------------------------

// 3xTF32 on wgmma: the narrow kernel (wgmma_tf32_fwd.cuh, K1's, with the
// bias flag) up to 128, D streamed in chunks at 192 and 256.
template <int D>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* out, float* lse, int B, int N, int H, int ldq, int ldk,
        int ldv, float q_scale, cudaStream_t st) {
  if constexpr (D >= 192)
    return launch_fwd_tf32<D>(q, k, v, bias, out, lse, B, N, H, ldq, ldk,
                              ldv, q_scale, st);
  else
    return launch_fwd_f32<D, true>(q, k, v, bias, out, lse, B, N, H, ldq,
                                   ldk, ldv, q_scale, st);
}

// 3xTF32 on wgmma, base e (dK needs no 1/log2(e) fix): the narrow kernel
// (wgmma_tf32_dkv.cuh, K2's, its bias flag set by a non-null bias) up to
// 128, D streamed in chunks at 192 and 256 (dV and dK blocks).
template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta, void* dk,
            void* dv, int B, int N, int H, int ldq, int ldk, int ldv,
            int lddkv, float q_scale, cudaStream_t st) {
  if constexpr (D >= 192)
    return launch_dkv_tf32<D>(q, k, v, bias, dout, lse, delta, dk, dv, B, N,
                              H, ldq, ldk, ldv, lddkv, q_scale, st);
  else if (bias)
    return launch_dkv_f32<D, true>(q, k, v, bias, dout, lse, delta, dk, dv,
                                   B, N, H, ldq, ldk, ldv, lddkv, q_scale,
                                   st);
  else
    return launch_dkv_f32<D, false>(q, k, v, nullptr, dout, lse, delta, dk,
                                    dv, B, N, H, ldq, ldk, ldv, lddkv,
                                    q_scale, st);
}

// 3xTF32 on wgmma at every D, the narrow kernel up to 128 (its bias flag
// set by a non-null bias), D streamed in chunks at 192 and 256.
template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* delta, void* dq,
           int B, int N, int H, int ldq, int ldk, int ldv, int lddq,
           float q_scale, float k_scale, cudaStream_t st) {
  return launch_dq_tf32<D>(q, k, v, bias, dout, lse, delta, dq, B, N, H,
                           ldq, ldk, ldv, lddq, q_scale, k_scale, st);
}

// ---- above head dim 256: wgmma_tf32_split.cuh's column-split 3xTF32
// kernels, D at run time (a multiple of 64, the wrapper pads any other) ---

int split_fwd(const void* q, const void* k, const void* v, const float* bias,
              void* out, float* lse, int B, int N, int H, int D, int ldq,
              int ldk, int ldv, float q_scale, cudaStream_t st) {
  return launch_split_fwd_tf32<false>(q, k, v, bias, out, lse, B, N, H, D,
                                      ldq, ldk, ldv, q_scale, st);
}

int split_dkv(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta,
              void* dk, void* dv, int B, int N, int H, int D, int ldq,
              int ldk, int ldv, int lddkv, float q_scale, cudaStream_t st) {
  return launch_split_dkv_tf32(q, k, v, bias, dout, lse, delta, dk, dv, B,
                               N, H, D, ldq, ldk, ldv, lddkv, q_scale, st);
}

int split_dq(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* delta,
             void* dq, int B, int N, int H, int D, int ldq, int ldk, int ldv,
             int lddq, float q_scale, float k_scale, cudaStream_t st) {
  return launch_split_dq_tf32(q, k, v, bias, dout, lse, delta, dq, B, N, H,
                              D, ldq, ldk, ldv, lddq, q_scale, k_scale, st);
}

}  // namespace

int mh_f32_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* out, float* lse, int B, int N, int H, int D, int ldq,
               int ldk, int ldv, float q_scale, cudaStream_t st) {
  return D > kStripMaxDim
             ? split_fwd(q, k, v, bias, out, lse, B, N, H, D, ldq, ldk, ldv,
                         q_scale, st)
             : by_head_dim(D, [&](auto d) {
                 return fwd<decltype(d)::value>(q, k, v, bias, out, lse, B, N,
                                                H, ldq, ldk, ldv, q_scale, st);
               });
}

int mh_f32_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int N, int H, int D, int ldq,
               int ldk, int ldv, int lddkv, float q_scale, cudaStream_t st) {
  return D > kStripMaxDim
             ? split_dkv(q, k, v, bias, dout, lse, delta, dk, dv, B, N, H, D,
                         ldq, ldk, ldv, lddkv, q_scale, st)
             : by_head_dim(D, [&](auto d) {
                 return bwd_dkv<decltype(d)::value>(
                     q, k, v, bias, dout, lse, delta, dk, dv, B, N, H, ldq,
                     ldk, ldv, lddkv, q_scale, st);
               });
}

int mh_f32_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta,
              void* dq, int B, int N, int H, int D, int ldq, int ldk, int ldv,
              int lddq, float q_scale, float k_scale, cudaStream_t st) {
  return D > kStripMaxDim
             ? split_dq(q, k, v, bias, dout, lse, delta, dq, B, N, H, D, ldq,
                        ldk, ldv, lddq, q_scale, k_scale, st)
             : by_head_dim(D, [&](auto d) {
                 return bwd_dq<decltype(d)::value>(
                     q, k, v, bias, dout, lse, delta, dq, B, N, H, ldq, ldk,
                     ldv, lddq, q_scale, k_scale, st);
               });
}
