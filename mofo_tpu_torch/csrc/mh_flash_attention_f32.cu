// K3's f32 kernels' launchers (masked multihead attention, separate q, k,
// v and a kv-bias row; the layout, numerics and designs are
// mh_flash_attention.cu's notes and the headers'), in a source of their
// own so that the build compiles them in an nvcc process of their own
// beside the bf16 kernels' (ops/_build.py starts one a source, together).
// mh_flash_attention.cu's entry points call mh_f32_fwd, mh_f32_dkv and
// mh_f32_dq for float; each returns 0, kBadArgument for a head dim that is
// not built (up to 256) or no multiple of 64 (above), or a cudaError_t
// from the set-up.
//   - the forward: wgmma_tf32_fwd.cuh's narrow kernel with the bias flag up
//     to 128 (K1's), wgmma_tf32_wide.cuh's at 192 and 256,
//     wgmma_tf32_split.cuh's column-split one above;
//   - dK/dV: the FMA kernel below up to 128, wgmma_tf32_wide.cuh's at 192
//     and 256, wgmma_tf32_split.cuh's above;
//   - dQ: wgmma_tf32_dq.cuh's at every head dim up to 256 (the narrow
//     kernel up to 128), wgmma_tf32_split.cuh's above.
// Replaces, in f32, the TPU kernel K3 of mofo_tpu/ops/flash_attention.py
// (_mh_fwd_impl :653 / _mh_fwd_kernel :460, _mh_bwd_impl :737 /
// _mh_dqkv_kernel :523), as mh_flash_attention.cu lists.

#include "flash_tiles.cuh"
#include "wgmma_tf32_dq.cuh"
#include "wgmma_tf32_fwd.cuh"
#include "wgmma_tf32_split.cuh"
#include "wgmma_tf32_wide.cuh"
#include "wgmma_tiles.cuh"

namespace {

// One q tile's LSE (+inf on rows >= N, so their P is 0) and delta.
__device__ __forceinline__ void load_stats(float* sLse, float* sDelta,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int N, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    sLse[i] = row < N ? lse[row] : INFINITY;
    sDelta[i] = row < N ? delta[row] : 0.f;
  }
}

template <int D, int BKV, int BQ>
constexpr size_t smem_dkv_f32() {
  return ((size_t)(2 * BKV + 2 * BQ) * (D + 1) + 2 * BKV * (BQ + 1) +
          2 * BQ + BKV) * sizeof(float);
}

// Grid (ceil(N / BKV), B * H). One block: one head's BKV key/value rows;
// loops over all q tiles and accumulates dK and dV in registers. It forms
// S^T = K Q^T and dP^T = V dO^T directly (rows kv, columns q), so P^T and
// dS^T are row-major A operands of dV += P^T dO and dK += dS^T Q.
template <int D, int BKV, int BQ>
__global__ void __launch_bounds__(kThreads)
    mh_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int N, int H, int ldq, int ldk,
                   int ldv, int lddkv, float q_scale) {
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
  float* sB = sDelta + BQ;
  const int A = H * D;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BKV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = q + (size_t)b * N * ldq + h * D;
  const float* ob = dout + (size_t)b * N * A + h * D;
  const float* bb = bias ? bias + (size_t)b * N : nullptr;

  load_f32<BKV, D>(sK, k + (size_t)b * N * ldk + h * D, k0, N, ldk, 1.f);
  load_f32<BKV, D>(sV, v + (size_t)b * N * ldv + h * D, k0, N, ldv, 1.f);
  // this block's kv rows >= N are never stored: any finite bias will do
  for (int i = threadIdx.x; i < BKV; i += blockDim.x)
    sB[i] = (k0 + i < N && bb) ? bb[k0 + i] : 0.f;
  float dka[I][JO] = {}, dva[I][JO] = {};

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_f32<BQ, D>(sQ, qb, q0, N, ldq, q_scale);
    load_f32<BQ, D>(sdO, ob, q0, N, A, 1.f);
    load_stats(sLse, sDelta, lse + (size_t)bh * N, delta + (size_t)bh * N,
               q0, N, BQ);
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
        const float p = expf(st[i][j] + sB[r] - sLse[c]);
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
    const size_t off = ((size_t)b * N + row) * lddkv + h * D + tx;
#pragma unroll
    for (int j = 0; j < JO; ++j) {
      dk[off + 16 * j] = dka[i][j];
      dv[off + 16 * j] = dva[i][j];
    }
  }
}

// -------------------------------------------------------------------------
// Launchers (D a built head dim, or above 256 any multiple of 64)
// -------------------------------------------------------------------------

// Tiles of the f32 FMA kernel (dK/dV up to D = 128).
constexpr int kFmaRows = 64;

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

// f32 works in base e: dK needs no 1/log2(e) fix.
template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
            const void* dout, const float* lse, const float* delta, void* dk,
            void* dv, int B, int N, int H, int ldq, int ldk, int ldv,
            int lddkv, float q_scale, cudaStream_t st) {
  if constexpr (D >= 192) {  // 3xTF32 on wgmma: dV and dK blocks
    return launch_dkv_tf32<D>(q, k, v, bias, dout, lse, delta, dk, dv, B, N,
                              H, ldq, ldk, ldv, lddkv, q_scale, st);
  } else {
    constexpr int T = kFmaRows;
    constexpr size_t smem = smem_dkv_f32<D, T, T>();
    auto kernel = mh_bwd_dkv_f32<D, T, T>;
    if (int e = max_smem((const void*)kernel, smem)) return e;
    kernel<<<dim3(cdiv(N, T), B * H), kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<const float*>(dout),
        lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), N, H,
        ldq, ldk, ldv, lddkv, q_scale);
    return 0;
  }
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
