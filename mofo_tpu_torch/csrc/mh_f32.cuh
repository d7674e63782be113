// The f32 attention launchers of K3 (masked multihead attention), built
// from mh_flash_attention_f32.cu and declared here for every source that
// runs them: mh_flash_attention.cu's entry points (K3, and K1/K2 through
// them) and hm_flash_attention.cu's backward (K4: its (BH, N, D) planes as
// K3's (B, N, H D) at B = BH, H = 1, row strides D, no bias). Each takes
// float q, k, v (B, N, H D) at row strides ldq, ldk, ldv, a (B, N) kv bias
// or null, lse and delta (B, H, N), and returns 0, kBadArgument for a head
// dim that is not built (up to 256) or no multiple of 64 (above), or a
// cudaError_t from the set-up; mh_flash_attention_f32.cu's notes say which
// 3xTF32 kernel serves which head dim.

#pragma once

#include <cuda_runtime.h>

int mh_f32_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* out, float* lse, int B, int N, int H, int D, int ldq,
               int ldk, int ldv, float q_scale, cudaStream_t st);
int mh_f32_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int N, int H, int D, int ldq,
               int ldk, int ldv, int lddkv, float q_scale, cudaStream_t st);
int mh_f32_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta,
              void* dq, int B, int N, int H, int D, int ldq, int ldk, int ldv,
              int lddq, float q_scale, float k_scale, cudaStream_t st);
