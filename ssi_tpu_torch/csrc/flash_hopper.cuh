// Launchers of the bf16 Hopper flash kernels (flash_hopper_fwd.cu, and
// flash_hopper_bwd.cu with flash_hopper_bwd_hd256.cu; each an instance at
// head_dim 64, 128 and 256 that also runs any head_dim below it), called by
// the C entry points of flash_attention_fwd.cu and flash_attention_bwd.cu for
// dtype bf16.
#pragma once

#include <cuda_runtime.h>

namespace ssi {

// o [B, S, Hq, hd] contiguous and lse [B, Hq, S] from q [B, S, Hq, hd] and
// k, v [B, S, Hkv, hd] with element strides (b, s, h), head_dim contiguous;
// hd <= 256, a multiple of 8.
cudaError_t flash_fwd_hopper_bf16(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse,
                                  int B, int S, int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, int causal, float scale, cudaStream_t stream);

// dq, dk, dv from contiguous [B, S, H, hd] q, k, v, o, do and the forward's
// lse [B, Hq, S]; delta [B, Hq, S] is scratch for rowsum(o * do); hd <= 256,
// a multiple of 8.
cudaError_t flash_bwd_hopper_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                  const float* lse, float* delta, const int* seg, void* dq, void* dk, void* dv, int B,
                                  int S, int Hq, int Hkv, int hd, int causal, float scale, cudaStream_t stream);

// flash_bwd_hopper_bf16 at 128 < hd <= 256 (flash_hopper_bwd_hd256.cu), with
// the checks of flash_bwd_hopper_bf16 made
cudaError_t flash_bwd_hopper_bf16_hd256(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                        const float* lse, float* delta, const int* seg, void* dq, void* dk, void* dv,
                                        int B, int S, int Hq, int Hkv, int hd, int causal, float scale,
                                        cudaStream_t stream);

}  // namespace ssi
