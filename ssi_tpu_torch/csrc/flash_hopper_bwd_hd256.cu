// Flash-attention backward, bf16, at head_dim 129-256: the instance at 256 of
// flash_hopper_bwd.cuh (its dK/dV kernel whose warpgroups split each pair's
// work, and the dQ kernel with 32-key stages), called by flash_hopper_bwd.cu.

#include "flash_hopper_bwd.cuh"

cudaError_t ssi::flash_bwd_hopper_bf16_hd256(const void* q, const void* k, const void* v, const void* o,
                                             const void* dout, const float* lse, float* delta, const int* seg,
                                             void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv, int hd,
                                             int causal, float scale, cudaStream_t stream) {
    return launch<Hd256>(q, k, v, o, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, hd, causal, scale, stream);
}
