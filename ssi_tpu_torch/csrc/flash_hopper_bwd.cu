// Flash-attention backward, bf16, at head_dim 64 and 128 (each running the
// head_dims up to it): the entry of flash_attention_bwd.cu's bf16 path, which
// hands a head_dim above 128 to flash_hopper_bwd_hd256.cu. The kernels and
// their design: flash_hopper_bwd.cuh.

#include "flash_hopper_bwd.cuh"

cudaError_t ssi::flash_bwd_hopper_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                       const float* lse, float* delta, const int* seg, void* dq, void* dk, void* dv,
                                       int B, int S, int Hq, int Hkv, int hd, int causal, float scale,
                                       cudaStream_t stream) {
    // TMA moves 16-byte pieces: every row of q, k, v and do must start 16-byte aligned
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
         reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
        return cudaErrorInvalidValue;
    if (B > 65535 || hd <= 0 || hd > 256 || hd % 8 != 0) return cudaErrorInvalidValue;
    // the hd-64 instance up to 64 columns, the hd-128 one up to 128, the hd-256 one above
    if (hd <= 64)
        return launch<Hd64>(q, k, v, o, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, hd, causal, scale, stream);
    if (hd > 128)
        return ssi::flash_bwd_hopper_bf16_hd256(q, k, v, o, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, hd,
                                                causal, scale, stream);
    return launch<Hd128>(q, k, v, o, dout, lse, delta, seg, dq, dk, dv, B, S, Hq, Hkv, hd, causal, scale, stream);
}
