// Shared helpers for the port's CUDA kernels: dtype conversion, vector loads
// and the dynamic shared-memory attribute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssi {

// dtype codes passed across the C interface (see ssi_tpu_torch/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 8 consecutive elements -> f32 registers; p must be 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        o[2 * i] = f.x;
        o[2 * i + 1] = f.y;
    }
}

// Let `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets by default). `set` is the caller's static record of the bytes
// already allowed, so the attribute call is made once per kernel and not on
// later launches (a CUDA graph capture among them).
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int& set) {
    if (bytes <= set) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) set = bytes;
    return err;
}

}  // namespace ssi
