// Warp-level tensor-core building blocks for Hopper (sm_90a) kernels written
// with mma.sync: ldmatrix fragment loads, the m16n8k16 bf16 product with f32
// accumulators, and bf16 packing. Used by paged_attention.cu, and through
// hopper.cuh by the Hopper kernels (smem_addr, pack_bf16, cp_async4).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A [16 x 16], 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B [16 x 8], 2 regs: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C [16 x 8], 4 f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// The C layout of two neighbouring n8 blocks is the A layout of one k16 step,
// so a product's result feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ssi {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy global -> shared (src_bytes 0 or 4; 0 zero-fills); 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// Shared row stride (elements) of a staged [rows, COLS] bf16 tile: COLS + 8,
// an odd number of 16-byte units (144 bytes at 64 columns, 272 at 128), so
// the 8 row addresses of an ldmatrix fall in distinct banks.
template <int COLS>
constexpr int lds = COLS + 8;

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and r[i] holds this lane's (row g, cols 2t, 2t+1) of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// as ldmatrix_x4, each matrix transposed: r[i] holds (rows 2t, 2t+1, col g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: [16 x 16] bf16 . [16 x 8] bf16, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half, the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ssi
