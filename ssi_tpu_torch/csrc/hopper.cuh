// Hopper (sm_90a) building blocks for the bf16 flash kernels
// (flash_hopper_fwd.cu, flash_hopper_bwd.cu), the cross-entropy GEMM
// (cross_entropy_hopper.cu) and the paged core's page loads
// (paged_attention.cu): mbarriers, TMA tile loads fed by tensor maps,
// warpgroup matrix products (wgmma) with shared-memory descriptors, and the
// host-side tensor-map encoding. Raw PTX, no CUTLASS: each source compiles in
// seconds.
//
// Shared-memory tiles are bf16 [rows, 64] blocks, 128 bytes a row, stored
// with the 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8))
// as a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes them; each block starts
// 1024-byte aligned. A head_dim-64 tile is one such block, a head_dim-128 tile
// two ("halves": columns 0-63 and 64-127), a head_dim-256 tile four. One layout serves both operand majors:
// - K-major (the product's K along the 64 columns: Q and K in S = Q.K^T, h and
//   E in the logits h . E^T, dlogits in dh = dlogits . E): SBO 1024 bytes (8
//   rows), LBO unused (16); a k16 step within a half is +32 bytes of start
//   address, and the next half is the next block;
// - MN-major (the product's K along the rows: V in O = P.V, E in dh, both
//   operands of dE = dlogits^T . h): SBO 1024 bytes (8 rows of K), LBO the
//   bytes between the blocks (the next 64 columns of M or N); a k16 step is
//   +16 rows = +2048 bytes.
//
// wgmma accumulator layout (m64nN, f32): thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, t4 = t % 4, holds d[4j + e] = row 16w + g
// (+8 for e >= 2), column 8j + 2 t4 (+1 for odd e): per n8 block the C
// fragment of mma.sync m16n8k16 on the warp's 16-row slab. The register A
// operand of m64nNk16 is the mma.sync A fragment of that slab, so a score
// accumulator becomes the next product's A operand in registers: for k16
// step kk, a = {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
// pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])} (pack_a below).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver entry is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"  // smem_addr, pack_bf16

namespace ssi::hopper {

// ---- device ---------------------------------------------------------------------

// the first 1024-byte aligned address at or after p (swizzled tiles need it)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    const uint32_t a = smem_addr(p);
    return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// arrive once on bar (one of the phase's expected arrivals)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier's
// phase 0 is incomplete; parity 1 passes at once, the "previous" phase)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// Two consumer warpgroups share each ring stage, and the one that releases
// it second refills it: one thread of a warpgroup calls this once its
// products reading the stage have completed; true for the second caller of
// the stage's use. acq_rel orders the other warpgroup's reads before the refill.
__device__ __forceinline__ bool release_last(uint32_t* count) {
    uint32_t old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n" : "=r"(old) : "r"(smem_addr(count)) : "memory");
    return old & 1;
}

// TMA: the box at coordinates (c0 innermost ...) of `map` -> dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
        : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
        "[%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed (one
// of the phase's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// TMA store: the box at src -> coordinates (c0 innermost ...) of `map` (rows
// past the tensor's extent are not written); then commit it as a bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
                 : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// order this thread's shared-memory writes before later async-proxy (TMA) reads
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads: sync
// waits until `count` threads have arrived; arrive counts without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// x, opaque to the compiler: descriptors built from it inside a loop are not
// hoisted out of it, where they would hold 2 registers each through the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("" : "+r"(x));
    return x;
}

// order this thread's register writes before the warpgroup's next wgmma reads them
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across an
// asynchronous product (it does not know wgmma writes d after the asm returns)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 2^x in one MUFU op: exp2f also scales results below 2^-126 into the
// denormal range (three more instructions); those are flushed to 0 here, which
// no probability sum in these kernels can tell apart
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// an m64nN accumulator (N/2 floats) cast to bf16 as the register A operand of
// N/16 k16 steps (a[4kk .. 4kk+3] for step kk)
template <int N2>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N2 / 2], const float (&d)[N2]) {
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// A warpgroup's [64 x 2 N2] f32 accumulator (N2 floats a thread; rows lo times
// mul_lo, rows hi times mul_hi) in bf16 into `region`: 64 rows of a tile of
// 64-column blocks in the swizzled layout (128 bytes a row, the blocks
// block_bytes apart; free shared memory of this warpgroup), then out by one TMA
// store a block at (column, h, s0, b) of `map` (64-row boxes), which skips rows
// past S. The 4-byte writes of a warp fall in 32 distinct banks. All 128
// threads call it; `bar_id` is a named barrier of this warpgroup alone.
template <int N2>
__device__ __forceinline__ void store_tile(const float (&acc)[N2], float mul_lo, float mul_hi, unsigned char* region,
                                           uint32_t block_bytes, const CUtensorMap* map, int h, int s0, int b,
                                           int bar_id) {
    const int t = threadIdx.x % 128;
    const int g = (t % 32) / 4;
    const int t4 = t % 4;
    unsigned char* row = region + ((t / 32) * 16 + g) * 128;  // row lo; (row % 8) == g, also for row hi
#pragma unroll
    for (int j = 0; j < N2 / 4; ++j) {
        const uint32_t off = (j / 8) * block_bytes + ((j % 8) ^ g) * 16 + t4 * 4;
        *reinterpret_cast<__nv_bfloat162*>(row + off) =
            __floats2bfloat162_rn(acc[4 * j] * mul_lo, acc[4 * j + 1] * mul_lo);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * 128 + off) =
            __floats2bfloat162_rn(acc[4 * j + 2] * mul_hi, acc[4 * j + 3] * mul_hi);
    }
    fence_async_shared();
    named_sync(bar_id, 128);  // the warpgroup's rows are all written
    if (t == 0) {
#pragma unroll
        for (int blk = 0; blk < N2 / 32; ++blk) tma_store_4d(map, region + blk * block_bytes, 64 * blk, h, s0, b);
        tma_store_commit();
        tma_store_wait();
    }
}

#define SSI_ACC8(d, i)                                                                                       \
    "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), \
        "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define SSI_ACC16(d) SSI_ACC8(d, 0), SSI_ACC8(d, 8)
#define SSI_ACC32(d) SSI_ACC8(d, 0), SSI_ACC8(d, 8), SSI_ACC8(d, 16), SSI_ACC8(d, 24)
#define SSI_ACC64(d) SSI_ACC32(d), SSI_ACC8(d, 32), SSI_ACC8(d, 40), SSI_ACC8(d, 48), SSI_ACC8(d, 56)

// d (+)= A . B for m64n32k16: A [64 x 16] and B [16 x 32] both K-major in shared
// memory (descriptors a, b); accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SSI_ACC16(d)
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B for m64n64k16: A [64 x 16] and B [16 x 64] both K-major in shared
// memory (descriptors a, b); accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SSI_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B for m64n128k16: A [64 x 16] and B [16 x 128] both K-major in shared
// memory (descriptors a, b); accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : SSI_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B for m64n128k16: A from registers (a0..a3, the thread's bf16x2
// A fragment, see the top of the file), B [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t b,
                                                 int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : SSI_ACC64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

#define SSI_ACC128(d)                                                                                        \
    SSI_ACC64(d), SSI_ACC8(d, 64), SSI_ACC8(d, 72), SSI_ACC8(d, 80), SSI_ACC8(d, 88), SSI_ACC8(d, 96),         \
        SSI_ACC8(d, 104), SSI_ACC8(d, 112), SSI_ACC8(d, 120)

// d (+)= A . B for m64n64k16: A from registers (a0..a3, the thread's bf16x2
// A fragment, see the top of the file), B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t b,
                                                int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SSI_ACC32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d (+)= A . B for m64n128k16 with both operands in shared memory, each
// K-major (0) or MN-major (1: the instruction's transpose bit): an MN-major A
// [64 x 16] is stored as 16 rows of K with M contiguous, an MN-major B
// [16 x 128] as 16 rows of K with N contiguous.
template <int A_MN, int B_MN>
__device__ __forceinline__ void wgmma_ss_major_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : SSI_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(A_MN), "n"(B_MN));
}

// as wgmma_ss_major_n128 with B [16 x 256]
template <int A_MN, int B_MN>
__device__ __forceinline__ void wgmma_ss_major_n256(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : SSI_ACC128(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(A_MN), "n"(B_MN));
}

// d (+)= A . B for m64n256k16: A from registers (a0..a3, the thread's bf16x2
// A fragment, see the top of the file), B [16 x 256] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256_mn(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                 uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : SSI_ACC128(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

#undef SSI_ACC128
#undef SSI_ACC64
#undef SSI_ACC32
#undef SSI_ACC16
#undef SSI_ACC8

// ---- host -----------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function and the library links no
// libcuda: it is fetched once through the runtime's driver entry point.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// Tensor map of a bf16 [B, S, H, hd] operand with element strides (sb, ss, sh)
// (head_dim contiguous), read in boxes of 64 columns x `rows` positions of one
// head and batch, 128-byte swizzled. S and B stay separate dimensions, so a
// box running past S is zero-filled and never reads the next batch's rows.
inline cudaError_t map_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, long long sb, long long ss,
                            long long sh, int rows) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    // a dimension of extent 1 is never stepped: any legal stride describes it
    auto stride = [](long long s, int extent) { return (uint64_t)(extent == 1 ? 16 : s * 2); };
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {stride(sh, H), stride(ss, S), stride(sb, B)};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a bf16 [rows, H, hd] tensor, contiguous (hd * 2 a multiple of
// 16 bytes), read in boxes of 64 columns x one head x `box_rows` rows,
// 128-byte swizzled: the paged pools [rows * ps, Hkv * hd] with a head's
// columns a dimension of their own, so a box's columns past hd are
// zero-filled and never read the next head's.
inline cudaError_t map_rows_heads(CUtensorMap* map, const void* ptr, long long rows, int H, int hd, int box_rows) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)rows};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a bf16 matrix [rows, cols] with row stride `ld` elements
// (cols contiguous, ld * 2 a multiple of 16 bytes), read in boxes of 64
// columns x `box_rows` rows, 128-byte swizzled; a box past either extent is
// zero-filled (columns in [cols, ld) are never read).
inline cudaError_t map_2d(CUtensorMap* map, const void* ptr, long long rows, long long cols, long long ld, int box_rows) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)(ld * 2)};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ssi::hopper
