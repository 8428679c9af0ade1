// Block-wide tile products on operands staged in shared memory, shared by the
// training kernels (flash_attention_bwd.cu, cross_entropy.cu).
//
//   tile_mma<T, M, N, K, A_T, B_T>(C, ldc, A, lda, B, ldb):  C[M x N] += A . B
//
// C is f32 in shared memory, row-major with leading dimension ldc. A is
// [M x K], stored row-major (A[m * lda + k]) or, with A_T, transposed
// (A[k * lda + m]); B is [K x N], stored row-major (B[k * ldb + n]) or, with
// B_T, transposed (B[n * ldb + k]). The transposed forms let a kernel use a
// tile it already holds as X^T without a copy (K^T in S = Q K^T, P^T in
// dV = P^T dO).
//
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 fragments with
// f32 accumulation (the warps of the block share out the 16x16 output
// fragments); f32 runs scalar FMAs in full f32, for the parity checks. Both
// need M, N, K multiples of 16, every pointer 32-byte aligned and every
// leading dimension a multiple of 8 elements (wmma's rules for 16-bit
// operands, 4 for the f32 C). The caller synchronises before (operands
// written) and after (C read).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ssi {

template <typename T, int M, int N, int K, bool A_T, bool B_T>
struct TileMma;

template <int M, int N, int K, bool A_T, bool B_T>
struct TileMma<float, M, N, K, A_T, B_T> {
    static __device__ __forceinline__ void run(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
        for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
            const int m = idx / N;
            const int n = idx % N;
            float acc = C[m * ldc + n];
#pragma unroll 8
            for (int k = 0; k < K; ++k) {
                const float a = A_T ? A[k * lda + m] : A[m * lda + k];
                const float b = B_T ? B[n * ldb + k] : B[k * ldb + n];
                acc = fmaf(a, b, acc);
            }
            C[m * ldc + n] = acc;
        }
    }
};

template <int M, int N, int K, bool A_T, bool B_T>
struct TileMma<__nv_bfloat16, M, N, K, A_T, B_T> {
    static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "tile dims must be multiples of 16");
    static __device__ __forceinline__ void run(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                               const __nv_bfloat16* B, int ldb) {
        using namespace nvcuda;
        using LayoutA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
        using LayoutB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
        const int warp = threadIdx.x / 32;
        const int n_warps = blockDim.x / 32;
        for (int f = warp; f < (M / 16) * (N / 16); f += n_warps) {
            const int mi = f / (N / 16);
            const int ni = f % (N / 16);
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
            float* cp = C + mi * 16 * ldc + ni * 16;
            wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
#pragma unroll
            for (int ki = 0; ki < K / 16; ++ki) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b;
                wmma::load_matrix_sync(a, A_T ? A + ki * 16 * lda + mi * 16 : A + mi * 16 * lda + ki * 16, lda);
                wmma::load_matrix_sync(b, B_T ? B + ni * 16 * ldb + ki * 16 : B + ki * 16 * ldb + ni * 16, ldb);
                wmma::mma_sync(c, a, b, c);
            }
            wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
        }
    }
};

template <typename T, int M, int N, int K, bool A_T, bool B_T>
__device__ __forceinline__ void tile_mma(float* C, int ldc, const T* A, int lda, const T* B, int ldb) {
    TileMma<T, M, N, K, A_T, B_T>::run(C, ldc, A, lda, B, ldb);
}

// Copy rows [0, ROWS) x cols [0, COLS) of a row-major global matrix (row
// stride src_ld elements) into shared memory (row stride dst_ld); rows at or
// past n_valid are zero-filled. The block has THREADS threads. 16-byte vector
// copies: src, src_ld, dst and dst_ld must keep every row start 16-byte
// aligned. Each thread starts all its loads before its first store: the
// compiler cannot prove that the shared-memory destination does not alias
// the global source, so interleaved loads and stores would wait for one
// another, one L2 round trip each.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int dst_ld, const T* __restrict__ src, long long src_ld,
                                          int n_valid) {
    constexpr int VEC = 16 / sizeof(T);
    static_assert(COLS % VEC == 0, "COLS must be a multiple of the 16-byte vector");
    constexpr int N = ROWS * (COLS / VEC);
    constexpr int PER_THREAD = (N + THREADS - 1) / THREADS;
    uint4 val[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / (COLS / VEC);
        const int c = (idx % (COLS / VEC)) * VEC;
        val[i] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < N && r < n_valid) val[i] = __ldg(reinterpret_cast<const uint4*>(src + r * src_ld + c));
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        if (idx < N) {
            const int r = idx / (COLS / VEC);
            const int c = (idx % (COLS / VEC)) * VEC;
            *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = val[i];
        }
    }
}

// Bytes of a shared-memory region rounded up to 128, so regions carved one
// after another from a dynamic buffer keep wmma's 32-byte alignment.
__host__ __device__ constexpr int smem_round(int bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace ssi
