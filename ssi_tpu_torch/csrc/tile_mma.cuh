// Block-wide f32 tile products on operands staged in shared memory, for the
// f32 parity paths of the training kernels (flash_attention_bwd.cu,
// cross_entropy.cu); their bf16 paths run wgmma (flash_hopper_bwd.cu,
// cross_entropy_hopper.cu).
//
//   tile_mma<M, N, K, A_T, B_T>(C, ldc, A, lda, B, ldb):  C[M x N] += A . B
//
// C is f32 in shared memory, row-major with leading dimension ldc. A is
// [M x K], stored row-major (A[m * lda + k]) or, with A_T, transposed
// (A[k * lda + m]); B is [K x N], stored row-major (B[k * ldb + n]) or, with
// B_T, transposed (B[n * ldb + k]). The transposed forms let a kernel use a
// tile it already holds as X^T without a copy (K^T in S = Q K^T, P^T in
// dV = P^T dO).
//
// Scalar FMAs in full f32 (TF32 would not meet the parity limits); the
// threads of the block share out the output elements. The caller
// synchronises before (operands written) and after (C read).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace ssi {

template <int M, int N, int K, bool A_T, bool B_T>
__device__ __forceinline__ void tile_mma(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
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

// Copy rows [0, ROWS) x cols [0, COLS) of a row-major global matrix (row
// stride src_ld elements) into shared memory (row stride dst_ld); rows at or
// past n_valid and columns at or past n_cols (a multiple of the 16-byte
// vector) are zero-filled. The block has THREADS threads. 16-byte vector
// copies: src, src_ld, dst and dst_ld must keep every row start 16-byte
// aligned. Each thread starts all its loads before its first store: the
// compiler cannot prove that the shared-memory destination does not alias
// the global source, so interleaved loads and stores would wait for one
// another, one L2 round trip each.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int dst_ld, const T* __restrict__ src, long long src_ld,
                                          int n_valid, int n_cols = COLS) {
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
        if (idx < N && r < n_valid && c < n_cols) val[i] = __ldg(reinterpret_cast<const uint4*>(src + r * src_ld + c));
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
// after another from a dynamic buffer stay 16-byte aligned.
__host__ __device__ constexpr int smem_round(int bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace ssi
