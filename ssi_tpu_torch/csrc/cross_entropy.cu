// Fused cross-entropy over the output matrix E [V, D] from hidden states
// h [N, D]: the streaming logsumexp of h . E^T (forward), and the backward
// as one dlogits pass and two tiled GEMMs, dh = dlogits . E and
// dE = dlogits^T . h, where dlogits = (softmax - onehot) * valid * g. bf16
// operands on the tensor cores with f32 accumulation, or f32 throughout.
//
// Replaces the TPU kernels ssi_tpu/ops/cross_entropy_pallas.py `_lse_kernel`
// (via `_compute_lse`), `_dh_kernel` and `_de_kernel` (via `_bwd_rule`).
// Semantics kept: vocab columns at or past V count as -1e30 logits (the TPU
// kernels pad E and mask them), ignored labels (-100) and token rows at or
// past N give zero dlogits, the upstream scalar g multiplies dlogits, and
// dlogits is cast to the operand dtype before the dh and dE products.
//
// What bounds it on Hopper: three [N, D] x [D, V]-class products at N 4096,
// D 2048, V 133,258 (2.24 TFLOP each: the logits once for lse, and the
// dlogits, dh and dE products in the backward). The TPU kernels held
// [512, 2048] and [2048, 2048] f32 accumulators in VMEM; a Hopper block has
// 227 KB of shared memory, so:
// - lse: one block per (64-token tile, vocab split); it streams 64-row vocab
//   tiles of its split through shared memory in 128-wide D chunks and keeps
//   a running max and sum per token. A token-tile grid alone gives only N/64
//   blocks, so the vocab is split across blocks and a second small kernel
//   merges the per-split (max, sum) pairs in a fixed order (deterministic,
//   no atomics). Products are wmma fragments from shared memory (tile_mma.cuh).
// - backward: the TPU kernels formed dlogits tile by tile twice, once inside
//   dh and once inside dE. Here one GEMM pass forms the logits once and
//   writes dlogits in the operand dtype to a scratch [N, ldv] (ldv = V
//   rounded up to 8, so every row is 16-byte aligned; pad columns are 0), and
//   two GEMMs read it: dh = dlogits . E (K = V) and dE = dlogits^T . h
//   (K = N). At N 4096 the scratch is 1.09 GB in bf16, written once and read
//   twice, against the 6.7 TFLOP of the three products.
// The three backward passes are one kernel template: 128 x 128 output tiles,
// 8 warps of 64 x 32, mma.sync m16n8k16 (mma.cuh) fed by ldmatrix (.trans
// for an operand whose rows run along M or N rather than K) from a 3-stage
// cp.async ring of 64-deep K slabs, accumulators in registers, and the
// epilogue (dlogits formula, or the cast and store) applied from registers.
// Each output tile belongs to one block, which sums the whole K in a fixed
// order: no atomics, so two launches give the same bits. The f32 parity path
// runs the same tiling with scalar FMAs (TF32 would not meet the f32 limits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KC = 128;        // D chunk staged per step
constexpr int LDK = KC + 8;    // leading dimension of staged operand chunks
constexpr int IGNORE = -100;   // CROSS_ENTROPY_IGNORE_IDX
constexpr float NEG_INF = -1.0e30f;

// ---- forward: logsumexp ----------------------------------------------------

constexpr int LT = 64;         // tokens per lse block
constexpr int LV = 64;         // vocab rows per streamed tile
constexpr int LDL = LV + 4;    // leading dimension of the f32 logits tile
constexpr int LSE_BLOCKS = 1056;  // lse blocks to aim for: 8 per SM of an H100's 132

template <typename T>
constexpr int lse_smem() {
    return 2 * ssi::smem_round(LT * LDK * (int)sizeof(T)) + ssi::smem_round(LT * LDL * 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lse_partial_kernel(const T* __restrict__ h, const T* __restrict__ e,
                                                              float* __restrict__ m_part, float* __restrict__ l_part,
                                                              int N, int V, int D, int v_per_split) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int TILE = ssi::smem_round(LT * LDK * (int)sizeof(T));
    T* h_t = reinterpret_cast<T*>(smem);
    T* e_t = reinterpret_cast<T*>(smem + TILE);
    float* logit = reinterpret_cast<float*>(smem + 2 * TILE);

    const int t0 = blockIdx.x * LT;
    const int v_begin = blockIdx.y * v_per_split;
    const int v_end = min(V, v_begin + v_per_split);
    float m = NEG_INF;  // running max and sum of row threadIdx.x (threads < LT)
    float l = 0.f;
    for (int v0 = v_begin; v0 < v_end; v0 += LV) {
        __syncthreads();  // the previous tile's logits are read
        for (int i = threadIdx.x; i < LT * LDL; i += blockDim.x) logit[i] = 0.f;
        for (int k0 = 0; k0 < D; k0 += KC) {
            __syncthreads();
            ssi::load_rows<T, LT, KC, THREADS>(h_t, LDK, h + (long long)t0 * D + k0, D, N - t0);
            ssi::load_rows<T, LV, KC, THREADS>(e_t, LDK, e + (long long)v0 * D + k0, D, v_end - v0);
            __syncthreads();
            ssi::tile_mma<T, LT, LV, KC, false, true>(logit, LDL, h_t, LDK, e_t, LDK);  // h . E^T
        }
        __syncthreads();
        if (threadIdx.x < LT) {
            const float* row = logit + threadIdx.x * LDL;
            float tile_max = NEG_INF;
            for (int j = 0; j < LV; ++j) tile_max = fmaxf(tile_max, v0 + j < v_end ? row[j] : NEG_INF);
            const float m_new = fmaxf(m, tile_max);
            float sum = 0.f;
            for (int j = 0; j < LV; ++j) sum += expf((v0 + j < v_end ? row[j] : NEG_INF) - m_new);
            l = l * expf(m - m_new) + sum;
            m = m_new;
        }
    }
    if (threadIdx.x < LT && t0 + threadIdx.x < N) {
        const long long idx = (long long)blockIdx.y * N + t0 + threadIdx.x;
        m_part[idx] = m;
        l_part[idx] = l;
    }
}

__global__ void lse_merge_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                                 float* __restrict__ lse, int N, int n_split) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= N) return;
    float m = NEG_INF;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[(long long)s * N + t]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) l += l_part[(long long)s * N + t] * expf(m_part[(long long)s * N + t] - m);
    lse[t] = m + logf(fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t launch_lse(const void* h, const void* e, float* m_part, float* l_part, float* lse, int N, int V, int D,
                       int n_split, cudaStream_t stream) {
    const int v_per_split = ((V + n_split - 1) / n_split + LV - 1) / LV * LV;
    constexpr int smem = lse_smem<T>();
    cudaError_t err = cudaFuncSetAttribute(lse_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    lse_partial_kernel<T><<<dim3((N + LT - 1) / LT, n_split), THREADS, smem, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(e), m_part, l_part, N, V, D, v_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    lse_merge_kernel<<<(N + 255) / 256, 256, 0, stream>>>(m_part, l_part, lse, N, n_split);
    return cudaGetLastError();
}

// ---- backward: the dlogits pass and the dh / dE GEMMs ----------------------
//
// C [M x N] = sum over k of A(m, k) . B(k, n). An operand is "K-contiguous"
// when k runs along its rows in memory (A(m, k) = a[m * lda + k], B(k, n) =
// b[n * ldb + k]) and "outer-contiguous" otherwise (A(m, k) = a[k * lda + m],
// B(k, n) = b[k * ldb + n]):
//   dlogits = h . E^T          A = h (K-contiguous), B = E (K-contiguous), K = D
//   dh      = dlogits . E      A = dlogits (K-contiguous), B = E (outer), K = V
//   dE      = dlogits^T . h    A = dlogits (outer), B = h (outer), K = N

using bf16 = __nv_bfloat16;

constexpr int GT = 128;          // output tile edge
constexpr int GK = 64;           // K slab per pipeline stage
constexpr int STAGES = 3;        // cp.async ring depth (bf16)
constexpr int GTHREADS = 256;    // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int LDKS = GK + 8;     // shared stride of a K-contiguous slab [128][GK]: 144 bytes
constexpr int LDOS = GT + 8;     // shared stride of an outer-contiguous slab [GK][128]: 272 bytes
constexpr int FK = 16;           // K slab of the f32 kernel

template <bool K_CONTIG>
__host__ __device__ constexpr int slab_elems() {
    return K_CONTIG ? GT * LDKS : GK * LDOS;
}

// 102-108 KB: two blocks fit in an SM's 228 KB
template <bool A_K, bool B_K>
constexpr int gemm_smem() {
    return STAGES * (slab_elems<A_K>() + slab_elems<B_K>()) * (int)sizeof(bf16);
}

// Stage one operand's slab: outer index o in [o0, o0 + 128) (m for A, n for
// B), k in [k0, k0 + GK). Elements with o >= n_o or k >= n_k are zero-filled
// by the copy, so ragged tiles and the K tail need no other masking.
template <bool K_CONTIG>
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* __restrict__ x, int ld, int o0, int n_o, int k0,
                                          int n_k) {
#pragma unroll
    for (int i = 0; i < GT * GK / 8 / GTHREADS; ++i) {
        const int idx = threadIdx.x + i * GTHREADS;
        if (K_CONTIG) {
            const int r = idx / (GK / 8);
            const int c = (idx % (GK / 8)) * 8;
            const int o = o0 + r;
            const int k = k0 + c;
            const int n = o < n_o ? max(0, min(8, n_k - k)) : 0;
            ssi::cp_async16(dst + r * LDKS + c, n > 0 ? x + (long long)o * ld + k : x, 2 * n);
        } else {
            const int r = idx / (GT / 8);
            const int c = (idx % (GT / 8)) * 8;
            const int k = k0 + r;
            const int o = o0 + c;
            const int n = k < n_k ? max(0, min(8, n_o - o)) : 0;
            ssi::cp_async16(dst + r * LDOS + c, n > 0 ? x + (long long)k * ld + o : x, 2 * n);
        }
    }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x0, float x1) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Epilogue of the dlogits pass, on the logits of (token row, vocab columns
// col, col + 1): (exp(logit - lse) - onehot) * valid * g in T, into dl
// [N, ldv]; columns in [V, ldv) are written 0.
template <typename T>
struct DlogitsEpi {
    const float* lse;
    const int* labels;
    const float* g;
    T* dl;
    int N, V, ldv;
    __device__ __forceinline__ void operator()(int row, int col, float x0, float x1) const {
        if (row >= N || col >= ldv) return;
        const int lab = labels[row];
        float d0 = 0.f, d1 = 0.f;
        if (lab != IGNORE) {
            const float ls = lse[row];
            const float gg = *g;
            if (col < V) d0 = (expf(x0 - ls) - (col == lab ? 1.f : 0.f)) * gg;
            if (col + 1 < V) d1 = (expf(x1 - ls) - (col + 1 == lab ? 1.f : 0.f)) * gg;
        }
        store2(dl + (long long)row * ldv + col, d0, d1);
    }
};

// Epilogue of dh and dE: the f32 sums cast to T, into C [M, N] (N even).
template <typename T>
struct StoreEpi {
    T* c;
    int M, N;
    __device__ __forceinline__ void operator()(int row, int col, float x0, float x1) const {
        if (row < M && col < N) store2(c + (long long)row * N + col, x0, x1);
    }
};

// One block per 128 x 128 output tile; M_FAST puts M tiles on blockIdx.x, so
// neighbouring blocks share their B slab through L2 (else their A slab).
template <bool A_K, bool B_K, bool M_FAST, class Epi>
__global__ void __launch_bounds__(GTHREADS, 2) gemm_bf16_kernel(const bf16* __restrict__ a, int lda,
                                                                const bf16* __restrict__ b, int ldb, int M, int N,
                                                                int K, Epi epi) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int A_EL = slab_elems<A_K>();
    constexpr int B_EL = slab_elems<B_K>();
    bf16* as = reinterpret_cast<bf16*>(smem);
    bf16* bs = as + STAGES * A_EL;
    const int m0 = (M_FAST ? blockIdx.x : blockIdx.y) * GT;
    const int n0 = (M_FAST ? blockIdx.y : blockIdx.x) * GT;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = (warp / 4) * 64;  // the warp's rows and columns within the tile
    const int wn = (warp % 4) * 32;
    const int k_tiles = (K + GK - 1) / GK;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < k_tiles) {
            load_slab<A_K>(as + s * A_EL, a, lda, m0, M, s * GK, K);
            load_slab<B_K>(bs + s * B_EL, b, ldb, n0, N, s * GK, K);
        }
        ssi::cp_async_commit();
    }

    float acc[4][4][4];  // [m16 tile][n8 block][C fragment]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
        ssi::cp_async_wait<STAGES - 2>();  // slab kt has landed
        __syncthreads();                   // ... for every thread, and slab kt - 1 is consumed
        const int nk = kt + STAGES - 1;
        if (nk < k_tiles) {
            load_slab<A_K>(as + (nk % STAGES) * A_EL, a, lda, m0, M, nk * GK, K);
            load_slab<B_K>(bs + (nk % STAGES) * B_EL, b, ldb, n0, N, nk * GK, K);
        }
        ssi::cp_async_commit();
        const bf16* at = as + (kt % STAGES) * A_EL;
        const bf16* bt = bs + (kt % STAGES) * B_EL;
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk) {
            uint32_t af[4][4];
            uint32_t bfr[2][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                if (A_K) {
                    ssi::ldmatrix_x4(af[mi], at + (wm + mi * 16 + lane % 16) * LDKS + kk * 16 + (lane / 16) * 8);
                } else {
                    ssi::ldmatrix_x4_trans(
                        af[mi], at + (kk * 16 + (lane / 16) * 8 + lane % 8) * LDOS + wm + mi * 16 + ((lane / 8) % 2) * 8);
                }
            }
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                if (B_K) {
                    ssi::ldmatrix_x4(
                        bfr[np], bt + (wn + np * 16 + (lane / 16) * 8 + lane % 8) * LDKS + kk * 16 + ((lane / 8) % 2) * 8);
                } else {
                    ssi::ldmatrix_x4_trans(
                        bfr[np], bt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LDOS + wn + np * 16 + (lane / 16) * 8);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
                    ssi::mma_bf16(acc[mi][nj], af[mi], bfr[nj / 2][(nj % 2) * 2], bfr[nj / 2][(nj % 2) * 2 + 1]);
        }
    }

    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
            const int row = m0 + wm + mi * 16 + g;
            const int col = n0 + wn + nj * 8 + 2 * t4;
            epi(row, col, acc[mi][nj][0], acc[mi][nj][1]);
            epi(row + 8, col, acc[mi][nj][2], acc[mi][nj][3]);
        }
}

// The same tiling in f32 with scalar FMAs: thread (ty, tx) of a 16 x 16 grid
// owns rows {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}.
template <bool A_K, bool B_K, bool M_FAST, class Epi>
__global__ void __launch_bounds__(GTHREADS) gemm_f32_kernel(const float* __restrict__ a, int lda,
                                                            const float* __restrict__ b, int ldb, int M, int N, int K,
                                                            Epi epi) {
    __shared__ __align__(16) float as[FK][GT + 4];
    __shared__ __align__(16) float bs[FK][GT + 4];
    const int m0 = (M_FAST ? blockIdx.x : blockIdx.y) * GT;
    const int n0 = (M_FAST ? blockIdx.y : blockIdx.x) * GT;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += FK) {
        __syncthreads();  // the previous slab is consumed
#pragma unroll
        for (int i = 0; i < GT * FK / GTHREADS; ++i) {
            // neighbouring threads read neighbouring addresses of each operand
            const int idx = threadIdx.x + i * GTHREADS;
            const int ka = A_K ? idx % FK : idx / GT;
            const int ma = A_K ? idx / FK : idx % GT;
            const int m = m0 + ma;
            const int k = k0 + ka;
            as[ka][ma] = (m < M && k < K) ? a[A_K ? (long long)m * lda + k : (long long)k * lda + m] : 0.f;
            const int kb = B_K ? idx % FK : idx / GT;
            const int nb = B_K ? idx / FK : idx % GT;
            const int n = n0 + nb;
            const int kn = k0 + kb;
            bs[kb][nb] = (n < N && kn < K) ? b[B_K ? (long long)n * ldb + kn : (long long)kn * ldb + n] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) {
            float av[8], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                av[i] = as[kk][ty * 4 + i];
                av[4 + i] = as[kk][64 + ty * 4 + i];
                bv[i] = bs[kk][tx * 4 + i];
                bv[4 + i] = bs[kk][64 + tx * 4 + i];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
            const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
            epi(row, col, acc[i][j], acc[i][j + 1]);
        }
}

template <typename T, bool A_K, bool B_K, bool M_FAST, class Epi>
cudaError_t launch_gemm(const void* a, int lda, const void* b, int ldb, int M, int N, int K, Epi epi,
                        cudaStream_t stream) {
    const int tm = (M + GT - 1) / GT;
    const int tn = (N + GT - 1) / GT;
    const dim3 grid(M_FAST ? tm : tn, M_FAST ? tn : tm);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    if constexpr (std::is_same<T, float>::value) {
        gemm_f32_kernel<A_K, B_K, M_FAST, Epi><<<grid, GTHREADS, 0, stream>>>(
            static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb, M, N, K, epi);
    } else {
        constexpr int smem = gemm_smem<A_K, B_K>();
        cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<A_K, B_K, M_FAST, Epi>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        gemm_bf16_kernel<A_K, B_K, M_FAST, Epi><<<grid, GTHREADS, smem, stream>>>(
            static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb, M, N, K, epi);
    }
    return cudaGetLastError();
}

// cp.async reads 16-byte pieces: row strides a multiple of 8 elements and
// 16-byte aligned bases
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Vocab splits of the logsumexp grid for N tokens and V vocab rows: about
// LSE_BLOCKS blocks in all, and no split left empty by the rounding of a
// split to whole LV tiles. The caller sizes the [n_split, N] scratch by it.
extern "C" int ssi_cross_entropy_lse_splits(int N, int V) {
    if (N <= 0 || V <= 0) return 0;
    const int token_tiles = (N + LT - 1) / LT;
    const int n_split = std::max(1, std::min((LSE_BLOCKS + token_tiles - 1) / token_tiles, (V + LV - 1) / LV));
    const int v_per_split = ((V + n_split - 1) / n_split + LV - 1) / LV * LV;
    return (V + v_per_split - 1) / v_per_split;
}

extern "C" int ssi_cross_entropy_lse(int dtype, const void* h, const void* e, void* m_part, void* l_part, void* lse,
                                     int N, int V, int D, int n_split, void* stream) {
    if (N <= 0 || V <= 0 || D % KC != 0 || n_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
    float* mp = static_cast<float*>(m_part);
    float* lp = static_cast<float*>(l_part);
    float* out = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch_lse<float>(h, e, mp, lp, out, N, V, D, n_split, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch_lse<__nv_bfloat16>(h, e, mp, lp, out, N, V, D, n_split, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

// dlogits [N, V] (row stride ldv, V <= ldv, ldv % 8 == 0; pad columns written
// 0) from h [N, D], E [V, D], lse [N], labels [N] and the scalar g
extern "C" int ssi_cross_entropy_dlogits(int dtype, const void* h, const void* e, const void* lse,
                                         const void* labels, const void* g, void* dl, int N, int V, int D, int ldv,
                                         void* stream) {
    if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0 || ldv < V || !aligned16(h) || !aligned16(e) ||
        !aligned16(dl))
        return static_cast<int>(cudaErrorInvalidValue);
    const float* lsep = static_cast<const float*>(lse);
    const int* lab = static_cast<const int*>(labels);
    const float* gp = static_cast<const float*>(g);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        const DlogitsEpi<float> epi{lsep, lab, gp, static_cast<float*>(dl), N, V, ldv};
        err = launch_gemm<float, true, true, true>(h, D, e, D, N, V, D, epi, st);
    } else if (dtype == ssi::kBFloat16) {
        const DlogitsEpi<bf16> epi{lsep, lab, gp, static_cast<bf16*>(dl), N, V, ldv};
        err = launch_gemm<bf16, true, true, true>(h, D, e, D, N, V, D, epi, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

// dh [N, D] = dlogits [N, V] (row stride ldv) . E [V, D]
extern "C" int ssi_cross_entropy_dh(int dtype, const void* dl, const void* e, void* dh, int N, int V, int D, int ldv,
                                    void* stream) {
    if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0 || ldv < V || !aligned16(dl) || !aligned16(e))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch_gemm<float, true, false, false>(dl, ldv, e, D, N, D, V,
                                                     StoreEpi<float>{static_cast<float*>(dh), N, D}, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch_gemm<bf16, true, false, false>(dl, ldv, e, D, N, D, V,
                                                    StoreEpi<bf16>{static_cast<bf16*>(dh), N, D}, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

// dE [V, D] = dlogits^T . h, dlogits [N, V] (row stride ldv), h [N, D]
extern "C" int ssi_cross_entropy_de(int dtype, const void* dl, const void* h, void* de, int N, int V, int D, int ldv,
                                    void* stream) {
    if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || ldv % 8 != 0 || ldv < V || !aligned16(dl) || !aligned16(h))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch_gemm<float, false, false, false>(dl, ldv, h, D, V, D, N,
                                                      StoreEpi<float>{static_cast<float*>(de), V, D}, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch_gemm<bf16, false, false, false>(dl, ldv, h, D, V, D, N,
                                                     StoreEpi<bf16>{static_cast<bf16*>(de), V, D}, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
