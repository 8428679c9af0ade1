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
// Where each product runs. bf16: on the Hopper GEMM of
// cross_entropy_hopper.cu (wgmma fed by TMA; one persistent kernel template,
// an epilogue per product), all four of N x V x D at N 4096, D 2048,
// V 133,258 (2.24 TFLOP each):
// - lse: the logits h . E^T with a row-reduction epilogue in registers: per
//   token row and 256-column vocab tile one (max, sum of exp) pair, into a
//   [n_vtiles, N] f32 scratch (17 MB at N 4,096, V 133,258) that the merge
//   pass below reduces in a fixed order. The logits never leave registers;
// - backward: the TPU kernels formed dlogits tile by tile twice, once inside
//   dh and once inside dE. Here one GEMM pass forms the logits once and
//   writes dlogits in the operand dtype to a scratch [N, ldv] (ldv = V
//   rounded up to 8, so every row is 16-byte aligned; pad columns are 0), and
//   two GEMMs read it: dh = dlogits . E (K = V) and dE = dlogits^T . h
//   (K = N). At N 4096 the scratch is 1.09 GB in bf16, written once and read
//   twice, against the 6.7 TFLOP of the three products.
// Each output tile sums its whole K in one block, in a fixed order: no
// atomics, so two launches give the same bits.
// The f32 parity paths keep exact f32 arithmetic (TF32 would not meet the
// f32 limits): the backward runs 128 x 128 tiles with scalar FMAs; the lse
// runs one block per (64-token tile, vocab split), streaming 64-row vocab
// tiles through shared memory with a running max and sum, and the same
// merge kernel.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tile_mma.cuh"

namespace ssi {
// the bf16 products (cross_entropy_hopper.cu)
int cross_entropy_lse_hopper_splits(int V);
cudaError_t cross_entropy_lse_hopper_bf16(const void* h, const void* e, float* m_part, float* l_part, int N, int V,
                                          int D, cudaStream_t stream);
cudaError_t cross_entropy_dlogits_hopper_bf16(const void* h, const void* e, const float* lse, const int* labels,
                                              const float* g, void* dl, int N, int V, int D, int ldv,
                                              cudaStream_t stream);
cudaError_t cross_entropy_dh_hopper_bf16(const void* dl, const void* e, void* dh, int N, int V, int D, int ldv,
                                         cudaStream_t stream);
cudaError_t cross_entropy_de_hopper_bf16(const void* dl, const void* h, void* de, int N, int V, int D, int ldv,
                                         cudaStream_t stream);
}  // namespace ssi

namespace {

constexpr int THREADS = 256;
constexpr int KC = 128;        // D chunk staged per step
constexpr int LDK = KC + 8;    // leading dimension of staged operand chunks
constexpr int IGNORE = -100;   // CROSS_ENTROPY_IGNORE_IDX
constexpr float NEG_INF = -1.0e30f;

// ---- forward, f32: logsumexp by scalar FMAs (parity path) ------------------

constexpr int LT = 64;         // tokens per lse block
constexpr int LV = 64;         // vocab rows per streamed tile
constexpr int LDL = LV + 4;    // leading dimension of the f32 logits tile
constexpr int LSE_BLOCKS = 1056;  // lse blocks to aim for: 8 per SM of an H100's 132

constexpr int lse_f32_smem() {
    return 2 * ssi::smem_round(LT * LDK * 4) + ssi::smem_round(LT * LDL * 4);
}

// One block per (64-token tile, vocab split): 64-row vocab tiles of the split
// stream through shared memory in 128-wide D chunks (any D a multiple of 8:
// the last chunk's columns past D are zeros); a running max and sum
// per token; the (max, sum) of each split goes to m_part / l_part [n_split, N].
__global__ void __launch_bounds__(THREADS) lse_partial_f32_kernel(const float* __restrict__ h,
                                                                  const float* __restrict__ e,
                                                                  float* __restrict__ m_part,
                                                                  float* __restrict__ l_part, int N, int V, int D,
                                                                  int v_per_split) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int TILE = ssi::smem_round(LT * LDK * 4);
    float* h_t = reinterpret_cast<float*>(smem);
    float* e_t = reinterpret_cast<float*>(smem + TILE);
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
            // the last chunk of a D that is not a multiple of KC: columns past D read as 0
            ssi::load_rows<float, LT, KC, THREADS>(h_t, LDK, h + (long long)t0 * D + k0, D, N - t0, D - k0);
            ssi::load_rows<float, LV, KC, THREADS>(e_t, LDK, e + (long long)v0 * D + k0, D, v_end - v0, D - k0);
            __syncthreads();
            ssi::tile_mma<LT, LV, KC, false, true>(logit, LDL, h_t, LDK, e_t, LDK);  // h . E^T
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

// Vocab splits of the f32 grid: about LSE_BLOCKS blocks in all, and no split
// left empty by the rounding of a split to whole LV tiles.
int lse_f32_splits(int N, int V) {
    const int token_tiles = (N + LT - 1) / LT;
    const int n_split = std::max(1, std::min((LSE_BLOCKS + token_tiles - 1) / token_tiles, (V + LV - 1) / LV));
    const int v_per_split = ((V + n_split - 1) / n_split + LV - 1) / LV * LV;
    return (V + v_per_split - 1) / v_per_split;
}

// lse [N] from the per-split (max, sum) pairs [n_split, N], merged in a fixed
// order: a block of 8 warps takes 32 tokens (one per lane); warp w merges
// splits w, w + 8, ... and the 8 partial pairs are merged in warp order.
// l_part null: every sum is 1 (each split's m is already its logsumexp).
constexpr int MERGE_TOKENS = 32;
constexpr int MERGE_WARPS = 8;

__global__ void __launch_bounds__(MERGE_TOKENS * MERGE_WARPS) lse_merge_kernel(const float* __restrict__ m_part,
                                                                               const float* __restrict__ l_part,
                                                                               float* __restrict__ lse, int N,
                                                                               int n_split) {
    __shared__ float m_sm[MERGE_WARPS][MERGE_TOKENS];
    __shared__ float l_sm[MERGE_WARPS][MERGE_TOKENS];
    const int lane = threadIdx.x % MERGE_TOKENS;
    const int w = threadIdx.x / MERGE_TOKENS;
    const int t = blockIdx.x * MERGE_TOKENS + lane;
    float m = NEG_INF;
    float l = 0.f;
    if (t < N) {
        for (int s = w; s < n_split; s += MERGE_WARPS) {
            const float ms = m_part[(long long)s * N + t];
            const float mn = fmaxf(m, ms);
            const float ls = l_part != nullptr ? l_part[(long long)s * N + t] : 1.f;
            l = l * expf(m - mn) + ls * expf(ms - mn);
            m = mn;
        }
    }
    m_sm[w][lane] = m;
    l_sm[w][lane] = l;
    __syncthreads();
    if (w == 0 && t < N) {
        float mm = NEG_INF;
        for (int i = 0; i < MERGE_WARPS; ++i) mm = fmaxf(mm, m_sm[i][lane]);
        float ll = 0.f;
        for (int i = 0; i < MERGE_WARPS; ++i) ll += l_sm[i][lane] * expf(m_sm[i][lane] - mm);
        lse[t] = mm + logf(fmaxf(ll, 1e-30f));
    }
}

cudaError_t launch_merge(const float* m_part, const float* l_part, float* lse, int N, int n_split,
                         cudaStream_t stream) {
    lse_merge_kernel<<<(N + MERGE_TOKENS - 1) / MERGE_TOKENS, MERGE_TOKENS * MERGE_WARPS, 0, stream>>>(
        m_part, l_part, lse, N, n_split);
    return cudaGetLastError();
}

cudaError_t launch_lse_f32(const float* h, const float* e, float* m_part, float* l_part, float* lse, int N, int V,
                           int D, int n_split, cudaStream_t stream) {
    const int v_per_split = ((V + n_split - 1) / n_split + LV - 1) / LV * LV;
    constexpr int smem = lse_f32_smem();
    cudaError_t err = cudaFuncSetAttribute(lse_partial_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    lse_partial_f32_kernel<<<dim3((N + LT - 1) / LT, n_split), THREADS, smem, stream>>>(h, e, m_part, l_part, N, V,
                                                                                         D, v_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_merge(m_part, l_part, lse, N, n_split, stream);
}

// ---- the GEMM core of the f32 backward ------------------------------------
//
// C [M x N] = sum over k of A(m, k) . B(k, n). An operand is "K-contiguous"
// when k runs along its rows in memory (A(m, k) = a[m * lda + k], B(k, n) =
// b[n * ldb + k]) and "outer-contiguous" otherwise (A(m, k) = a[k * lda + m],
// B(k, n) = b[k * ldb + n]):
//   logits  = h . E^T          A = h (K-contiguous), B = E (K-contiguous), K = D
//   dh      = dlogits . E      A = dlogits (K-contiguous), B = E (outer), K = V
//   dE      = dlogits^T . h    A = dlogits (outer), B = h (outer), K = N

constexpr int GT = 128;          // output tile edge
constexpr int GTHREADS = 256;    // a 16 x 16 thread grid
constexpr int FK = 16;           // K slab

// Epilogues of the f32 kernel, called on (row, columns col, col + 1) of the
// tile's sums.
// The dlogits pass: (exp(logit - lse) - onehot) * valid * g into dl [N, ldv];
// columns in [V, ldv) are written 0.
struct DlogitsEpi {
    const float* lse;
    const int* labels;
    const float* g;
    float* dl;
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
        *reinterpret_cast<float2*>(dl + (long long)row * ldv + col) = make_float2(d0, d1);
    }
};

// dh and dE: the sums into C [M, N] (N even).
struct StoreEpi {
    float* c;
    int M, N;
    __device__ __forceinline__ void operator()(int row, int col, float x0, float x1) const {
        if (row < M && col < N) *reinterpret_cast<float2*>(c + (long long)row * N + col) = make_float2(x0, x1);
    }
};

// 128 x 128 output tiles in f32 with scalar FMAs: thread (ty, tx) of a 16 x 16 grid
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

template <bool A_K, bool B_K, bool M_FAST, class Epi>
cudaError_t launch_gemm_f32(const void* a, int lda, const void* b, int ldb, int M, int N, int K, Epi epi,
                            cudaStream_t stream) {
    const int tm = (M + GT - 1) / GT;
    const int tn = (N + GT - 1) / GT;
    const dim3 grid(M_FAST ? tm : tn, M_FAST ? tn : tm);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_f32_kernel<A_K, B_K, M_FAST, Epi><<<grid, GTHREADS, 0, stream>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb, M, N, K, epi);
    return cudaGetLastError();
}

// TMA reads 16-byte aligned bases (row strides a multiple of 8 elements)
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Splits of the logsumexp for N tokens and V vocab rows: the rows of its
// (max, sum) scratch [n_split, N], which the caller allocates. bf16: one per
// 256-column vocab tile of the Hopper GEMM; f32: the vocab splits of its grid.
extern "C" int ssi_cross_entropy_lse_splits(int dtype, int N, int V) {
    if (N <= 0 || V <= 0) return 0;
    if (dtype == ssi::kBFloat16) return ssi::cross_entropy_lse_hopper_splits(V);
    if (dtype == ssi::kFloat32) return lse_f32_splits(N, V);
    return 0;
}

// lse [N] of h [N, D] . E [V, D]^T; m_part / l_part are [n_split, N] scratch
extern "C" int ssi_cross_entropy_lse(int dtype, const void* h, const void* e, void* m_part, void* l_part, void* lse,
                                     int N, int V, int D, int n_split, void* stream) {
    if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || n_split != ssi_cross_entropy_lse_splits(dtype, N, V))
        return static_cast<int>(cudaErrorInvalidValue);
    float* mp = static_cast<float*>(m_part);
    float* lp = static_cast<float*>(l_part);
    float* out = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch_lse_f32(static_cast<const float*>(h), static_cast<const float*>(e), mp, lp, out, N, V, D, n_split,
                             st);
    } else {
        err = ssi::cross_entropy_lse_hopper_bf16(h, e, mp, lp, N, V, D, st);  // the Hopper GEMM
        if (err == cudaSuccess) err = launch_merge(mp, lp, out, N, n_split, st);
    }
    return static_cast<int>(err);
}

// lse [N] from (max, sum) pairs m_part / l_part [n_split, N] of vocabulary
// slices, merged in slice order by the logsumexp's own merge pass; l_part
// null means every sum is 1: the tensor-parallel loss passes each rank's
// slice lse as m alone
extern "C" int ssi_cross_entropy_lse_merge(const void* m_part, const void* l_part, void* lse, int N, int n_split,
                                           void* stream) {
    if (N <= 0 || n_split <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_merge(static_cast<const float*>(m_part), static_cast<const float*>(l_part),
                                         static_cast<float*>(lse), N, n_split, static_cast<cudaStream_t>(stream)));
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
        const DlogitsEpi epi{lsep, lab, gp, static_cast<float*>(dl), N, V, ldv};
        err = launch_gemm_f32<true, true, true>(h, D, e, D, N, V, D, epi, st);
    } else if (dtype == ssi::kBFloat16) {  // the Hopper GEMM (cross_entropy_hopper.cu)
        err = ssi::cross_entropy_dlogits_hopper_bf16(h, e, lsep, lab, gp, dl, N, V, D, ldv, st);
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
        err = launch_gemm_f32<true, false, false>(dl, ldv, e, D, N, D, V, StoreEpi{static_cast<float*>(dh), N, D}, st);
    } else if (dtype == ssi::kBFloat16) {  // the Hopper GEMM (cross_entropy_hopper.cu)
        err = ssi::cross_entropy_dh_hopper_bf16(dl, e, dh, N, V, D, ldv, st);
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
        err = launch_gemm_f32<false, false, false>(dl, ldv, h, D, V, D, N, StoreEpi{static_cast<float*>(de), V, D}, st);
    } else if (dtype == ssi::kBFloat16) {  // the Hopper GEMM (cross_entropy_hopper.cu)
        err = ssi::cross_entropy_de_hopper_bf16(dl, h, de, N, V, D, ldv, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
