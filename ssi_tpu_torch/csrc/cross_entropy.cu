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
// 227 KB of shared memory, so all four passes (lse, dlogits, dh, dE) run on
// one GEMM kernel template: 128 x 128 output tiles, 8 warps of 64 x 32,
// mma.sync m16n8k16 (mma.cuh) fed by ldmatrix (.trans for an operand whose
// rows run along M or N rather than K) from a 3-stage cp.async ring of
// 64-deep K slabs, accumulators in registers, and an epilogue applied to the
// accumulator tile from registers. Each output tile belongs to one block,
// which sums the whole K in a fixed order: no atomics, so two launches give
// the same bits.
// - lse: the logits product h . E^T with a row-reduction epilogue: per token
//   row and 128-column vocab tile one (max, sum of exp) pair, into a
//   [n_vtiles, N] f32 scratch (34 MB at N 4,096, V 133,258) that a second
//   small kernel merges in a fixed order. The logits never leave registers.
//   The alternative, blocks that walk a range of vocab tiles with a running
//   (max, sum), was not built: it would restart the GEMM's ring per tile,
//   and the scratch costs ~70 MB of traffic (computed from the shapes)
//   against the 2.24 TFLOP product; on the H100 the whole lse measures
//   faster than the dlogits pass, which runs the same product and writes
//   1.09 GB besides (PERF.md).
// - backward: the TPU kernels formed dlogits tile by tile twice, once inside
//   dh and once inside dE. Here one GEMM pass forms the logits once and
//   writes dlogits in the operand dtype to a scratch [N, ldv] (ldv = V
//   rounded up to 8, so every row is 16-byte aligned; pad columns are 0), and
//   two GEMMs read it: dh = dlogits . E (K = V) and dE = dlogits^T . h
//   (K = N). At N 4096 the scratch is 1.09 GB in bf16, written once and read
//   twice, against the 6.7 TFLOP of the three products.
// The f32 parity paths keep exact f32 arithmetic (TF32 would not meet the
// f32 limits): the backward runs the same tiling with scalar FMAs; the lse
// runs one block per (64-token tile, vocab split), streaming 64-row vocab
// tiles through shared memory with a running max and sum, and the same
// merge kernel.

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

// ---- forward, f32: logsumexp by scalar FMAs (parity path) ------------------

constexpr int LT = 64;         // tokens per lse block
constexpr int LV = 64;         // vocab rows per streamed tile
constexpr int LDL = LV + 4;    // leading dimension of the f32 logits tile
constexpr int LSE_BLOCKS = 1056;  // lse blocks to aim for: 8 per SM of an H100's 132
constexpr float LOG2E = 1.4426950408889634f;

constexpr int lse_f32_smem() {
    return 2 * ssi::smem_round(LT * LDK * 4) + ssi::smem_round(LT * LDL * 4);
}

// One block per (64-token tile, vocab split): 64-row vocab tiles of the split
// stream through shared memory in 128-wide D chunks; a running max and sum
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
            ssi::load_rows<float, LT, KC, THREADS>(h_t, LDK, h + (long long)t0 * D + k0, D, N - t0);
            ssi::load_rows<float, LV, KC, THREADS>(e_t, LDK, e + (long long)v0 * D + k0, D, v_end - v0);
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
            l = l * expf(m - mn) + l_part[(long long)s * N + t] * expf(ms - mn);
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

// Epilogues. The bf16 kernel hands each warp's accumulator tile to
// `epi.tile(acc, m0, n0, wm, wn, smem)`: acc[mi][nj] is the C fragment of rows
// m0 + wm + mi * 16 + (g, g + 8) and columns n0 + wn + nj * 8 + 2 * t4 (+ 1),
// and smem is the operand ring, free once the block has synchronised. The
// per-element epilogues walk it pair by pair (`each_pair`); the f32 kernel
// calls `epi(row, col, x0, x1)` directly.
template <class Epi>
__device__ __forceinline__ void each_pair(const Epi& epi, const float (&acc)[4][4][4], int r0, int c0) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
            const int row = r0 + mi * 16 + g;
            const int col = c0 + nj * 8 + 2 * t4;
            epi(row, col, acc[mi][nj][0], acc[mi][nj][1]);
            epi(row + 8, col, acc[mi][nj][2], acc[mi][nj][3]);
        }
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
    __device__ __forceinline__ void tile(const float (&acc)[4][4][4], int m0, int n0, int wm, int wn,
                                         unsigned char*) const {
        each_pair(*this, acc, m0 + wm, n0 + wn);
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
    __device__ __forceinline__ void tile(const float (&acc)[4][4][4], int m0, int n0, int wm, int wn,
                                         unsigned char*) const {
        each_pair(*this, acc, m0 + wm, n0 + wn);
    }
};

// Epilogue of the logsumexp (bf16): for each token row of the 128 x 128
// logits tile, the max m over its vocab columns below V (columns at or past V
// count as -1e30) and l = sum of exp(logit - m), written to m_part / l_part
// [n_vtiles, N] at the tile's vocab index n0 / 128. A thread reduces its 8
// columns of each of its rows, quad shuffles give the warp's 32, and the 4
// warps along N are merged in a fixed order through shared memory.
struct LseEpi {
    float* m_part;
    float* l_part;
    int N, V;
    __device__ __forceinline__ void tile(const float (&acc)[4][4][4], int m0, int n0, int wm, int wn,
                                         unsigned char* smem) const {
        const int lane = threadIdx.x % 32;
        const int g = lane / 4;
        const int t4 = lane % 4;
        float* red_m = reinterpret_cast<float*>(smem);  // [4 warps along N][GT rows]
        float* red_l = red_m + 4 * GT;
        __syncthreads();  // every warp is done with the operand ring, which holds red_m / red_l from here
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                float x[8];
                bool ok[8];
                float m = NEG_INF;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    ok[i] = n0 + wn + (i / 2) * 8 + 2 * t4 + i % 2 < V;
                    x[i] = ok[i] ? acc[mi][i / 2][2 * hi + i % 2] : NEG_INF;
                    m = fmaxf(m, x[i]);
                }
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                float l = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) l += ok[i] ? exp2f((x[i] - m) * LOG2E) : 0.f;
                l += __shfl_xor_sync(0xffffffffu, l, 1);
                l += __shfl_xor_sync(0xffffffffu, l, 2);
                if (t4 == 0) {
                    const int r = wm + mi * 16 + hi * 8 + g;
                    red_m[(wn / 32) * GT + r] = m;
                    red_l[(wn / 32) * GT + r] = l;
                }
            }
        }
        __syncthreads();
        const int r = threadIdx.x;
        if (r < GT && m0 + r < N) {
            float m = NEG_INF;
#pragma unroll
            for (int w = 0; w < 4; ++w) m = fmaxf(m, red_m[w * GT + r]);
            float l = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) l += red_l[w * GT + r] * exp2f((red_m[w * GT + r] - m) * LOG2E);
            const long long idx = (long long)(n0 / GT) * N + m0 + r;
            m_part[idx] = m;
            l_part[idx] = l;
        }
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

    epi.tile(acc, m0, n0, wm, wn, smem);
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

// Splits of the logsumexp for N tokens and V vocab rows: the rows of its
// (max, sum) scratch [n_split, N], which the caller allocates. bf16: one per
// 128-column vocab tile of the GEMM; f32: the vocab splits of its grid.
extern "C" int ssi_cross_entropy_lse_splits(int dtype, int N, int V) {
    if (N <= 0 || V <= 0) return 0;
    if (dtype == ssi::kBFloat16) return (V + GT - 1) / GT;
    if (dtype == ssi::kFloat32) return lse_f32_splits(N, V);
    return 0;
}

// lse [N] of h [N, D] . E [V, D]^T; m_part / l_part are [n_split, N] scratch
extern "C" int ssi_cross_entropy_lse(int dtype, const void* h, const void* e, void* m_part, void* l_part, void* lse,
                                     int N, int V, int D, int n_split, void* stream) {
    if (N <= 0 || V <= 0 || D % KC != 0 || n_split != ssi_cross_entropy_lse_splits(dtype, N, V))
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
        if (!aligned16(h) || !aligned16(e)) return static_cast<int>(cudaErrorInvalidValue);
        // the logits product h . E^T on the GEMM core (as the dlogits pass), reduced per row and vocab tile
        err = launch_gemm<bf16, true, true, true>(h, D, e, D, N, V, D, LseEpi{mp, lp, N, V}, st);
        if (err == cudaSuccess) err = launch_merge(mp, lp, out, N, n_split, st);
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
