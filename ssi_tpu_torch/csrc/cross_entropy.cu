// Fused cross-entropy over the output matrix E [V, D] from hidden states
// h [N, D]: the streaming logsumexp of h . E^T (forward) and the two
// gradients dh = dlogits . E and dE = dlogits^T . h (backward), where
// dlogits = (softmax - onehot) * valid * g never leaves the block. bf16
// operands on the tensor cores with f32 accumulation, or f32 throughout.
//
// Replaces the TPU kernels ssi_tpu/ops/cross_entropy_pallas.py `_lse_kernel`
// (via `_compute_lse`), `_dh_kernel` and `_de_kernel` (via `_bwd_rule`).
// Semantics kept: vocab columns at or past V count as -1e30 logits (the TPU
// kernels pad E and mask them), ignored labels (-100) and token rows at or
// past N give zero dlogits, the upstream scalar g multiplies dlogits, and
// dlogits is cast to the operand dtype before the dh and dE products.
//
// What bounds it on Hopper: three [N, D] x [D, V]-class products per
// logits pass at N 4096, D 2048, V 133,258 (2.24 TFLOP each; dh and dE each
// recompute the logits, so two passes each). The TPU kernels held [512, 2048]
// and [2048, 2048] f32 accumulators in VMEM; a Hopper block has 227 KB of
// shared memory, so the accumulators are cut:
// - lse: one block per (64-token tile, vocab split); it streams 64-row vocab
//   tiles of its split through shared memory in 128-wide D chunks and keeps
//   a running max and sum per token. A token-tile grid alone gives only N/64
//   blocks, so the vocab is split across blocks and a second small kernel
//   merges the per-split (max, sum) pairs in a fixed order (deterministic,
//   no atomics);
// - dh and dE are one kernel with the roles of h and E swapped: one block per
//   16-row tile of its output (tokens for dh, vocab rows for dE) holds that
//   tile's gradient rows [16, D] in f32 shared memory (128 KB at D 2048) and
//   streams 128-row tiles of the other operand twice: once in D chunks to form
//   the [16, 128] logits, and once more to add dlogits . tile to the rows.
//   Every output row belongs to one block, so there are no cross-block sums.
// Products are wmma 16x16x16 fragments from shared memory (tile_mma.cuh).
// Each block re-reads the streamed operand from L2; wgmma, TMA and larger
// register-held tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"
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

// ---- backward: dh (rows are tokens) and dE (rows are vocab entries) --------

constexpr int GR = 16;         // output rows per block
constexpr int GX = 128;        // rows of the streamed operand per tile
constexpr int LDX = GX + 4;    // leading dimension of the f32 logits tile
constexpr int LDD = GX + 8;    // leading dimension of the dlogits tile

template <typename T>
struct GradSmem {
    static constexpr int R = ssi::smem_round(GR * LDK * (int)sizeof(T));
    static constexpr int X = ssi::smem_round(GX * LDK * (int)sizeof(T));
    static constexpr int LOGIT = ssi::smem_round(GR * LDX * 4);
    static constexpr int DL = ssi::smem_round(GR * LDD * (int)sizeof(T));
    static constexpr int SCAL = ssi::smem_round(GX * 4);
    static __host__ __device__ constexpr int acc(int D) { return ssi::smem_round(GR * (D + 4) * 4); }
    static __host__ __device__ constexpr int total(int D) { return acc(D) + R + X + LOGIT + DL + 2 * SCAL; }
};

template <typename T, bool ROWS_ARE_TOKENS>
__global__ void __launch_bounds__(THREADS) grad_kernel(const T* __restrict__ h, const T* __restrict__ e,
                                                       const float* __restrict__ lse, const int* __restrict__ labels,
                                                       const float* __restrict__ g_ptr, T* __restrict__ out,
                                                       int N, int V, int D) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = GradSmem<T>;
    const int ldacc = D + 4;
    float* acc = reinterpret_cast<float*>(smem);
    unsigned char* p = smem + L::acc(D);
    T* r_t = reinterpret_cast<T*>(p);
    T* x_t = reinterpret_cast<T*>(p + L::R);
    float* logit = reinterpret_cast<float*>(p + L::R + L::X);
    T* dl = reinterpret_cast<T*>(p + L::R + L::X + L::LOGIT);
    float* lse_s = reinterpret_cast<float*>(p + L::R + L::X + L::LOGIT + L::DL);  // per token of the tile
    int* lab_s = reinterpret_cast<int*>(p + L::R + L::X + L::LOGIT + L::DL + L::SCAL);

    const T* rows = ROWS_ARE_TOKENS ? h : e;
    const T* xs = ROWS_ARE_TOKENS ? e : h;
    const int n_rows = ROWS_ARE_TOKENS ? N : V;
    const int n_x = ROWS_ARE_TOKENS ? V : N;
    const int r0 = blockIdx.x * GR;
    const float g = *g_ptr;

    for (int i = threadIdx.x; i < GR * ldacc; i += blockDim.x) acc[i] = 0.f;
    if (ROWS_ARE_TOKENS) {
        for (int i = threadIdx.x; i < GR; i += blockDim.x) {
            lse_s[i] = r0 + i < N ? lse[r0 + i] : 0.f;
            lab_s[i] = r0 + i < N ? labels[r0 + i] : IGNORE;
        }
    }
    for (int x0 = 0; x0 < n_x; x0 += GX) {
        __syncthreads();  // the previous tile's dlogits product and scalars are done
        for (int i = threadIdx.x; i < GR * LDX; i += blockDim.x) logit[i] = 0.f;
        if (!ROWS_ARE_TOKENS) {
            for (int i = threadIdx.x; i < GX; i += blockDim.x) {
                lse_s[i] = x0 + i < N ? lse[x0 + i] : 0.f;
                lab_s[i] = x0 + i < N ? labels[x0 + i] : IGNORE;
            }
        }
        for (int k0 = 0; k0 < D; k0 += KC) {
            __syncthreads();
            ssi::load_rows<T, GR, KC, THREADS>(r_t, LDK, rows + (long long)r0 * D + k0, D, n_rows - r0);
            ssi::load_rows<T, GX, KC, THREADS>(x_t, LDK, xs + (long long)x0 * D + k0, D, n_x - x0);
            __syncthreads();
            ssi::tile_mma<T, GR, GX, KC, false, true>(logit, LDX, r_t, LDK, x_t, LDK);  // rows . tile^T
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < GR * GX; idx += blockDim.x) {
            const int i = idx / GX;
            const int j = idx % GX;
            const int tok = ROWS_ARE_TOKENS ? r0 + i : x0 + j;
            const int voc = ROWS_ARE_TOKENS ? x0 + j : r0 + i;
            const int ts = ROWS_ARE_TOKENS ? i : j;  // the token's slot in lse_s / lab_s
            const int lab = lab_s[ts];
            const bool valid = tok < N && voc < V && lab != IGNORE;
            const float d = valid ? (expf(logit[i * LDX + j] - lse_s[ts]) - (voc == lab ? 1.f : 0.f)) * g : 0.f;
            dl[i * LDD + j] = ssi::from_f32<T>(d);
        }
        for (int d0 = 0; d0 < D; d0 += KC) {
            __syncthreads();  // dl written; the previous chunk's product is done with x_t
            ssi::load_rows<T, GX, KC, THREADS>(x_t, LDK, xs + (long long)x0 * D + d0, D, n_x - x0);
            __syncthreads();
            ssi::tile_mma<T, GR, KC, GX, false, false>(acc + d0, ldacc, dl, LDD, x_t, LDK);  // += dlogits . tile
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < GR * D; idx += blockDim.x) {
        const int i = idx / D;
        const int c = idx % D;
        if (r0 + i < n_rows) out[(long long)(r0 + i) * D + c] = ssi::from_f32<T>(acc[i * ldacc + c]);
    }
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

template <typename T, bool ROWS_ARE_TOKENS>
cudaError_t launch_grad(const void* h, const void* e, const float* lse, const int* labels, const float* g, void* out,
                        int N, int V, int D, cudaStream_t stream) {
    const int smem = GradSmem<T>::total(D);
    // more than one H100 block's shared memory: D past 2688 for bf16, past 2048 for f32
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(grad_kernel<T, ROWS_ARE_TOKENS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int n_rows = ROWS_ARE_TOKENS ? N : V;
    grad_kernel<T, ROWS_ARE_TOKENS><<<(n_rows + GR - 1) / GR, THREADS, smem, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(e), lse, labels, g, static_cast<T*>(out), N, V, D);
    return cudaGetLastError();
}

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

extern "C" int ssi_cross_entropy_grad(int dtype, int rows_are_tokens, const void* h, const void* e, const void* lse,
                                      const void* labels, const void* g, void* out, int N, int V, int D,
                                      void* stream) {
    if (N <= 0 || V <= 0 || D % KC != 0) return static_cast<int>(cudaErrorInvalidValue);
    const float* lsep = static_cast<const float*>(lse);
    const int* lab = static_cast<const int*>(labels);
    const float* gp = static_cast<const float*>(g);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = rows_are_tokens ? launch_grad<float, true>(h, e, lsep, lab, gp, out, N, V, D, st)
                              : launch_grad<float, false>(h, e, lsep, lab, gp, out, N, V, D, st);
    } else if (dtype == ssi::kBFloat16) {
        err = rows_are_tokens ? launch_grad<__nv_bfloat16, true>(h, e, lsep, lab, gp, out, N, V, D, st)
                              : launch_grad<__nv_bfloat16, false>(h, e, lsep, lab, gp, out, N, V, D, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
