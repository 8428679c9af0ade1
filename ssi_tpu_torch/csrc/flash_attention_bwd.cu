// Flash-attention backward (causal or full GQA, optional packed segment ids)
// for head_dim 64: dq, dk, dv from q, k, v, the forward's o and lse, and do.
// bf16 operands on the tensor cores with f32 accumulation, or f32 throughout.
//
// Replaces the TPU kernels ssi_tpu/ops/flash_attention.py `_bwd_kernel` and
// `_bwd_kernel_grouped` (one GQA schedule ports both). Semantics kept: the
// scores are recomputed as S = scale * q.k (the port's forward takes unscaled
// q and applies scale = 1/sqrt(64) inside, so the scale is applied here to S
// and multiplied into dq and dk), P = exp(S - lse) with masked entries set to
// 0 explicitly (a fully masked row gives zero gradients), delta = rowsum(o.do)
// in f32, dS = P * (dP - delta); P and dS are cast to the operand dtype before
// the dV, dK and dQ products, as the TPU kernel casts them.
//
// What bounds it on Hopper: the five S^2 * d products (S, dP, dV, dK, dQ) of
// training at B 2, S 2048, 32 q / 8 kv heads. The TPU kernel ran its grid in
// sequence and accumulated dk/dv across revisited output blocks; CUDA blocks
// run in parallel, so this port takes the deterministic two-kernel layout and
// uses no atomics (gradients are bitwise reproducible run to run):
// - delta kernel: one thread per (b, s, q head) row, rowsum(o * do) in f32;
// - dk/dv kernel: one block per (batch, kv head, 64-key tile); K and V tiles
//   stay in shared memory while the block loops over the q tiles at and after
//   the causal diagonal and over the n_rep q heads of its kv head, holding
//   the dK and dV sums in f32 shared memory;
// - dq kernel: one block per (batch, q head, 64-query tile), looping over the
//   key tiles up to the diagonal and holding dQ in f32 shared memory.
// Each block recomputes S and dP for its tile pairs (the price of no atomics:
// S and dP are formed twice, once per kernel). Products are wmma 16x16x16
// fragments from shared memory (tile_mma.cuh); wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int HD = 64;       // head_dim
constexpr int BT = 64;       // q and key tile rows
constexpr int THREADS = 256;
constexpr int LDT = HD + 8;  // leading dimension of operand tiles (elements)
constexpr int LDF = BT + 4;  // leading dimension of f32 tiles

template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                                        float* __restrict__ delta, int S, int Hq, long long rows) {
    const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;  // row (b * S + s) * Hq + h
    if (r >= rows) return;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD; c += 8) {
        float a[8], b[8];
        ssi::load8(o + r * HD + c, a);
        ssi::load8(dout + r * HD + c, b);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
    }
    const long long h = r % Hq;
    const long long bs = r / Hq;
    const long long b = bs / S;
    const long long s = bs % S;
    delta[(b * Hq + h) * S + s] = acc;
}

// Shared-memory layout common to both kernels (byte offsets).
template <typename T>
struct Smem {
    static constexpr int TILE = ssi::smem_round(BT * LDT * (int)sizeof(T));
    static constexpr int FTILE = ssi::smem_round(BT * LDF * (int)sizeof(float));
    static constexpr int VEC = ssi::smem_round(BT * 4);
    // dk/dv: K, V, Q, dO, P, dS tiles; S, dP, dK, dV f32 tiles; lse, delta, qseg, kseg
    static constexpr int DKDV = 6 * TILE + 4 * FTILE + 4 * VEC;
    // dq: Q, dO, K, V, dS tiles; S, dP, dQ f32 tiles; lse, delta, qseg, kseg
    static constexpr int DQ = 5 * TILE + 3 * FTILE + 4 * VEC;
};

// Stage the q-side scalars of rows [q0, q0 + BT) of head h: lse, delta, segment.
__device__ __forceinline__ void load_q_scalars(float* lse_s, float* delta_s, int* qseg_s, const float* lse,
                                               const float* delta, const int* seg, int b, int h, int Hq, int S,
                                               int q0) {
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
        const int q = q0 + i;
        const bool in = q < S;
        const long long idx = ((long long)b * Hq + h) * S + q;
        lse_s[i] = in ? lse[idx] : 0.f;
        delta_s[i] = in ? delta[idx] : 0.f;
        qseg_s[i] = (seg != nullptr && in) ? seg[(long long)b * S + q] : 0;
    }
}

// From S (scores before scale) and dP in f32 shared memory: P and dS for the
// (q tile q0, key tile k0) pair, written in the operand dtype.
template <typename T>
__device__ __forceinline__ void softmax_grad(T* p_t, T* ds_t, const float* s_f, const float* dp_f,
                                             const float* lse_s, const float* delta_s, const int* qseg_s,
                                             const int* kseg_s, int q0, int k0, int S, int causal, bool segs,
                                             float scale) {
    for (int idx = threadIdx.x; idx < BT * BT; idx += blockDim.x) {
        const int i = idx / BT;
        const int j = idx % BT;
        const int q = q0 + i;
        const int kp = k0 + j;
        bool keep = q < S && kp < S;
        if (causal) keep = keep && kp <= q;
        if (segs) keep = keep && qseg_s[i] == kseg_s[j];
        const float p = keep ? expf(s_f[i * LDF + j] * scale - lse_s[i]) : 0.f;
        const float ds = p * (dp_f[i * LDF + j] - delta_s[i]);
        if (p_t != nullptr) p_t[i * LDT + j] = ssi::from_f32<T>(p);
        ds_t[i * LDT + j] = ssi::from_f32<T>(ds);
    }
}

__device__ __forceinline__ void zero(float* p, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv, int causal, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = Smem<T>;
    T* k_t = reinterpret_cast<T*>(smem);
    T* v_t = reinterpret_cast<T*>(smem + L::TILE);
    T* q_t = reinterpret_cast<T*>(smem + 2 * L::TILE);
    T* do_t = reinterpret_cast<T*>(smem + 3 * L::TILE);
    T* p_t = reinterpret_cast<T*>(smem + 4 * L::TILE);
    T* ds_t = reinterpret_cast<T*>(smem + 5 * L::TILE);
    float* s_f = reinterpret_cast<float*>(smem + 6 * L::TILE);
    float* dp_f = reinterpret_cast<float*>(smem + 6 * L::TILE + L::FTILE);
    float* dk_f = reinterpret_cast<float*>(smem + 6 * L::TILE + 2 * L::FTILE);
    float* dv_f = reinterpret_cast<float*>(smem + 6 * L::TILE + 3 * L::FTILE);
    unsigned char* vec = smem + 6 * L::TILE + 4 * L::FTILE;
    float* lse_s = reinterpret_cast<float*>(vec);
    float* delta_s = reinterpret_cast<float*>(vec + L::VEC);
    int* qseg_s = reinterpret_cast<int*>(vec + 2 * L::VEC);
    int* kseg_s = reinterpret_cast<int*>(vec + 3 * L::VEC);

    const int k0 = blockIdx.x * BT;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int n_rep = Hq / Hkv;
    const bool segs = seg != nullptr;
    const long long q_row = (long long)Hq * HD;    // elements between consecutive positions
    const long long kv_row = (long long)Hkv * HD;

    const long long kv_off = ((long long)b * S + k0) * kv_row + (long long)kvh * HD;
    ssi::load_rows<T, BT, HD, THREADS>(k_t, LDT, k + kv_off, kv_row, S - k0);
    ssi::load_rows<T, BT, HD, THREADS>(v_t, LDT, v + kv_off, kv_row, S - k0);
    for (int j = threadIdx.x; j < BT; j += blockDim.x) {
        kseg_s[j] = (segs && k0 + j < S) ? seg[(long long)b * S + k0 + j] : 0;
    }
    zero(dk_f, BT * LDF);
    zero(dv_f, BT * LDF);

    const int n_q = (S + BT - 1) / BT;
    for (int qi = causal ? blockIdx.x : 0; qi < n_q; ++qi) {  // causal: q tiles before the diagonal see no key here
        const int q0 = qi * BT;
        for (int r = 0; r < n_rep; ++r) {
            const int h = kvh * n_rep + r;
            __syncthreads();  // the previous pair's products are done with q_t, do_t, p_t, ds_t
            const long long q_off = ((long long)b * S + q0) * q_row + (long long)h * HD;
            ssi::load_rows<T, BT, HD, THREADS>(q_t, LDT, q + q_off, q_row, S - q0);
            ssi::load_rows<T, BT, HD, THREADS>(do_t, LDT, dout + q_off, q_row, S - q0);
            load_q_scalars(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
            zero(s_f, BT * LDF);
            zero(dp_f, BT * LDF);
            __syncthreads();
            ssi::tile_mma<T, BT, BT, HD, false, true>(s_f, LDF, q_t, LDT, k_t, LDT);    // S = Q K^T
            ssi::tile_mma<T, BT, BT, HD, false, true>(dp_f, LDF, do_t, LDT, v_t, LDT);  // dP = dO V^T
            __syncthreads();
            softmax_grad<T>(p_t, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
            __syncthreads();
            ssi::tile_mma<T, BT, HD, BT, true, false>(dv_f, LDF, p_t, LDT, do_t, LDT);  // dV += P^T dO
            ssi::tile_mma<T, BT, HD, BT, true, false>(dk_f, LDF, ds_t, LDT, q_t, LDT);  // dK += dS^T Q
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int j = idx / HD;
        const int c = idx % HD;
        if (k0 + j >= S) continue;
        const long long off = kv_off + j * kv_row + c;
        dk[off] = ssi::from_f32<T>(dk_f[j * LDF + c] * scale);
        dv[off] = ssi::from_f32<T>(dv_f[j * LDF + c]);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dq, int S, int Hq, int Hkv, int causal, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = Smem<T>;
    T* q_t = reinterpret_cast<T*>(smem);
    T* do_t = reinterpret_cast<T*>(smem + L::TILE);
    T* k_t = reinterpret_cast<T*>(smem + 2 * L::TILE);
    T* v_t = reinterpret_cast<T*>(smem + 3 * L::TILE);
    T* ds_t = reinterpret_cast<T*>(smem + 4 * L::TILE);
    float* s_f = reinterpret_cast<float*>(smem + 5 * L::TILE);
    float* dp_f = reinterpret_cast<float*>(smem + 5 * L::TILE + L::FTILE);
    float* dq_f = reinterpret_cast<float*>(smem + 5 * L::TILE + 2 * L::FTILE);
    unsigned char* vec = smem + 5 * L::TILE + 3 * L::FTILE;
    float* lse_s = reinterpret_cast<float*>(vec);
    float* delta_s = reinterpret_cast<float*>(vec + L::VEC);
    int* qseg_s = reinterpret_cast<int*>(vec + 2 * L::VEC);
    int* kseg_s = reinterpret_cast<int*>(vec + 3 * L::VEC);

    const int q0 = blockIdx.x * BT;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (Hq / Hkv);
    const bool segs = seg != nullptr;
    const long long q_row = (long long)Hq * HD;
    const long long kv_row = (long long)Hkv * HD;

    const long long q_off = ((long long)b * S + q0) * q_row + (long long)h * HD;
    ssi::load_rows<T, BT, HD, THREADS>(q_t, LDT, q + q_off, q_row, S - q0);
    ssi::load_rows<T, BT, HD, THREADS>(do_t, LDT, dout + q_off, q_row, S - q0);
    load_q_scalars(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
    zero(dq_f, BT * LDF);

    const int n_k = causal ? blockIdx.x + 1 : (S + BT - 1) / BT;  // causal: keys past the q tile are masked
    for (int ki = 0; ki < n_k; ++ki) {
        const int k0 = ki * BT;
        __syncthreads();  // the previous tile's dQ product is done with k_t, ds_t
        const long long kv_off = ((long long)b * S + k0) * kv_row + (long long)kvh * HD;
        ssi::load_rows<T, BT, HD, THREADS>(k_t, LDT, k + kv_off, kv_row, S - k0);
        ssi::load_rows<T, BT, HD, THREADS>(v_t, LDT, v + kv_off, kv_row, S - k0);
        for (int j = threadIdx.x; j < BT; j += blockDim.x) {
            kseg_s[j] = (segs && k0 + j < S) ? seg[(long long)b * S + k0 + j] : 0;
        }
        zero(s_f, BT * LDF);
        zero(dp_f, BT * LDF);
        __syncthreads();
        ssi::tile_mma<T, BT, BT, HD, false, true>(s_f, LDF, q_t, LDT, k_t, LDT);    // S = Q K^T
        ssi::tile_mma<T, BT, BT, HD, false, true>(dp_f, LDF, do_t, LDT, v_t, LDT);  // dP = dO V^T
        __syncthreads();
        softmax_grad<T>(nullptr, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
        __syncthreads();
        ssi::tile_mma<T, BT, HD, BT, false, false>(dq_f, LDF, ds_t, LDT, k_t, LDT);  // dQ += dS K
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int i = idx / HD;
        const int c = idx % HD;
        if (q0 + i >= S) continue;
        dq[q_off + i * q_row + c] = ssi::from_f32<T>(dq_f[i * LDF + c] * scale);
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                   const int* seg, float* delta, void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
                   int causal, float scale, cudaStream_t stream) {
    using L = Smem<T>;
    const long long rows = (long long)B * S * Hq;
    delta_kernel<T><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, Hq, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int n_t = (S + BT - 1) / BT;
    err = cudaFuncSetAttribute(dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DKDV);
    if (err != cudaSuccess) return err;
    dkdv_kernel<T><<<dim3(n_t, Hkv, B), THREADS, L::DKDV, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ);
    if (err != cudaSuccess) return err;
    dq_kernel<T><<<dim3(n_t, Hq, B), THREADS, L::DQ, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, seg, static_cast<T*>(dq), S, Hq, Hkv, causal, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ssi_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, const void* seg, void* delta, void* dq,
                                       void* dk, void* dv, int B, int S, int Hq, int Hkv, int causal, float scale,
                                       void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const float* lsep = static_cast<const float*>(lse);
    const int* segp = static_cast<const int*>(seg);
    float* deltap = static_cast<float*>(delta);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch<float>(q, k, v, o, dout, lsep, segp, deltap, dq, dk, dv, B, S, Hq, Hkv, causal, scale, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch<__nv_bfloat16>(q, k, v, o, dout, lsep, segp, deltap, dq, dk, dv, B, S, Hq, Hkv, causal, scale,
                                    st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
