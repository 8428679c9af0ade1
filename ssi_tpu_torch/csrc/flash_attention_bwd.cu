// Flash-attention backward (causal or full GQA, optional packed segment ids)
// for any head_dim d up to 256 that is a multiple of 8 (64: the 100m and 1B
// models; 128: 3B and 8B; 256: Gemma's heads; the wrapper pads any other d
// with zeros), an instance at 64, one at 128 and one at 256, each running the
// head_dims up to it: dq, dk, dv from q, k, v, the forward's o and lse, and do.
// bf16 operands on the tensor cores with f32 accumulation, or f32 throughout.
// bf16 runs the Hopper kernels of flash_hopper_bwd.cu (wgmma fed by TMA) at
// every head dim, dispatched from the entry point below; this file keeps the
// f32 parity kernels.
//
// Replaces the TPU kernels ssi_tpu/ops/flash_attention.py `_bwd_kernel` and
// `_bwd_kernel_grouped` (one GQA schedule ports both). Semantics kept: the
// scores are recomputed as S = scale * q.k (the port's forward takes unscaled
// q and applies scale = 1/sqrt(head_dim) inside, so the scale is applied here
// to S and multiplied into dq and dk), P = exp(S - lse) with masked entries set to
// 0 explicitly (a fully masked row gives zero gradients), delta = rowsum(o.do)
// in f32, dS = P * (dP - delta); P and dS are cast to the operand dtype before
// the dV, dK and dQ products, as the TPU kernel casts them.
//
// The TPU kernel ran its grid in sequence and accumulated dk/dv across
// revisited output blocks; CUDA blocks run in parallel, so this port takes
// the deterministic two-kernel layout and uses no atomics (gradients are
// bitwise reproducible run to run):
// - delta kernel: one thread per (b, s, q head) row, rowsum(o * do) in f32;
// - dk/dv kernel: one block per (batch, kv head, key tile), looping over the
//   q tiles at and after the causal diagonal and over the n_rep q heads of
//   its kv head in a fixed order;
// - dq kernel: one block per (batch, q head, query tile), looping over the
//   key tiles up to the diagonal.
// Each block recomputes S and dP for its tile pairs: 7 products are issued
// where the TPU forms 5 (the price of no atomics).
//
// The f32 kernels keep exact f32 arithmetic for the parity checks (TF32
// would not meet them): S, dP and the gradient sums are f32 tiles in shared
// memory, multiplied by scalar FMAs (tile_mma.cuh). At head_dim 128 their
// 64-row tiles would need 311 KB (dk/dv) of the SM's 227 KB, so they take
// 32-row tiles there (145 KB and 111 KB), and 16-row tiles at 256 (137 KB
// and 104 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hopper.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;  // delta and f32 kernels

template <int HD>
__global__ void __launch_bounds__(THREADS) delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                                        float* __restrict__ delta, int S, int Hq, int d,
                                                        long long rows) {
    const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;  // row (b * S + s) * Hq + h
    if (r >= rows) return;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD; c += 8) {
        if (c >= d) break;
        float a[8], b[8];
        ssi::load8(o + r * d + c, a);
        ssi::load8(dout + r * d + c, b);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
    }
    const long long h = r % Hq;
    const long long bs = r / Hq;
    const long long b = bs / S;
    const long long s = bs % S;
    delta[(b * Hq + h) * S + s] = acc;
}

// ---- f32: scalar FMAs (parity path) -------------------------------------------

// Tile sizes and shared-memory layout (byte offsets) of the f32 kernels.
template <int HD>
struct F32 {
    // q and key tile rows: 227 KB hold 32-row tiles at HD 128, 16-row ones at 256
    static constexpr int BT = HD == 64 ? 64 : HD == 128 ? 32 : 16;
    static constexpr int LDT = HD + 8;  // leading dimension of operand tiles (elements)
    static constexpr int LDF = BT + 4;  // of the [BT x BT] f32 score tiles
    static constexpr int LDG = HD + 4;  // of the [BT x HD] f32 gradient sums
    static constexpr int TILE = ssi::smem_round(BT * LDT * (int)sizeof(float));
    static constexpr int FTILE = ssi::smem_round(BT * LDF * (int)sizeof(float));
    static constexpr int GTILE = ssi::smem_round(BT * LDG * (int)sizeof(float));
    static constexpr int VEC = ssi::smem_round(BT * 4);
    // dk/dv: K, V, Q, dO, P, dS tiles; S, dP f32 tiles; dK, dV sums; lse, delta, qseg, kseg
    static constexpr int DKDV = 6 * TILE + 2 * FTILE + 2 * GTILE + 4 * VEC;
    // dq: Q, dO, K, V, dS tiles; S, dP f32 tiles; dQ sum; lse, delta, qseg, kseg
    static constexpr int DQ = 5 * TILE + 2 * FTILE + GTILE + 4 * VEC;
};

// Stage the q-side scalars of rows [q0, q0 + BT) of head h: lse, delta, segment.
template <int BT>
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
// (q tile q0, key tile k0) pair.
template <int HD>
__device__ __forceinline__ void softmax_grad(float* p_t, float* ds_t, const float* s_f, const float* dp_f,
                                             const float* lse_s, const float* delta_s, const int* qseg_s,
                                             const int* kseg_s, int q0, int k0, int S, int causal, bool segs,
                                             float scale) {
    using L = F32<HD>;
    for (int idx = threadIdx.x; idx < L::BT * L::BT; idx += blockDim.x) {
        const int i = idx / L::BT;
        const int j = idx % L::BT;
        const int q = q0 + i;
        const int kp = k0 + j;
        bool keep = q < S && kp < S;
        if (causal) keep = keep && kp <= q;
        if (segs) keep = keep && qseg_s[i] == kseg_s[j];
        const float p = keep ? expf(s_f[i * L::LDF + j] * scale - lse_s[i]) : 0.f;
        const float ds = p * (dp_f[i * L::LDF + j] - delta_s[i]);
        if (p_t != nullptr) p_t[i * L::LDT + j] = p;
        ds_t[i * L::LDT + j] = ds;
    }
}

__device__ __forceinline__ void zero(float* p, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv, int d,
    int causal, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = F32<HD>;
    constexpr int BT = L::BT;
    float* k_t = reinterpret_cast<float*>(smem);
    float* v_t = reinterpret_cast<float*>(smem + L::TILE);
    float* q_t = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* do_t = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* p_t = reinterpret_cast<float*>(smem + 4 * L::TILE);
    float* ds_t = reinterpret_cast<float*>(smem + 5 * L::TILE);
    float* s_f = reinterpret_cast<float*>(smem + 6 * L::TILE);
    float* dp_f = reinterpret_cast<float*>(smem + 6 * L::TILE + L::FTILE);
    float* dk_f = reinterpret_cast<float*>(smem + 6 * L::TILE + 2 * L::FTILE);
    float* dv_f = reinterpret_cast<float*>(smem + 6 * L::TILE + 2 * L::FTILE + L::GTILE);
    unsigned char* vec = smem + 6 * L::TILE + 2 * L::FTILE + 2 * L::GTILE;
    float* lse_s = reinterpret_cast<float*>(vec);
    float* delta_s = reinterpret_cast<float*>(vec + L::VEC);
    int* qseg_s = reinterpret_cast<int*>(vec + 2 * L::VEC);
    int* kseg_s = reinterpret_cast<int*>(vec + 3 * L::VEC);

    const int k0 = blockIdx.x * BT;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int n_rep = Hq / Hkv;
    const bool segs = seg != nullptr;
    const long long q_row = (long long)Hq * d;    // elements between consecutive positions
    const long long kv_row = (long long)Hkv * d;

    const long long kv_off = ((long long)b * S + k0) * kv_row + (long long)kvh * d;
    ssi::load_rows<float, BT, HD, THREADS>(k_t, L::LDT, k + kv_off, kv_row, S - k0, d);
    ssi::load_rows<float, BT, HD, THREADS>(v_t, L::LDT, v + kv_off, kv_row, S - k0, d);
    for (int j = threadIdx.x; j < BT; j += blockDim.x) {
        kseg_s[j] = (segs && k0 + j < S) ? seg[(long long)b * S + k0 + j] : 0;
    }
    zero(dk_f, BT * L::LDG);
    zero(dv_f, BT * L::LDG);

    const int n_q = (S + BT - 1) / BT;
    for (int qi = causal ? blockIdx.x : 0; qi < n_q; ++qi) {  // causal: q tiles before the diagonal see no key here
        const int q0 = qi * BT;
        for (int r = 0; r < n_rep; ++r) {
            const int h = kvh * n_rep + r;
            __syncthreads();  // the previous pair's products are done with q_t, do_t, p_t, ds_t
            const long long q_off = ((long long)b * S + q0) * q_row + (long long)h * d;
            ssi::load_rows<float, BT, HD, THREADS>(q_t, L::LDT, q + q_off, q_row, S - q0, d);
            ssi::load_rows<float, BT, HD, THREADS>(do_t, L::LDT, dout + q_off, q_row, S - q0, d);
            load_q_scalars<BT>(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
            zero(s_f, BT * L::LDF);
            zero(dp_f, BT * L::LDF);
            __syncthreads();
            ssi::tile_mma<BT, BT, HD, false, true>(s_f, L::LDF, q_t, L::LDT, k_t, L::LDT);    // S = Q K^T
            ssi::tile_mma<BT, BT, HD, false, true>(dp_f, L::LDF, do_t, L::LDT, v_t, L::LDT);  // dP = dO V^T
            __syncthreads();
            softmax_grad<HD>(p_t, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
            __syncthreads();
            ssi::tile_mma<BT, HD, BT, true, false>(dv_f, L::LDG, p_t, L::LDT, do_t, L::LDT);  // dV += P^T dO
            ssi::tile_mma<BT, HD, BT, true, false>(dk_f, L::LDG, ds_t, L::LDT, q_t, L::LDT);  // dK += dS^T Q
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int j = idx / HD;
        const int c = idx % HD;
        if (k0 + j >= S || c >= d) continue;
        const long long off = kv_off + j * kv_row + c;
        dk[off] = dk_f[j * L::LDG + c] * scale;
        dv[off] = dv_f[j * L::LDG + c];
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dq, int S, int Hq, int Hkv, int d, int causal, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = F32<HD>;
    constexpr int BT = L::BT;
    float* q_t = reinterpret_cast<float*>(smem);
    float* do_t = reinterpret_cast<float*>(smem + L::TILE);
    float* k_t = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* v_t = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* ds_t = reinterpret_cast<float*>(smem + 4 * L::TILE);
    float* s_f = reinterpret_cast<float*>(smem + 5 * L::TILE);
    float* dp_f = reinterpret_cast<float*>(smem + 5 * L::TILE + L::FTILE);
    float* dq_f = reinterpret_cast<float*>(smem + 5 * L::TILE + 2 * L::FTILE);
    unsigned char* vec = smem + 5 * L::TILE + 2 * L::FTILE + L::GTILE;
    float* lse_s = reinterpret_cast<float*>(vec);
    float* delta_s = reinterpret_cast<float*>(vec + L::VEC);
    int* qseg_s = reinterpret_cast<int*>(vec + 2 * L::VEC);
    int* kseg_s = reinterpret_cast<int*>(vec + 3 * L::VEC);

    const int q0 = blockIdx.x * BT;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (Hq / Hkv);
    const bool segs = seg != nullptr;
    const long long q_row = (long long)Hq * d;
    const long long kv_row = (long long)Hkv * d;

    const long long q_off = ((long long)b * S + q0) * q_row + (long long)h * d;
    ssi::load_rows<float, BT, HD, THREADS>(q_t, L::LDT, q + q_off, q_row, S - q0, d);
    ssi::load_rows<float, BT, HD, THREADS>(do_t, L::LDT, dout + q_off, q_row, S - q0, d);
    load_q_scalars<BT>(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
    zero(dq_f, BT * L::LDG);

    const int n_k = causal ? blockIdx.x + 1 : (S + BT - 1) / BT;  // causal: keys past the q tile are masked
    for (int ki = 0; ki < n_k; ++ki) {
        const int k0 = ki * BT;
        __syncthreads();  // the previous tile's dQ product is done with k_t, ds_t
        const long long kv_off = ((long long)b * S + k0) * kv_row + (long long)kvh * d;
        ssi::load_rows<float, BT, HD, THREADS>(k_t, L::LDT, k + kv_off, kv_row, S - k0, d);
        ssi::load_rows<float, BT, HD, THREADS>(v_t, L::LDT, v + kv_off, kv_row, S - k0, d);
        for (int j = threadIdx.x; j < BT; j += blockDim.x) {
            kseg_s[j] = (segs && k0 + j < S) ? seg[(long long)b * S + k0 + j] : 0;
        }
        zero(s_f, BT * L::LDF);
        zero(dp_f, BT * L::LDF);
        __syncthreads();
        ssi::tile_mma<BT, BT, HD, false, true>(s_f, L::LDF, q_t, L::LDT, k_t, L::LDT);    // S = Q K^T
        ssi::tile_mma<BT, BT, HD, false, true>(dp_f, L::LDF, do_t, L::LDT, v_t, L::LDT);  // dP = dO V^T
        __syncthreads();
        softmax_grad<HD>(nullptr, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
        __syncthreads();
        ssi::tile_mma<BT, HD, BT, false, false>(dq_f, L::LDG, ds_t, L::LDT, k_t, L::LDT);  // dQ += dS K
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int i = idx / HD;
        const int c = idx % HD;
        if (q0 + i >= S || c >= d) continue;
        dq[q_off + i * q_row + c] = dq_f[i * L::LDG + c] * scale;
    }
}

template <int HD>
cudaError_t launch_delta(const float* o, const float* dout, float* delta, int B, int S, int Hq, int d,
                         cudaStream_t stream) {
    const long long rows = (long long)B * S * Hq;
    delta_kernel<HD><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(o, dout, delta, S, Hq, d,
                                                                                         rows);
    return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* o, const float* dout,
                       const float* lse, const int* seg, float* delta, float* dq, float* dk, float* dv, int B, int S,
                       int Hq, int Hkv, int d, int causal, float scale, cudaStream_t stream) {
    using L = F32<HD>;
    static int allowed_dkdv = 0, allowed_dq = 0;
    cudaError_t err = launch_delta<HD>(o, dout, delta, B, S, Hq, d, stream);
    if (err != cudaSuccess) return err;
    const int n_t = (S + L::BT - 1) / L::BT;
    err = ssi::allow_dynamic_smem(dkdv_f32_kernel<HD>, L::DKDV, allowed_dkdv);
    if (err != cudaSuccess) return err;
    dkdv_f32_kernel<HD><<<dim3(n_t, Hkv, B), THREADS, L::DKDV, stream>>>(q, k, v, dout, lse, delta, seg, dk, dv, S,
                                                                          Hq, Hkv, d, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = ssi::allow_dynamic_smem(dq_f32_kernel<HD>, L::DQ, allowed_dq);
    if (err != cudaSuccess) return err;
    dq_f32_kernel<HD><<<dim3(n_t, Hq, B), THREADS, L::DQ, stream>>>(q, k, v, dout, lse, delta, seg, dq, S, Hq, Hkv,
                                                                     d, causal, scale);
    return cudaGetLastError();
}

}  // namespace

// hd: head_dim, at most 256 and a multiple of 8
extern "C" int ssi_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, const void* seg, void* delta, void* dq,
                                       void* dk, void* dv, int B, int S, int Hq, int Hkv, int hd, int causal,
                                       float scale, void* stream) {
    if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || hd <= 0 || hd > 256 || hd % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const float* lsep = static_cast<const float*>(lse);
    const int* segp = static_cast<const int*>(seg);
    float* deltap = static_cast<float*>(delta);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (dtype == ssi::kFloat32) {
        const auto f32 = hd <= 64 ? &launch_f32<64> : hd <= 128 ? &launch_f32<128> : &launch_f32<256>;
        err = f32(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<const float*>(o), static_cast<const float*>(dout), lsep, segp, deltap,
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, S, Hq, Hkv, hd,
                  causal, scale, st);
    } else if (dtype == ssi::kBFloat16) {
        // the Hopper kernels (flash_hopper_bwd.cu)
        err = ssi::flash_bwd_hopper_bf16(q, k, v, o, dout, lsep, deltap, segp, dq, dk, dv, B, S, Hq, Hkv, hd, causal,
                                         scale, st);
    }
    return static_cast<int>(err);
}
