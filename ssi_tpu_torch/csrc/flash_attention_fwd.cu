// Flash-attention forward (causal or full GQA, optional packed segment ids)
// for head_dim 64, in f32 or bf16 with f32 accumulation.
//
// Replaces the TPU kernels ssi_tpu/ops/flash_attention.py `_fwd_kernel` and
// `_fwd_kernel_grouped` (one GQA schedule ports both). Semantics kept exactly:
// q is scaled by 1/sqrt(d) before the dot, masked scores are -1e30, and the
// `m_safe = max(m, -0.5e30)` / `l_safe = max(l, 1e-30)` clamps make a fully
// masked row output 0 with a finite lse = m_safe + log(l_safe).
//
// What bounds it on Hopper: the S^2 * d score and value work (prefill at
// B<=8, S = prompt bucket, 32 q / 8 kv heads). The TPU kernel kept one whole
// (batch, head) K/V slice in VMEM and took an exact softmax per row; at S=2048
// K+V is 512 KB, more than a block's 227 KB of shared memory, so this kernel
// streams K/V tiles through shared memory with an online softmax instead.
//
// Design (right and simple first; wgmma/TMA are for later work):
// - one block of 128 threads per (batch, kv head, q tile); thread t owns one
//   query row: q head `kvh*n_rep + t / bq`, position `tile*bq + t % bq`, where
//   bq = 128 / n_rep, so all n_rep heads sharing a kv head read each K/V tile
//   from shared memory once per block;
// - q row and the f32 output accumulator live in registers; scores of a
//   32-key tile are formed with scalar FMAs against broadcast shared-memory
//   reads, then folded into the running max / sum;
// - causal: tiles past the block's last query position are never loaded;
// - strides are passed in elements so the [B, S, H, D] layout needs no
//   transpose copy; the output is contiguous [B, S, Hq, D], lse is [B, Hq, S].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;
constexpr int BK = 32;
constexpr float NEG_INF = -1.0e30f;

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
    int S, int Hq, int n_rep, int bq,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale) {
    __shared__ float k_sm[BK][HD];
    __shared__ float v_sm[BK][HD];
    __shared__ int kseg_sm[BK];

    const int tile = blockIdx.x;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int t = threadIdx.x;
    const int rep = t / bq;
    const int qpos = tile * bq + t % bq;
    const bool row_ok = rep < n_rep && qpos < S;
    const int h = kvh * n_rep + rep;

    float qr[HD];
    float acc[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) {
        qr[c] = row_ok ? ssi::to_f32(q[b * q_sb + qpos * q_ss + h * q_sh + c]) * scale : 0.f;
        acc[c] = 0.f;
    }
    const int qseg = (seg != nullptr && row_ok) ? seg[(long long)b * S + qpos] : 0;
    float m = NEG_INF;     // running max of the (masked) scores
    float ms = -0.5e30f;   // m_safe = max(m, -0.5e30), the exponent's shift
    float l = 0.f;

    const int kv_end = causal ? min(S, (tile + 1) * bq) : S;
    const T* kb = k + b * k_sb + kvh * k_sh;
    const T* vb = v + b * v_sb + kvh * v_sh;

    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();  // the previous tile is fully consumed
        for (int idx = t; idx < BK * HD; idx += THREADS) {
            const int r = idx / HD;
            const int c = idx % HD;
            const int kp = k0 + r;
            const bool in = kp < kv_end;
            k_sm[r][c] = in ? ssi::to_f32(kb[kp * k_ss + c]) : 0.f;
            v_sm[r][c] = in ? ssi::to_f32(vb[kp * v_ss + c]) : 0.f;
        }
        if (seg != nullptr && t < BK) {
            kseg_sm[t] = (k0 + t < kv_end) ? seg[(long long)b * S + k0 + t] : 0;
        }
        __syncthreads();
        if (!row_ok) continue;

        float s[BK];
        float tile_max = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], k_sm[j][c], dot);
            const int kp = k0 + j;
            bool keep = kp < kv_end;
            if (causal) keep = keep && kp <= qpos;
            if (seg != nullptr) keep = keep && kseg_sm[j] == qseg;
            s[j] = keep ? dot : NEG_INF;
            tile_max = fmaxf(tile_max, s[j]);
        }
        const float m_new = fmaxf(m, tile_max);
        const float ms_new = fmaxf(m_new, -0.5e30f);
        const float alpha = expf(ms - ms_new);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - ms_new);
            l += p;
#pragma unroll
            for (int c = 0; c < HD; ++c) acc[c] = fmaf(p, v_sm[j][c], acc[c]);
        }
        m = m_new;
        ms = ms_new;
    }

    if (!row_ok) return;
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * S + qpos) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) orow[c] = ssi::from_f32<T>(acc[c] / l_safe);
    lse[((long long)b * Hq + h) * S + qpos] = ms + logf(l_safe);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse,
                   int B, int S, int Hq, int Hkv,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int causal, float scale, cudaStream_t stream) {
    const int n_rep = Hq / Hkv;
    const int bq = THREADS / n_rep;
    const dim3 grid((S + bq - 1) / bq, Hkv, B);
    flash_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
        static_cast<T*>(o), lse, S, Hq, n_rep, bq,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ssi_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
    int B, int S, int Hq, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > THREADS) return static_cast<int>(cudaErrorInvalidValue);
    const int* segp = static_cast<const int*>(seg);
    float* lsep = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch<float>(q, k, v, segp, o, lsep, B, S, Hq, Hkv, q_sb, q_ss, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch<__nv_bfloat16>(q, k, v, segp, o, lsep, B, S, Hq, Hkv, q_sb, q_ss, q_sh,
                                    k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
