// Flash-attention forward (causal or full GQA, optional packed segment ids)
// for any head_dim d up to 256 that is a multiple of 8 (64: the 100m and 1B
// models; 128: 3B and 8B; 16: tiny_test; 256: Gemma's heads; the wrapper pads
// any other d to the next multiple of 8 with zeros): an instance at 64, one
// at 128 and one at 256, each running the head_dims up to it with its loads
// and stores bounded at d. bf16
// on the tensor cores with f32 accumulation, or f32 with scalar FMAs (the
// parity path). bf16 runs the Hopper kernel of flash_hopper_fwd.cu (wgmma fed by
// TMA), dispatched from the entry point below.
//
// Replaces the TPU kernels ssi_tpu/ops/flash_attention.py `_fwd_kernel` and
// `_fwd_kernel_grouped` (one GQA schedule ports both). Semantics kept exactly:
// q is scaled by 1/sqrt(d), masked scores are -1e30, and the
// `m_safe = max(m, -0.5e30)` / `l_safe = max(l, 1e-30)` clamps make a fully
// masked row output 0 with a finite lse = m_safe + log(l_safe). As on the
// TPU, both products take bf16 operands with f32 accumulation, the row sum
// adds the f32 probabilities and p is cast to bf16 for the P.V product.
//
// What bounds it on Hopper: the S^2 * d score and value work (4 * d FLOP per
// allowed (query, key) pair); at the main path's shapes (B8 S768 prefill,
// B2 S2048 training, 32 q / 8 kv heads) it is bound by operations, not bytes.
// The TPU kernel kept one whole (batch, head) K/V slice in VMEM; a Hopper
// block has 227 KB of shared memory, so K/V stream through it in tiles with
// an online softmax.
//
// The f32 kernel (one thread per query row, 32-key tiles of scalar FMAs)
// keeps exact f32 arithmetic for the parity checks; TF32 would not. It holds
// its row of q and of the output in registers, 2 * head_dim of them: at
// head_dim 128 and 256 they spill to local memory, which a parity path can
// afford. At 256 its key tiles are 16 keys (32 KB of K and V, under the 48 KB
// of static shared memory).
//
// Strides are passed in elements so the [B, S, H, D] layout needs no
// transpose copy; the output is contiguous [B, S, Hq, D], lse is [B, Hq, S].
// The f32 kernel holds HD columns (the instance's) and reads and writes the
// first d of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hopper.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float M_CLAMP = -0.5e30f;  // m_safe = max(m, M_CLAMP)

// ---- f32: scalar FMAs (parity path) -----------------------------------------

constexpr int THREADS = 128;
// keys a tile: 32, and 16 at head_dim 256
template <int HD>
constexpr int BK_OF = HD > 128 ? 16 : 32;

// one block of 128 threads per (batch, kv head, q tile); thread t owns one
// query row: q head `kvh*n_rep + t / bq`, position `tile*bq + t % bq`, where
// bq = 128 / n_rep, so the n_rep heads sharing a kv head read each K/V tile
// from shared memory once per block
template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seg, float* __restrict__ o, float* __restrict__ lse,
    int S, int Hq, int n_rep, int bq,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int d, int causal, float scale) {
    constexpr int BK = BK_OF<HD>;
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
        qr[c] = row_ok && c < d ? q[b * q_sb + qpos * q_ss + h * q_sh + c] * scale : 0.f;
        acc[c] = 0.f;
    }
    const int qseg = (seg != nullptr && row_ok) ? seg[(long long)b * S + qpos] : 0;
    float m = NEG_INF;   // running max of the (masked) scores
    float ms = M_CLAMP;  // m_safe, the exponent's shift
    float l = 0.f;

    const int kv_end = causal ? min(S, (tile + 1) * bq) : S;
    const float* kb = k + b * k_sb + kvh * k_sh;
    const float* vb = v + b * v_sb + kvh * v_sh;

    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();  // the previous tile is fully consumed
        for (int idx = t; idx < BK * HD; idx += THREADS) {
            const int r = idx / HD;
            const int c = idx % HD;
            const int kp = k0 + r;
            const bool in = kp < kv_end && c < d;  // columns past d are zeros
            k_sm[r][c] = in ? kb[kp * k_ss + c] : 0.f;
            v_sm[r][c] = in ? vb[kp * v_ss + c] : 0.f;
        }
        if (seg != nullptr && t < BK) {
            kseg_sm[t] = (k0 + t < kv_end) ? seg[(long long)b * S + k0 + t] : 0;
        }
        __syncthreads();
        if (!row_ok) continue;

        // the key loops stay rolled: unrolled over BK x HD (8,192 FMAs at HD
        // 128) they cost the compiler most of the library's build time; the
        // FMA order, and so every result bit, is the same either way
        float s[BK];
        float tile_max = NEG_INF;
#pragma unroll 1
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
        const float ms_new = fmaxf(m_new, M_CLAMP);
        const float alpha = expf(ms - ms_new);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] *= alpha;
#pragma unroll 1
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
    float* orow = o + (((long long)b * S + qpos) * Hq + h) * d;
#pragma unroll
    for (int c = 0; c < HD; ++c)
        if (c < d) orow[c] = acc[c] / l_safe;
    lse[((long long)b * Hq + h) * S + qpos] = ms + logf(l_safe);
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const int* segp, void* o, float* lsep,
                   int B, int S, int Hq, int n_rep, int d,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int causal, float scale, cudaStream_t st) {
    if (dtype == ssi::kBFloat16) {  // the Hopper kernel (flash_hopper_fwd.cu)
        return ssi::flash_fwd_hopper_bf16(q, k, v, segp, o, lsep, B, S, Hq, Hq / n_rep, d, q_sb, q_ss, q_sh, k_sb,
                                          k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
    } else if (dtype == ssi::kFloat32) {
        const int bq = THREADS / n_rep;
        const dim3 grid((S + bq - 1) / bq, Hq / n_rep, B);
        flash_fwd_f32_kernel<HD><<<grid, THREADS, 0, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), segp,
            static_cast<float*>(o), lsep, S, Hq, n_rep, bq,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d, causal, scale);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// hd: head_dim, at most 256 and a multiple of 8
extern "C" int ssi_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
    int B, int S, int Hq, int Hkv, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_rep = Hq / Hkv;
    const int* segp = static_cast<const int*>(seg);
    float* lsep = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (hd <= 0 || hd > 256 || hd % 8 != 0)
        err = cudaErrorInvalidValue;
    else if (hd <= 64)
        err = launch<64>(dtype, q, k, v, segp, o, lsep, B, S, Hq, n_rep, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, causal, scale, st);
    else if (hd > 128)
        err = launch<256>(dtype, q, k, v, segp, o, lsep, B, S, Hq, n_rep, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, causal, scale, st);
    else
        err = launch<128>(dtype, q, k, v, segp, o, lsep, B, S, Hq, n_rep, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, causal, scale, st);
    return static_cast<int>(err);
}
