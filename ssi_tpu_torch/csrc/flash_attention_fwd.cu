// Flash-attention forward (causal or full GQA, optional packed segment ids)
// for head_dim 64 (the 100m and 1B models) and 128 (3B and 8B): bf16 on the
// tensor cores with f32 accumulation, or f32 with scalar FMAs (the parity
// path). bf16 at head_dim 128 runs the Hopper kernel of flash_hd128_fwd.cu
// (wgmma fed by TMA, warp-specialised), dispatched from the entry point below.
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
// block has 227 KB of shared memory, so K/V stream through it in 64-key
// tiles with an online softmax.
//
// Design of the head_dim-64 bf16 kernel:
// - one block of 4 warps per (q head, batch, 64-query tile); each warp owns
//   16 query rows. One q head per block: the n_rep q heads of a kv head are
//   neighbouring blocks and share each K/V tile through L2, which keeps the
//   block at 46 KB of shared memory. Registers (about 165 a thread) hold it
//   to 3 blocks per SM; forcing 4 (128 registers) spills and measured no
//   faster;
// - Q.K^T and P.V are mma.sync m16n8k16 products fed by ldmatrix from
//   shared rows padded to 144 bytes (conflict-free); the scores, the running
//   max and sum (quad shuffles) and the output accumulator stay in registers,
//   and the score accumulators become P's A fragments without leaving them;
//   V is read with ldmatrix.trans;
// - the Q tile loads once; 64-key K/V tiles go through a 2-stage cp.async
//   ring, so tile i+1 loads while tile i is multiplied; rows past the end are
//   zero-filled by the copy;
// - causal: tiles past the block's last query are never loaded, only the
//   diagonal (or ragged last) tile applies the mask, and the grid's slowest
//   dimension runs the q tiles last-first so the heaviest blocks start first;
// - the output is normalised once at the end, as the TPU kernel does.
//
// The f32 kernel (one thread per query row, 32-key tiles of scalar FMAs)
// keeps exact f32 arithmetic for the parity checks; TF32 would not. It holds
// its row of q and of the output in registers, 2 * head_dim of them: at
// head_dim 128 they spill to local memory, which a parity path can afford.
//
// Strides are passed in elements so the [B, S, H, D] layout needs no
// transpose copy; the output is contiguous [B, S, Hq, D], lse is [B, Hq, S].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hd128.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float M_CLAMP = -0.5e30f;  // m_safe = max(m, M_CLAMP)
constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16, head_dim 64: tensor cores ---------------------------------------------

constexpr int HD64 = 64;
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BQ = 16 * TC_WARPS;  // query rows per block
constexpr int TC_BK = 64;             // keys per K/V tile

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(TC_THREADS, 3) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse,
    int S, int Hq, int n_rep,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale) {
    constexpr int HD = HD64;
    __shared__ __align__(128) bf16 q_sm[TC_BQ][ssi::lds<HD>];  // rows padded to 144 bytes
    __shared__ __align__(128) bf16 k_sm[2][TC_BK][ssi::lds<HD>];
    __shared__ __align__(128) bf16 v_sm[2][TC_BK][ssi::lds<HD>];

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;  // last tiles (most keys) first
    const int kvh = h / n_rep;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;

    const bf16* qb = q + b * q_sb + h * q_sh;
    const bf16* kb = k + b * k_sb + kvh * k_sh;
    const bf16* vb = v + b * v_sb + kvh * v_sh;
    const int kv_end = causal ? min(S, q0 + TC_BQ) : S;
    const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;

    ssi::load_tile_async<TC_THREADS, HD>(q_sm, qb, q_ss, q0, S);
    ssi::load_tile_async<TC_THREADS, HD>(k_sm[0], kb, k_ss, 0, kv_end);
    ssi::load_tile_async<TC_THREADS, HD>(v_sm[0], vb, v_ss, 0, kv_end);
    ssi::cp_async_commit();

    // this thread's two query rows: lo (g) and hi (g + 8) of the warp's 16
    const int row_lo = q0 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;
    const int qseg_lo = (segb != nullptr && row_lo < S) ? segb[row_lo] : 0;
    const int qseg_hi = (segb != nullptr && row_hi < S) ? segb[row_hi] : 0;

    uint32_t qf[HD / 16][4];  // Q's A fragments, one per k16 step over head_dim
    float acc[HD / 8][4];     // O [16 x HD]: one C fragment per n8 block of head_dim
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m_lo = NEG_INF, m_hi = NEG_INF;    // running max of the scaled, masked scores
    float ms_lo = M_CLAMP, ms_hi = M_CLAMP;  // m_safe, the exponent's shift
    float l_lo = 0.f, l_hi = 0.f;            // this thread's part of the row sums

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        if (it + 1 < n_tiles) {  // the next tile loads while this one is multiplied
            ssi::load_tile_async<TC_THREADS, HD>(k_sm[st ^ 1], kb, k_ss, (it + 1) * TC_BK, kv_end);
            ssi::load_tile_async<TC_THREADS, HD>(v_sm[st ^ 1], vb, v_ss, (it + 1) * TC_BK, kv_end);
        }
        ssi::cp_async_commit();
        ssi::cp_async_wait<1>();  // Q and this tile have landed
        __syncthreads();
        if (it == 0) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                ssi::ldmatrix_x4(qf[kk], &q_sm[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
        }

        // S = Q . K^T for the warp's 16 rows x 64 keys
        float s[TC_BK / 8][4];
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
            for (int jj = 0; jj < TC_BK / 16; ++jj) {
                uint32_t kf[4];
                ssi::ldmatrix_x4(kf, &k_sm[st][jj * 16 + (lane / 16) * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
                ssi::mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
                ssi::mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
            }
        }

        // scale, mask (the diagonal or ragged last tile, or any tile with segments), row max
        const int k0 = it * TC_BK;
        const bool need_mask = segb != nullptr || it == n_tiles - 1;
        float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale;
                if (need_mask) {
                    const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
                    const int qp = e < 2 ? row_lo : row_hi;
                    bool keep = kp < kv_end && (!causal || kp <= qp);
                    if (segb != nullptr) keep = keep && segb[kp] == (e < 2 ? qseg_lo : qseg_hi);
                    x = keep ? x : NEG_INF;
                }
                s[j][e] = x;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
        }
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        m_lo = fmaxf(m_lo, mx_lo);
        m_hi = fmaxf(m_hi, mx_hi);
        const float ms_new_lo = fmaxf(m_lo, M_CLAMP);
        const float ms_new_hi = fmaxf(m_hi, M_CLAMP);
        const float alpha_lo = exp2f((ms_lo - ms_new_lo) * LOG2E);
        const float alpha_hi = exp2f((ms_hi - ms_new_hi) * LOG2E);
        ms_lo = ms_new_lo;
        ms_hi = ms_new_hi;
        l_lo *= alpha_lo;
        l_hi *= alpha_hi;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            acc[j][0] *= alpha_lo;
            acc[j][1] *= alpha_lo;
            acc[j][2] *= alpha_hi;
            acc[j][3] *= alpha_hi;
        }

        // P = exp(s - m_safe) in f32 for the row sums, bf16 A fragments for P . V
        const float sh_lo = ms_lo * LOG2E;
        const float sh_hi = ms_hi * LOG2E;
        uint32_t pf[TC_BK / 16][4];
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j) {
            const float p0 = exp2f(fmaf(s[j][0], LOG2E, -sh_lo));
            const float p1 = exp2f(fmaf(s[j][1], LOG2E, -sh_lo));
            const float p2 = exp2f(fmaf(s[j][2], LOG2E, -sh_hi));
            const float p3 = exp2f(fmaf(s[j][3], LOG2E, -sh_hi));
            l_lo += p0 + p1;
            l_hi += p2 + p3;
            pf[j / 2][(j % 2) * 2] = ssi::pack_bf16(p0, p1);
            pf[j / 2][(j % 2) * 2 + 1] = ssi::pack_bf16(p2, p3);
        }

        // O += P . V
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
            for (int dd = 0; dd < HD / 16; ++dd) {
                uint32_t vf[4];
                ssi::ldmatrix_x4_trans(vf, &v_sm[st][kk * 16 + ((lane / 8) % 2) * 8 + lane % 8][dd * 16 + (lane / 16) * 8]);
                ssi::mma_bf16(acc[2 * dd], pf[kk], vf[0], vf[1]);
                ssi::mma_bf16(acc[2 * dd + 1], pf[kk], vf[2], vf[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float ls_lo = fmaxf(l_lo, 1e-30f);
    const float ls_hi = fmaxf(l_hi, 1e-30f);
    if (row_lo < S) {
        bf16* orow = o + (((long long)b * S + row_lo) * Hq + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
                __floats2bfloat162_rn(acc[j][0] / ls_lo, acc[j][1] / ls_lo);
        if (t4 == 0) lse[((long long)b * Hq + h) * S + row_lo] = ms_lo + logf(ls_lo);
    }
    if (row_hi < S) {
        bf16* orow = o + (((long long)b * S + row_hi) * Hq + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
                __floats2bfloat162_rn(acc[j][2] / ls_hi, acc[j][3] / ls_hi);
        if (t4 == 0) lse[((long long)b * Hq + h) * S + row_hi] = ms_hi + logf(ls_hi);
    }
}

// ---- f32: scalar FMAs (parity path) -----------------------------------------

constexpr int THREADS = 128;
constexpr int BK = 32;

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
        qr[c] = row_ok ? q[b * q_sb + qpos * q_ss + h * q_sh + c] * scale : 0.f;
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
            const bool in = kp < kv_end;
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
    float* orow = o + (((long long)b * S + qpos) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) orow[c] = acc[c] / l_safe;
    lse[((long long)b * Hq + h) * S + qpos] = ms + logf(l_safe);
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const int* segp, void* o, float* lsep,
                   int B, int S, int Hq, int n_rep,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int causal, float scale, cudaStream_t st) {
    if (dtype == ssi::kBFloat16) {
        if constexpr (HD == 128) {  // the Hopper kernel (flash_hd128_fwd.cu)
            return ssi::flash_fwd_hd128_bf16(q, k, v, segp, o, lsep, B, S, Hq, Hq / n_rep, q_sb, q_ss, q_sh, k_sb,
                                             k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, st);
        } else {
            // cp.async moves 16-byte pieces: every row start must be 16-byte aligned
            const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
            for (long long s : strides)
                if (s % 8 != 0) return cudaErrorInvalidValue;
            const uintptr_t bases =
                reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
            if (bases % 16 != 0) return cudaErrorInvalidValue;
            const dim3 grid(Hq, B, (S + TC_BQ - 1) / TC_BQ);
            flash_fwd_bf16_kernel<<<grid, TC_THREADS, 0, st>>>(
                static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), segp,
                static_cast<bf16*>(o), lsep, S, Hq, n_rep,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale);
        }
    } else if (dtype == ssi::kFloat32) {
        const int bq = THREADS / n_rep;
        const dim3 grid((S + bq - 1) / bq, Hq / n_rep, B);
        flash_fwd_f32_kernel<HD><<<grid, THREADS, 0, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), segp,
            static_cast<float*>(o), lsep, S, Hq, n_rep, bq,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// hd: head_dim, 64 or 128
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
    if (hd == 64)
        err = launch<64>(dtype, q, k, v, segp, o, lsep, B, S, Hq, n_rep, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, causal, scale, st);
    else if (hd == 128)
        err = launch<128>(dtype, q, k, v, segp, o, lsep, B, S, Hq, n_rep, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                          v_ss, v_sh, causal, scale, st);
    else
        err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}
