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
// - dk/dv kernel: one block per (batch, kv head, 64-key tile), looping over
//   the q tiles at and after the causal diagonal and over the n_rep q heads
//   of its kv head in a fixed order;
// - dq kernel: one block per (batch, q head, 64-query tile), looping over the
//   key tiles up to the diagonal.
// Each block recomputes S and dP for its tile pairs: 7 products are issued
// where the TPU forms 5 (the price of no atomics).
//
// Design of the bf16 kernels (4 warps, each owning 16 rows of the block's
// tile; mma.sync m16n8k16 fed by ldmatrix from shared rows padded to 144
// bytes; every accumulator in registers; ptxas gives dk/dv 249 registers
// and dq 224, no spills, so 2 blocks per SM, 37-38 KB of shared memory each):
// - dk/dv works on transposed scores. Each warp holds its 16 K rows and 16 V
//   rows as A fragments for the whole block. Per (q tile, q head) pair it
//   forms S^T = K.Q^T and dP^T = V.dO^T (Q and dO are [q, d] tiles: the
//   K-contiguous B operand, plain ldmatrix), then P^T and dS^T in registers,
//   with lse and delta of the pair's queries staged beside the tile. The C
//   fragments of P^T and dS^T are the A fragments of dV += P^T.dO and
//   dK += dS^T.Q (the C -> A identity of mma.cuh), with dO and Q read by
//   ldmatrix.trans. dK and dV stay in registers (16 x 64 f32 per warp each)
//   and are written once, at the end. The Q/dO tiles and their lse/delta
//   ride a 2-stage cp.async ring, so the next pair loads under this pair's
//   products; K and V pass through the ring's second stage on the way to
//   registers.
// - dq is the forward's shape plus one product: Q and dO held as A
//   fragments, lse and delta per row in registers, K/V tiles through a
//   2-stage cp.async ring, S = Q.K^T and dP = dO.V^T, P and dS in registers,
//   dQ += dS.K with K read by ldmatrix.trans.
// - causal: dk/dv blocks start at the diagonal q tile and dq blocks stop at
//   it; only the diagonal and the ragged last tile (or any tile with segment
//   ids) apply the mask; the heaviest blocks launch first (low key tiles for
//   dk/dv, high q tiles for dq). Rows past S are zero-filled by the copy, so
//   no stale row meets p = 0 as 0 x NaN, and are masked on store.
//
// The f32 kernels keep exact f32 arithmetic for the parity checks (TF32
// would not meet them): S, dP and the gradient sums are f32 tiles in shared
// memory, multiplied by scalar FMAs (tile_mma.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int HD = 64;       // head_dim
constexpr int BT = 64;       // q and key tile rows
constexpr float LOG2E = 1.4426950408889634f;

constexpr int THREADS = 256;  // delta and f32 kernels

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

// ---- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps of 16 rows
constexpr int LDS = ssi::LDS64;

// A fragments of the warp's 16 rows of a staged [64, 64] tile, one per k16 step
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[HD / 16][4], const bf16 (*t)[LDS], int warp, int lane) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ssi::ldmatrix_x4(f[kk], &t[warp * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
}

// c [16 x 64] = a [16 x 64] . x^T: x is a staged [64, 64] tile whose rows run
// along the product's N and whose columns along its K (plain ldmatrix)
__device__ __forceinline__ void mma_abt(float (&c)[BT / 8][4], const uint32_t (&a)[HD / 16][4], const bf16 (*x)[LDS],
                                        int lane) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < BT / 16; ++jj) {
            uint32_t b[4];
            ssi::ldmatrix_x4(b, &x[jj * 16 + (lane / 16) * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
            ssi::mma_bf16(c[2 * jj], a[kk], b[0], b[1]);
            ssi::mma_bf16(c[2 * jj + 1], a[kk], b[2], b[3]);
        }
    }
}

// c [16 x 64] += a [16 x 64] . x: x is a staged [64, 64] tile whose rows run
// along the product's K (ldmatrix.trans)
__device__ __forceinline__ void mma_ab(float (&c)[HD / 8][4], const uint32_t (&a)[BT / 16][4], const bf16 (*x)[LDS],
                                       int lane) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
            uint32_t b[4];
            ssi::ldmatrix_x4_trans(b, &x[kk * 16 + ((lane / 8) % 2) * 8 + lane % 8][dd * 16 + (lane / 16) * 8]);
            ssi::mma_bf16(c[2 * dd], a[kk], b[0], b[1]);
            ssi::mma_bf16(c[2 * dd + 1], a[kk], b[2], b[3]);
        }
    }
}

// the C fragments of a [16 x 64] f32 tile, cast to bf16, as the A fragments
// of the next product (four k16 steps)
__device__ __forceinline__ void pack_a(uint32_t (&a)[BT / 16][4], const float (&c)[BT / 8][4]) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
        a[j / 2][(j % 2) * 2] = ssi::pack_bf16(c[j][0], c[j][1]);
        a[j / 2][(j % 2) * 2 + 1] = ssi::pack_bf16(c[j][2], c[j][3]);
    }
}

// the warp's 16 rows x 64 columns of a [rows, 64] gradient, times mul, in bf16;
// rows at or past S are not written
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride, const float (&c)[HD / 8][4], int row_lo,
                                           int S, float mul, int t4) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int row = row_lo + hi * 8;
        if (row >= S) continue;
        bf16* p = out + row * row_stride + 2 * t4;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(p + j * 8) =
                __floats2bfloat162_rn(c[j][2 * hi] * mul, c[j][2 * hi + 1] * mul);
    }
}

__global__ void __launch_bounds__(TC_THREADS, 2) dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq, int Hkv, int causal, float scale) {
    __shared__ __align__(128) bf16 q_sm[2][BT][LDS];
    __shared__ __align__(128) bf16 do_sm[2][BT][LDS];
    __shared__ __align__(16) float lse_sm[2][BT];
    __shared__ __align__(16) float delta_sm[2][BT];

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int kt = blockIdx.z;  // low key tiles (the most q tiles under causal) launch first
    const int k0 = kt * BT;
    const int n_rep = Hq / Hkv;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const long long q_row = (long long)Hq * HD;  // elements between consecutive positions
    const long long kv_row = (long long)Hkv * HD;
    const int n_q = (S + BT - 1) / BT;
    const int qi0 = causal ? kt : 0;  // causal: q tiles before the diagonal see no key here
    const int n_pairs = (n_q - qi0) * n_rep;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;

    // stage pair p (q tile qi0 + p / n_rep, q head kvh * n_rep + p % n_rep):
    // its Q and dO rows, and the lse and delta of its queries (0 past S)
    auto load_pair = [&](int p, int st) {
        const int q0 = (qi0 + p / n_rep) * BT;
        const int h = kvh * n_rep + p % n_rep;
        const long long off = (long long)b * S * q_row + (long long)h * HD;
        ssi::load_tile64_async<TC_THREADS>(q_sm[st], q + off, q_row, q0, S);
        ssi::load_tile64_async<TC_THREADS>(do_sm[st], dout + off, q_row, q0, S);
        const int i = threadIdx.x % BT;
        const float* src = (threadIdx.x < BT ? lse : delta) + ((long long)b * Hq + h) * S;
        float* dst = threadIdx.x < BT ? &lse_sm[st][i] : &delta_sm[st][i];
        ssi::cp_async4(dst, q0 + i < S ? src + q0 + i : src, q0 + i < S ? 4 : 0);
    };

    // K and V pass through stage 1 on their way to registers; pair 0 loads into stage 0
    const long long kv_off = (long long)b * S * kv_row + (long long)kvh * HD;
    ssi::load_tile64_async<TC_THREADS>(q_sm[1], k + kv_off, kv_row, k0, S);
    ssi::load_tile64_async<TC_THREADS>(do_sm[1], v + kv_off, kv_row, k0, S);
    load_pair(0, 0);
    ssi::cp_async_commit();
    ssi::cp_async_wait<0>();
    __syncthreads();
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
    load_a_frags(kf, q_sm[1], warp, lane);
    load_a_frags(vf, do_sm[1], warp, lane);
    __syncthreads();  // stage 1 is free for pair 1

    // this thread's two key rows: lo (g) and hi (g + 8) of the warp's 16
    const int kp_lo = k0 + warp * 16 + g;
    const int kp_hi = kp_lo + 8;
    const int kseg_lo = (segb != nullptr && kp_lo < S) ? segb[kp_lo] : 0;
    const int kseg_hi = (segb != nullptr && kp_hi < S) ? segb[kp_hi] : 0;
    const float scale2 = scale * LOG2E;

    float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
        dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
        dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
    }

    for (int p = 0; p < n_pairs; ++p) {
        const int st = p & 1;
        if (p + 1 < n_pairs) load_pair(p + 1, st ^ 1);  // loads while this pair is multiplied
        ssi::cp_async_commit();
        ssi::cp_async_wait<1>();  // this pair has landed
        __syncthreads();

        const int qi = qi0 + p / n_rep;
        const int q0 = qi * BT;
        float s[BT / 8][4], dp[BT / 8][4];
        mma_abt(s, kf, q_sm[st], lane);    // S^T = K . Q^T  [keys x queries]
        mma_abt(dp, vf, do_sm[st], lane);  // dP^T = V . dO^T

        // P^T = exp(scale S^T - lse[q]) (0 where masked), dS^T = P^T (dP^T - delta[q])
        const bool need_mask = segb != nullptr || qi == n_q - 1 || (causal && qi == kt);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
            const int c = j * 8 + 2 * t4;  // this thread's two query columns: c, c + 1
            const float2 ls = *reinterpret_cast<const float2*>(&lse_sm[st][c]);
            const float2 dl = *reinterpret_cast<const float2*>(&delta_sm[st][c]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float l = (e & 1) ? ls.y : ls.x;
                float pr = exp2f(fmaf(s[j][e], scale2, -l * LOG2E));
                if (need_mask) {
                    const int qp = q0 + c + (e & 1);
                    const int kp = e < 2 ? kp_lo : kp_hi;
                    bool keep = qp < S && (!causal || kp <= qp);
                    if (segb != nullptr) keep = keep && segb[qp] == (e < 2 ? kseg_lo : kseg_hi);
                    pr = keep ? pr : 0.f;
                }
                s[j][e] = pr;
                dp[j][e] = pr * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
            }
        }
        uint32_t pa[BT / 16][4], da[BT / 16][4];
        pack_a(pa, s);
        pack_a(da, dp);
        mma_ab(dv_acc, pa, do_sm[st], lane);  // dV += P^T . dO
        mma_ab(dk_acc, da, q_sm[st], lane);   // dK += dS^T . Q
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    store_rows(dk + kv_off, kv_row, dk_acc, kp_lo, S, scale, t4);
    store_rows(dv + kv_off, kv_row, dv_acc, kp_lo, S, 1.f, t4);
}

__global__ void __launch_bounds__(TC_THREADS, 2) dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ seg,
    bf16* __restrict__ dq, int S, int Hq, int Hkv, int causal, float scale) {
    __shared__ __align__(128) bf16 k_sm[2][BT][LDS];
    __shared__ __align__(128) bf16 v_sm[2][BT][LDS];

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;  // last q tiles (most keys) first
    const int kvh = h / (Hq / Hkv);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const long long q_row = (long long)Hq * HD;
    const long long kv_row = (long long)Hkv * HD;
    const long long q_off = (long long)b * S * q_row + (long long)h * HD;
    const long long kv_off = (long long)b * S * kv_row + (long long)kvh * HD;
    const int kv_end = causal ? min(S, q0 + BT) : S;  // causal: keys past the q tile are masked
    const int n_tiles = (kv_end + BT - 1) / BT;

    // Q and dO pass through stage 1 on their way to registers; K/V tile 0 loads into stage 0
    ssi::load_tile64_async<TC_THREADS>(k_sm[1], q + q_off, q_row, q0, S);
    ssi::load_tile64_async<TC_THREADS>(v_sm[1], dout + q_off, q_row, q0, S);
    ssi::load_tile64_async<TC_THREADS>(k_sm[0], k + kv_off, kv_row, 0, kv_end);
    ssi::load_tile64_async<TC_THREADS>(v_sm[0], v + kv_off, kv_row, 0, kv_end);
    ssi::cp_async_commit();
    ssi::cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[HD / 16][4], dof[HD / 16][4];
    load_a_frags(qf, k_sm[1], warp, lane);
    load_a_frags(dof, v_sm[1], warp, lane);
    __syncthreads();  // stage 1 is free for tile 1

    // this thread's two query rows: lo (g) and hi (g + 8) of the warp's 16
    const int row_lo = q0 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    const long long lrow = ((long long)b * Hq + h) * S;
    const float lse_lo = row_lo < S ? lse[lrow + row_lo] * LOG2E : 0.f;
    const float lse_hi = row_hi < S ? lse[lrow + row_hi] * LOG2E : 0.f;
    const float delta_lo = row_lo < S ? delta[lrow + row_lo] : 0.f;
    const float delta_hi = row_hi < S ? delta[lrow + row_hi] : 0.f;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;
    const int qseg_lo = (segb != nullptr && row_lo < S) ? segb[row_lo] : 0;
    const int qseg_hi = (segb != nullptr && row_hi < S) ? segb[row_hi] : 0;
    const float scale2 = scale * LOG2E;

    float dq_acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        if (it + 1 < n_tiles) {  // the next tile loads while this one is multiplied
            ssi::load_tile64_async<TC_THREADS>(k_sm[st ^ 1], k + kv_off, kv_row, (it + 1) * BT, kv_end);
            ssi::load_tile64_async<TC_THREADS>(v_sm[st ^ 1], v + kv_off, kv_row, (it + 1) * BT, kv_end);
        }
        ssi::cp_async_commit();
        ssi::cp_async_wait<1>();  // this tile has landed
        __syncthreads();

        float s[BT / 8][4], dp[BT / 8][4];
        mma_abt(s, qf, k_sm[st], lane);    // S = Q . K^T
        mma_abt(dp, dof, v_sm[st], lane);  // dP = dO . V^T

        // P = exp(scale S - lse) (0 where masked), dS = P (dP - delta)
        const int k0 = it * BT;
        const bool need_mask = segb != nullptr || it == n_tiles - 1;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float pr = exp2f(fmaf(s[j][e], scale2, -(e < 2 ? lse_lo : lse_hi)));
                if (need_mask) {
                    const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
                    const int qp = e < 2 ? row_lo : row_hi;
                    bool keep = kp < kv_end && (!causal || kp <= qp);
                    if (segb != nullptr) keep = keep && segb[kp] == (e < 2 ? qseg_lo : qseg_hi);
                    pr = keep ? pr : 0.f;
                }
                dp[j][e] = pr * (dp[j][e] - (e < 2 ? delta_lo : delta_hi));
            }
        }
        uint32_t da[BT / 16][4];
        pack_a(da, dp);
        mma_ab(dq_acc, da, k_sm[st], lane);  // dQ += dS . K
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    store_rows(dq + q_off, q_row, dq_acc, row_lo, S, scale, t4);
}

// ---- f32: scalar FMAs (parity path) -------------------------------------------

constexpr int LDT = HD + 8;  // leading dimension of operand tiles (elements)
constexpr int LDF = BT + 4;  // leading dimension of f32 tiles

// Shared-memory layout of the f32 kernels (byte offsets).
struct Smem {
    static constexpr int TILE = ssi::smem_round(BT * LDT * (int)sizeof(float));
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
// (q tile q0, key tile k0) pair.
__device__ __forceinline__ void softmax_grad(float* p_t, float* ds_t, const float* s_f, const float* dp_f,
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
        if (p_t != nullptr) p_t[i * LDT + j] = p;
        ds_t[i * LDT + j] = ds;
    }
}

__device__ __forceinline__ void zero(float* p, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

__global__ void __launch_bounds__(THREADS) dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv, int causal,
    float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = Smem;
    float* k_t = reinterpret_cast<float*>(smem);
    float* v_t = reinterpret_cast<float*>(smem + L::TILE);
    float* q_t = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* do_t = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* p_t = reinterpret_cast<float*>(smem + 4 * L::TILE);
    float* ds_t = reinterpret_cast<float*>(smem + 5 * L::TILE);
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
    ssi::load_rows<float, BT, HD, THREADS>(k_t, LDT, k + kv_off, kv_row, S - k0);
    ssi::load_rows<float, BT, HD, THREADS>(v_t, LDT, v + kv_off, kv_row, S - k0);
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
            ssi::load_rows<float, BT, HD, THREADS>(q_t, LDT, q + q_off, q_row, S - q0);
            ssi::load_rows<float, BT, HD, THREADS>(do_t, LDT, dout + q_off, q_row, S - q0);
            load_q_scalars(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
            zero(s_f, BT * LDF);
            zero(dp_f, BT * LDF);
            __syncthreads();
            ssi::tile_mma<BT, BT, HD, false, true>(s_f, LDF, q_t, LDT, k_t, LDT);    // S = Q K^T
            ssi::tile_mma<BT, BT, HD, false, true>(dp_f, LDF, do_t, LDT, v_t, LDT);  // dP = dO V^T
            __syncthreads();
            softmax_grad(p_t, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
            __syncthreads();
            ssi::tile_mma<BT, HD, BT, true, false>(dv_f, LDF, p_t, LDT, do_t, LDT);  // dV += P^T dO
            ssi::tile_mma<BT, HD, BT, true, false>(dk_f, LDF, ds_t, LDT, q_t, LDT);  // dK += dS^T Q
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int j = idx / HD;
        const int c = idx % HD;
        if (k0 + j >= S) continue;
        const long long off = kv_off + j * kv_row + c;
        dk[off] = dk_f[j * LDF + c] * scale;
        dv[off] = dv_f[j * LDF + c];
    }
}

__global__ void __launch_bounds__(THREADS) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dq, int S, int Hq, int Hkv, int causal, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    using L = Smem;
    float* q_t = reinterpret_cast<float*>(smem);
    float* do_t = reinterpret_cast<float*>(smem + L::TILE);
    float* k_t = reinterpret_cast<float*>(smem + 2 * L::TILE);
    float* v_t = reinterpret_cast<float*>(smem + 3 * L::TILE);
    float* ds_t = reinterpret_cast<float*>(smem + 4 * L::TILE);
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
    ssi::load_rows<float, BT, HD, THREADS>(q_t, LDT, q + q_off, q_row, S - q0);
    ssi::load_rows<float, BT, HD, THREADS>(do_t, LDT, dout + q_off, q_row, S - q0);
    load_q_scalars(lse_s, delta_s, qseg_s, lse, delta, seg, b, h, Hq, S, q0);
    zero(dq_f, BT * LDF);

    const int n_k = causal ? blockIdx.x + 1 : (S + BT - 1) / BT;  // causal: keys past the q tile are masked
    for (int ki = 0; ki < n_k; ++ki) {
        const int k0 = ki * BT;
        __syncthreads();  // the previous tile's dQ product is done with k_t, ds_t
        const long long kv_off = ((long long)b * S + k0) * kv_row + (long long)kvh * HD;
        ssi::load_rows<float, BT, HD, THREADS>(k_t, LDT, k + kv_off, kv_row, S - k0);
        ssi::load_rows<float, BT, HD, THREADS>(v_t, LDT, v + kv_off, kv_row, S - k0);
        for (int j = threadIdx.x; j < BT; j += blockDim.x) {
            kseg_s[j] = (segs && k0 + j < S) ? seg[(long long)b * S + k0 + j] : 0;
        }
        zero(s_f, BT * LDF);
        zero(dp_f, BT * LDF);
        __syncthreads();
        ssi::tile_mma<BT, BT, HD, false, true>(s_f, LDF, q_t, LDT, k_t, LDT);    // S = Q K^T
        ssi::tile_mma<BT, BT, HD, false, true>(dp_f, LDF, do_t, LDT, v_t, LDT);  // dP = dO V^T
        __syncthreads();
        softmax_grad(nullptr, ds_t, s_f, dp_f, lse_s, delta_s, qseg_s, kseg_s, q0, k0, S, causal, segs, scale);
        __syncthreads();
        ssi::tile_mma<BT, HD, BT, false, false>(dq_f, LDF, ds_t, LDT, k_t, LDT);  // dQ += dS K
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * HD; idx += blockDim.x) {
        const int i = idx / HD;
        const int c = idx % HD;
        if (q0 + i >= S) continue;
        dq[q_off + i * q_row + c] = dq_f[i * LDF + c] * scale;
    }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int S, int Hq, cudaStream_t stream) {
    const long long rows = (long long)B * S * Hq;
    delta_kernel<T><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, Hq, rows);
    return cudaGetLastError();
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* o, const float* dout,
                       const float* lse, const int* seg, float* delta, float* dq, float* dk, float* dv, int B, int S,
                       int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
    cudaError_t err = launch_delta<float>(o, dout, delta, B, S, Hq, stream);
    if (err != cudaSuccess) return err;
    const int n_t = (S + BT - 1) / BT;
    err = cudaFuncSetAttribute(dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::DKDV);
    if (err != cudaSuccess) return err;
    dkdv_f32_kernel<<<dim3(n_t, Hkv, B), THREADS, Smem::DKDV, stream>>>(q, k, v, dout, lse, delta, seg, dk, dv, S,
                                                                         Hq, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::DQ);
    if (err != cudaSuccess) return err;
    dq_f32_kernel<<<dim3(n_t, Hq, B), THREADS, Smem::DQ, stream>>>(q, k, v, dout, lse, delta, seg, dq, S, Hq, Hkv,
                                                                    causal, scale);
    return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                        const float* lse, const int* seg, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int S,
                        int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
    // cp.async moves 16-byte pieces: every row of q, k, v and do must start 16-byte aligned
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
         reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
        return cudaErrorInvalidValue;
    cudaError_t err = launch_delta<bf16>(o, dout, delta, B, S, Hq, stream);
    if (err != cudaSuccess) return err;
    const int n_t = (S + BT - 1) / BT;
    dkdv_bf16_kernel<<<dim3(Hkv, B, n_t), TC_THREADS, 0, stream>>>(q, k, v, dout, lse, delta, seg, dk, dv, S, Hq,
                                                                    Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_bf16_kernel<<<dim3(Hq, B, n_t), TC_THREADS, 0, stream>>>(q, k, v, dout, lse, delta, seg, dq, S, Hq, Hkv,
                                                                 causal, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ssi_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, const void* seg, void* delta, void* dq,
                                       void* dk, void* dv, int B, int S, int Hq, int Hkv, int causal, float scale,
                                       void* stream) {
    if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const float* lsep = static_cast<const float*>(lse);
    const int* segp = static_cast<const int*>(seg);
    float* deltap = static_cast<float*>(delta);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = launch_f32(static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                         static_cast<const float*>(o), static_cast<const float*>(dout), lsep, segp, deltap,
                         static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, S, Hq, Hkv,
                         causal, scale, st);
    } else if (dtype == ssi::kBFloat16) {
        err = launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                          static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lsep, segp, deltap,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Hq, Hkv,
                          causal, scale, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
