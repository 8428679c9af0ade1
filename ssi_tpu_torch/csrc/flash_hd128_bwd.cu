// Flash-attention backward, bf16, head_dim 128 (Llama 3.2 3B, Llama 3.1 8B):
// dq, dk, dv for causal or full GQA with optional packed segment ids,
// designed for Hopper.
//
// Replaces, at head_dim 128 in bf16, the TPU kernels
// ssi_tpu/ops/flash_attention.py `_bwd_kernel` and `_bwd_kernel_grouped`;
// flash_attention_bwd.cu keeps the head_dim-64 and f32 kernels and dispatches
// here. Semantics are that file's: S = scale * q.k recomputed, P = exp(S -
// lse) with masked entries set to 0 explicitly (a fully masked row gives zero
// gradients), delta = rowsum(o * do) in f32, dS = P (dP - delta), P and dS
// cast to bf16 before the dV, dK and dQ products, scale multiplied into dq
// and dk.
//
// What bounds it: the five S^2 * 128 products (S, dP, dV, dK, dQ) at the 3B
// training shape (B2 S2048, 24 q / 8 kv heads): operations. The layout stays
// the deterministic two-kernel one of the head_dim-64 path (no atomics, so
// the gradients are bitwise equal run to run), which issues 7 products where
// 5 are counted (S and dP are formed in both kernels):
// - delta: a warp per two rows, 16 lanes a row (coalesced 16-byte reads);
// - dK/dV: a block per (kv head, batch, 128-key tile), looping over the
//   64-query tiles from the causal diagonal on and, inside each, over the
//   n_rep q heads of its kv head, in a fixed order;
// - dQ: a block per (q head, batch, 128-query tile), looping over 128-key
//   tiles up to the diagonal.
// Both take the forward's shape (flash_hopper_fwd.cu): 2 warpgroups of 64 rows
// each, no producer warpgroup (ptxas would hold every thread of a 384-thread
// block to 168 registers; dK/dV needs about 240), thread 0 issuing the first
// TMA loads and the warpgroup that releases a stage second refilling it;
// tiles in shared memory as two 64-column halves with the 128-byte swizzle
// (hopper.cuh); the results leave through each warpgroup's own freed tile
// rows by TMA store, which skips rows past S.
// - dK/dV: K and V (this block's 128 keys) load once; the Q and dO tiles of
//   each (q tile, q head) pair ride a 2-stage ring by TMA, with that pair's
//   lse and delta, which the refilling warp's lanes copy by cp.async (rows
//   of [B, Hq, S] f32 do not start 16-byte aligned for an odd S, as a TMA box
//   would need) and which arrive on the stage's barrier when they land.
//   Each warpgroup forms S^T = K.Q^T and dP^T = V.dO^T for its 64 keys
//   (wgmma m64n64k16, both operands K-major in shared memory; P^T's
//   exponentials run under the dP^T product), then dS^T in the accumulators,
//   and adds dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from registers
//   (the RS form) and dO and Q through MN-major descriptors (m64n128k16).
//   dK and dV (64 x 128 f32 each) stay in registers, 128 a thread, and are
//   written once. Shared memory: K 32 + V 32 + 2 x (Q 16 + dO 16) KB +
//   lse/delta = 129 KB.
// - dQ: Q and dO (128 rows) load once; 128-key K and V tiles ride a 2-stage
//   ring. S = Q.K^T and dP = dO.V^T (m64n128k16, K-major), P and dS in the
//   accumulators, dQ += dS.K with dS from registers and K MN-major
//   (m64n128k16); S, dP, dS and dQ hold about 230 registers a thread. lse
//   and delta of the thread's two rows are read once. Shared memory: Q 32 +
//   dO 32 + 2 x (K 32 + V 32) KB = 192 KB.
// - causal: dK/dV blocks start at the diagonal q tile and dQ blocks stop at
//   it; a warpgroup skips the products of a tile its rows cannot see (keys
//   all after its queries) and masks only the tiles that cross the diagonal
//   or the ragged end (or every tile, with segment ids). The heaviest blocks
//   launch first (low key tiles for dK/dV, high q tiles for dQ). TMA
//   zero-fills rows past S.
// Its times on the card beside its bound and SDPA's: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hopper.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ssi::hopper;
using bf16 = __nv_bfloat16;

constexpr int HD = 128;
constexpr int THREADS = 256;  // two warpgroups
constexpr int STAGES = 2;
constexpr int BOX = 64;       // rows of every TMA box
constexpr float LOG2E = 1.4426950408889634f;

// ---- delta = rowsum(o * do) ---------------------------------------------------------

constexpr int DELTA_THREADS = 256;

// two (b, s, q head) rows a warp, 16 lanes a row, each lane 8 columns read as
// 16 bytes: a warp reads 512 contiguous bytes of o and of do; the 16 lanes'
// f32 sums meet in a fixed shuffle tree
__global__ void __launch_bounds__(DELTA_THREADS) delta_hd128_kernel(const bf16* __restrict__ o,
                                                                    const bf16* __restrict__ dout,
                                                                    float* __restrict__ delta, int S, int Hq,
                                                                    long long rows) {
    const long long r = (blockIdx.x * (long long)DELTA_THREADS + threadIdx.x) / 16;  // row (b * S + s) * Hq + h
    const int c = (threadIdx.x % 16) * 8;
    float acc = 0.f;
    if (r < rows) {
        float a[8], d[8];
        ssi::load8(o + r * HD + c, a);
        ssi::load8(dout + r * HD + c, d);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], d[i], acc);
    }
#pragma unroll
    for (int w = 8; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (r < rows && threadIdx.x % 16 == 0) {
        const long long h = r % Hq;
        const long long bs = r / Hq;
        delta[(bs / S * Hq + h) * S + bs % S] = acc;
    }
}

// ---- dK / dV ----------------------------------------------------------------------

constexpr int KV_ROWS = 128;  // keys a dK/dV block
constexpr int Q_ROWS = 64;    // queries a Q/dO stage
constexpr uint32_t KV_HALF_BYTES = KV_ROWS * 64 * 2;  // 16 KB
constexpr uint32_t Q_HALF_BYTES = Q_ROWS * 64 * 2;    // 8 KB

struct DkdvSmem {
    bf16 k[2][KV_ROWS * 64];
    bf16 v[2][KV_ROWS * 64];
    bf16 q[STAGES][2][Q_ROWS * 64];
    bf16 dout[STAGES][2][Q_ROWS * 64];
    float lse[STAGES][Q_ROWS];
    float delta[STAGES][Q_ROWS];
    uint64_t kv_full, full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
constexpr int DKDV_SMEM = sizeof(DkdvSmem) + 1024;

__global__ void __launch_bounds__(THREADS, 1) dkdv_hd128_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg, int S, int Hq, int Hkv, int causal, float scale) {
    extern __shared__ unsigned char smem_raw[];
    DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(hw::align1024(smem_raw));

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.z * KV_ROWS;  // low key tiles (the most q tiles under causal) launch first
    const int n_rep = Hq / Hkv;
    const int n_q = (S + Q_ROWS - 1) / Q_ROWS;
    const int qi0 = causal ? k0 / Q_ROWS : 0;  // causal: q tiles before the diagonal see no key here
    const int n_pairs = (n_q - qi0) * n_rep;

    // stage pair p (q tile qi0 + p / n_rep, q head kvh * n_rep + p % n_rep), by the 32
    // lanes of one warp: lane 0 its Q and dO rows by TMA (zero past S), every
    // lane two of its queries' lse and delta by cp.async (lse and delta rows
    // of an odd S do not start 16-byte aligned, as TMA wants; 0 past S)
    auto load_pair = [&](int p, int st, int lane) {
        const int q0 = (qi0 + p / n_rep) * Q_ROWS;
        const int h = kvh * n_rep + p % n_rep;
        if (lane == 0) {
            hw::mbar_expect_tx(&sm.full[st], 4 * Q_HALF_BYTES);
            for (int half = 0; half < 2; ++half) {
                hw::tma_load_4d(sm.q[st][half], &tq, &sm.full[st], 64 * half, h, q0, b);
                hw::tma_load_4d(sm.dout[st][half], &tdo, &sm.full[st], 64 * half, h, q0, b);
            }
        }
        const long long row = ((long long)b * Hq + h) * S;
        for (int i = lane; i < Q_ROWS; i += 32) {
            const bool in = q0 + i < S;
            ssi::cp_async4(&sm.lse[st][i], lse + (in ? row + q0 + i : 0), in ? 4 : 0);
            ssi::cp_async4(&sm.delta[st][i], delta + (in ? row + q0 + i : 0), in ? 4 : 0);
        }
        hw::cp_async_arrive(&sm.full[st]);
    };
    if (threadIdx.x < 32) {  // warp 0: barriers, then K and V and the first pairs
        if (threadIdx.x == 0) {
            hw::mbar_init(&sm.kv_full, 1);
            for (int st = 0; st < STAGES; ++st) {
                hw::mbar_init(&sm.full[st], 1 + 32);  // lane 0's expect_tx + the copying lanes
                sm.done[st] = 0;
            }
            hw::fence_barrier_init();
            hw::mbar_expect_tx(&sm.kv_full, 4 * KV_HALF_BYTES);
            for (int half = 0; half < 2; ++half)
                for (int r = 0; r < KV_ROWS; r += BOX) {
                    hw::tma_load_4d(&sm.k[half][r * 64], &tk, &sm.kv_full, 64 * half, kvh, k0 + r, b);
                    hw::tma_load_4d(&sm.v[half][r * 64], &tv, &sm.kv_full, 64 * half, kvh, k0 + r, b);
                }
        }
        __syncwarp();
        for (int p = 0; p < min(STAGES, n_pairs); ++p) load_pair(p, p, threadIdx.x);
    }
    __syncthreads();

    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int kr0 = k0 + cw * 64;  // this warpgroup's 64 keys
    // this thread's two key rows: lo (g) and hi (g + 8) of its warp's 16
    const int kp_lo = kr0 + warp * 16 + g;
    const int kp_hi = kp_lo + 8;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;
    const int kseg_lo = (segb != nullptr && kp_lo < S) ? segb[kp_lo] : 0;
    const int kseg_hi = (segb != nullptr && kp_hi < S) ? segb[kp_hi] : 0;
    const float scale2 = scale * LOG2E;
    const uint32_t k_base = ssi::smem_addr(sm.k[0]) + cw * 64 * 128;  // the warpgroup's 64 keys of half 0
    const uint32_t v_base = ssi::smem_addr(sm.v[0]) + cw * 64 * 128;

    float dk_acc[64], dv_acc[64];  // [64 keys x 128]: n8 block j of the columns at [4j ..]
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hw::mbar_wait(&sm.kv_full, 0);
    for (int p = 0; p < n_pairs; ++p) {
        const int st = p % STAGES;
        const int q0 = (qi0 + p / n_rep) * Q_ROWS;
        hw::mbar_wait(&sm.full[st], (p / STAGES) & 1);
        // keys all past S, or all after the tile's queries: nothing to add
        if (kr0 < S && !(causal && q0 + Q_ROWS <= kr0)) {
            const uint32_t q_addr = hw::opaque(ssi::smem_addr(sm.q[st][0]));
            const uint32_t do_addr = hw::opaque(ssi::smem_addr(sm.dout[st][0]));
            const uint32_t k_addr = hw::opaque(k_base);
            const uint32_t v_addr = hw::opaque(v_base);
            float s[32], dp[32];  // S^T, dP^T [64 keys x 64 queries]
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * KV_HALF_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * Q_HALF_BYTES + (kk % 4) * 32;
                hw::wgmma_ss_n64(s, hw::desc_sw128(k_addr + a_off, 16, 1024), hw::desc_sw128(q_addr + b_off, 16, 1024),
                                 kk > 0);
            }
            hw::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * KV_HALF_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * Q_HALF_BYTES + (kk % 4) * 32;
                hw::wgmma_ss_n64(dp, hw::desc_sw128(v_addr + a_off, 16, 1024),
                                 hw::desc_sw128(do_addr + b_off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<1>();  // S^T has landed; dP^T may still run
            hw::fence_regs(s);

            // P^T = exp(scale S^T - lse[q]) (0 where masked), under the dP^T product
            const bool need_mask = segb != nullptr || q0 + Q_ROWS > S || (causal && q0 < kr0 + 64);
#pragma unroll
            for (int j = 0; j < Q_ROWS / 8; ++j) {
                const int c = j * 8 + 2 * t4;  // this thread's two query columns: c, c + 1
                const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[st][c]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float pr = hw::exp2_ftz(fmaf(s[4 * j + e], scale2, -((e & 1) ? ls.y : ls.x) * LOG2E));
                    if (need_mask) {
                        const int qp = q0 + c + (e & 1);
                        const int kp = e < 2 ? kp_lo : kp_hi;
                        bool keep = qp < S && (!causal || kp <= qp);
                        if (segb != nullptr) keep = keep && segb[qp] == (e < 2 ? kseg_lo : kseg_hi);
                        pr = keep ? pr : 0.f;
                    }
                    s[4 * j + e] = pr;
                }
            }
            hw::wgmma_wait<0>();
            hw::fence_regs(dp);
            // dS^T = P^T (dP^T - delta[q])
#pragma unroll
            for (int j = 0; j < Q_ROWS / 8; ++j) {
                const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][j * 8 + 2 * t4]);
#pragma unroll
                for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
            }
            uint32_t pa[16], da[16];
            hw::pack_a<32>(pa, s);
            hw::pack_a<32>(da, dp);
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < Q_ROWS / 16; ++kk)  // dV += P^T . dO
                hw::wgmma_rs_n128_mn(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                                     hw::desc_sw128(do_addr + kk * 16 * 128, Q_HALF_BYTES, 1024),
                                     1);
#pragma unroll
            for (int kk = 0; kk < Q_ROWS / 16; ++kk)  // dK += dS^T . Q
                hw::wgmma_rs_n128_mn(dk_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                                     hw::desc_sw128(q_addr + kk * 16 * 128, Q_HALF_BYTES, 1024),
                                     1);
            hw::wgmma_commit();
            hw::fence_regs(pa);
            hw::fence_regs(da);
            hw::wgmma_wait<0>();
            hw::fence_regs(dv_acc);
            hw::fence_regs(dk_acc);
            hw::fence_regs(pa);
            hw::fence_regs(da);
        }
        if (warp == 0) {  // the second warpgroup done with this stage refills it with pair p + STAGES
            const bool last = __shfl_sync(0xffffffffu, lane == 0 && hw::release_last(&sm.done[st]), 0);
            if (last && p + STAGES < n_pairs) load_pair(p + STAGES, st, lane);
        }
    }

    // dK and dV into this warpgroup's own K and V rows (free since its last
    // products), then out by TMA
    hw::store_tile(dk_acc, scale, scale, reinterpret_cast<unsigned char*>(sm.k[0]) + cw * 64 * 128, KV_HALF_BYTES,
                   &tdk, kvh, kr0, b, 1 + cw);
    hw::store_tile(dv_acc, 1.f, 1.f, reinterpret_cast<unsigned char*>(sm.v[0]) + cw * 64 * 128, KV_HALF_BYTES, &tdv,
                   kvh, kr0, b, 1 + cw);
}

// ---- dQ ---------------------------------------------------------------------------

constexpr int DQ_ROWS = 128;  // queries a dQ block
constexpr int K_ROWS = 128;   // keys a K/V stage
constexpr uint32_t DQ_HALF_BYTES = DQ_ROWS * 64 * 2;  // 16 KB
constexpr uint32_t K_HALF_BYTES = K_ROWS * 64 * 2;    // 16 KB

struct DqSmem {
    bf16 q[2][DQ_ROWS * 64];
    bf16 dout[2][DQ_ROWS * 64];
    bf16 k[STAGES][2][K_ROWS * 64];
    bf16 v[STAGES][2][K_ROWS * 64];
    uint64_t q_full, full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
constexpr int DQ_SMEM = sizeof(DqSmem) + 1024;

__global__ void __launch_bounds__(THREADS, 1) dq_hd128_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, int S, int Hq, int Hkv, int causal, float scale) {
    extern __shared__ unsigned char smem_raw[];
    DqSmem& sm = *reinterpret_cast<DqSmem*>(hw::align1024(smem_raw));

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;  // last q tiles (most keys) first
    const int kvh = h / (Hq / Hkv);
    const int kv_end = causal ? min(S, q0 + DQ_ROWS) : S;  // causal: keys past the q tile are masked
    const int n_tiles = (kv_end + K_ROWS - 1) / K_ROWS;

    auto load_kv = [&](int it, int st) {  // key tile it's K and V into stage st
        hw::mbar_expect_tx(&sm.full[st], 4 * K_HALF_BYTES);
        for (int half = 0; half < 2; ++half)
            for (int r = 0; r < K_ROWS; r += BOX) {
                hw::tma_load_4d(&sm.k[st][half][r * 64], &tk, &sm.full[st], 64 * half, kvh, it * K_ROWS + r, b);
                hw::tma_load_4d(&sm.v[st][half][r * 64], &tv, &sm.full[st], 64 * half, kvh, it * K_ROWS + r, b);
            }
    };
    if (threadIdx.x == 0) {  // barriers, then Q and dO and the first K/V tiles
        hw::mbar_init(&sm.q_full, 1);
        for (int st = 0; st < STAGES; ++st) {
            hw::mbar_init(&sm.full[st], 1);
            sm.done[st] = 0;
        }
        hw::fence_barrier_init();
        hw::mbar_expect_tx(&sm.q_full, 4 * DQ_HALF_BYTES);
        for (int half = 0; half < 2; ++half)
            for (int r = 0; r < DQ_ROWS; r += BOX) {
                hw::tma_load_4d(&sm.q[half][r * 64], &tq, &sm.q_full, 64 * half, h, q0 + r, b);
                hw::tma_load_4d(&sm.dout[half][r * 64], &tdo, &sm.q_full, 64 * half, h, q0 + r, b);
            }
        for (int it = 0; it < min(STAGES, n_tiles); ++it) load_kv(it, it);
    }
    __syncthreads();

    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int r0 = q0 + cw * 64;  // this warpgroup's 64 queries
    const int row_lo = r0 + warp * 16 + g;
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
    const uint32_t q_base = ssi::smem_addr(sm.q[0]) + cw * 64 * 128;  // the warpgroup's 64 queries of half 0
    const uint32_t do_base = ssi::smem_addr(sm.dout[0]) + cw * 64 * 128;

    float dq_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

    hw::mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const int k0 = it * K_ROWS;
        hw::mbar_wait(&sm.full[st], (it / STAGES) & 1);
        // queries all past S, or all before the tile's keys: nothing to add
        if (r0 < S && !(causal && k0 > r0 + 63)) {
            const uint32_t k_addr = hw::opaque(ssi::smem_addr(sm.k[st][0]));
            const uint32_t v_addr = hw::opaque(ssi::smem_addr(sm.v[st][0]));
            const uint32_t q_addr = hw::opaque(q_base);
            const uint32_t do_addr = hw::opaque(do_base);
            float s[K_ROWS / 2], dp[K_ROWS / 2];  // S, dP [64 queries x K_ROWS keys]
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * DQ_HALF_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * K_HALF_BYTES + (kk % 4) * 32;
                hw::wgmma_ss_n128(s, hw::desc_sw128(q_addr + a_off, 16, 1024), hw::desc_sw128(k_addr + b_off, 16, 1024),
                                 kk > 0);
            }
            hw::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * DQ_HALF_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * K_HALF_BYTES + (kk % 4) * 32;
                hw::wgmma_ss_n128(dp, hw::desc_sw128(do_addr + a_off, 16, 1024),
                                 hw::desc_sw128(v_addr + b_off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<1>();  // S has landed; dP may still run
            hw::fence_regs(s);

            // P = exp(scale S - lse) (0 where masked), under the dP product
            const bool need_mask = segb != nullptr || k0 + K_ROWS > kv_end || (causal && k0 + K_ROWS - 1 > r0);
#pragma unroll
            for (int j = 0; j < K_ROWS / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float pr = hw::exp2_ftz(fmaf(s[4 * j + e], scale2, -(e < 2 ? lse_lo : lse_hi)));
                    if (need_mask) {
                        const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
                        const int qp = e < 2 ? row_lo : row_hi;
                        bool keep = kp < kv_end && (!causal || kp <= qp);
                        if (segb != nullptr) keep = keep && segb[kp] == (e < 2 ? qseg_lo : qseg_hi);
                        pr = keep ? pr : 0.f;
                    }
                    s[4 * j + e] = pr;
                }
            }
            hw::wgmma_wait<0>();
            hw::fence_regs(dp);
            // dS = P (dP - delta)
#pragma unroll
            for (int i = 0; i < K_ROWS / 2; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? delta_hi : delta_lo));
            uint32_t da[K_ROWS / 4];
            hw::pack_a<K_ROWS / 2>(da, dp);
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < K_ROWS / 16; ++kk)  // dQ += dS . K
                hw::wgmma_rs_n128_mn(dq_acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                                     hw::desc_sw128(k_addr + kk * 16 * 128, K_HALF_BYTES, 1024),
                                     1);
            hw::wgmma_commit();
            hw::fence_regs(da);
            hw::wgmma_wait<0>();
            hw::fence_regs(dq_acc);
            hw::fence_regs(da);
        }
        // the second warpgroup done with this stage refills it with key tile it + STAGES
        if (t == 0 && hw::release_last(&sm.done[st]) && it + STAGES < n_tiles) load_kv(it + STAGES, st);
    }

    // dQ into this warpgroup's own Q rows (free since its last products), then out by TMA
    hw::store_tile(dq_acc, scale, scale, reinterpret_cast<unsigned char*>(sm.q[0]) + cw * 64 * 128, DQ_HALF_BYTES,
                   &tdq, h, r0, b, 1 + cw);
}

}  // namespace

cudaError_t ssi::flash_bwd_hd128_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const float* lse, float* delta, const int* seg, void* dq, void* dk, void* dv,
                                      int B, int S, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
    if (B > 65535) return cudaErrorInvalidValue;
    const long long rows = (long long)B * S * Hq;
    delta_hd128_kernel<<<(unsigned)((rows * 16 + DELTA_THREADS - 1) / DELTA_THREADS), DELTA_THREADS, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, S, Hq, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long q_ss = (long long)Hq * HD;  // contiguous [B, S, H, 128]
    const long long kv_ss = (long long)Hkv * HD;
    CUtensorMap tq, tk, tv, tdo;
    err = hw::map_bshd(&tq, q, B, S, Hq, HD, S * q_ss, q_ss, HD, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdo, dout, B, S, Hq, HD, S * q_ss, q_ss, HD, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tk, k, B, S, Hkv, HD, S * kv_ss, kv_ss, HD, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tv, v, B, S, Hkv, HD, S * kv_ss, kv_ss, HD, BOX);
    CUtensorMap tdq, tdk, tdv;  // the gradients, stored 64 rows (a warpgroup's) at a time
    if (err == cudaSuccess) err = hw::map_bshd(&tdq, dq, B, S, Hq, HD, S * q_ss, q_ss, HD, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdk, dk, B, S, Hkv, HD, S * kv_ss, kv_ss, HD, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdv, dv, B, S, Hkv, HD, S * kv_ss, kv_ss, HD, BOX);
    if (err != cudaSuccess) return err;
    static int allowed_dkdv = 0, allowed_dq = 0;
    err = ssi::allow_dynamic_smem(dkdv_hd128_kernel, DKDV_SMEM, allowed_dkdv);
    if (err != cudaSuccess) return err;
    err = ssi::allow_dynamic_smem(dq_hd128_kernel, DQ_SMEM, allowed_dq);
    if (err != cudaSuccess) return err;
    dkdv_hd128_kernel<<<dim3(Hkv, B, (S + KV_ROWS - 1) / KV_ROWS), THREADS, DKDV_SMEM, stream>>>(
        tq, tk, tv, tdo, tdk, tdv, lse, delta, seg, S, Hq, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_hd128_kernel<<<dim3(Hq, B, (S + DQ_ROWS - 1) / DQ_ROWS), THREADS, DQ_SMEM, stream>>>(
        tq, tk, tv, tdo, tdq, lse, delta, seg, S, Hq, Hkv, causal, scale);
    return cudaGetLastError();
}
