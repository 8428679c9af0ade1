// Flash-attention backward, bf16, head_dim 64 (Llama 3.2 100m and 1B), 128
// (Llama 3.2 3B, Llama 3.1 8B) and 256 (Gemma's heads): dq, dk, dv for causal
// or full GQA with optional packed segment ids, designed for Hopper. The
// kernels and their launcher; flash_hopper_bwd.cu instantiates them at head_dim
// 64 and 128, flash_hopper_bwd_hd256.cu at 256 (a translation unit of its
// own: its instances compile beside the others, and in one unit nvcc gave the
// hd-128 dK/dV kernel 238 registers where it has 240 alone).
//
// Replaces, in bf16, the TPU kernels ssi_tpu/ops/flash_attention.py
// `_bwd_kernel` and `_bwd_kernel_grouped`; flash_attention_bwd.cu keeps the
// f32 parity kernels and dispatches bf16 here. Semantics are that file's: S =
// scale * q.k recomputed, P = exp(S - lse) with masked entries set to 0
// explicitly (a fully masked row gives zero gradients), delta = rowsum(o * do)
// in f32, dS = P (dP - delta), P and dS cast to bf16 before the dV, dK and dQ
// products, scale multiplied into dq and dk.
//
// One template serves the head dims 64 and 128 (Config below), as
// flash_hopper_fwd.cu does for the forward: the schedule, the rings, the
// masks and the epilogues are the same at 64 and 128; the count of 64-column
// blocks a tile row spans, the products' widths and the tile rows differ.
// Head_dim 256 takes the dQ template and a dK/dV kernel of its own (below).
//
// What bounds it: the five S^2 * hd products (S, dP, dV, dK, dQ) at the
// training shapes (1B: B2 S2048, 32 q / 8 kv heads, hd 64; 3B: 24 / 8, hd
// 128): operations. The layout is the deterministic two-kernel one (no
// atomics, so the gradients are bitwise equal run to run), which issues 7
// products where 5 are counted (S and dP are formed in both kernels):
// - delta: a warp per 32 / (hd / 8) rows, hd / 8 lanes a row (coalesced
//   16-byte reads);
// - dK/dV: a block per (kv head, batch, 128-key tile), looping over the
//   Q_ROWS-query tiles from the causal diagonal on and, inside each, over the
//   n_rep q heads of its kv head, in a fixed order;
// - dQ: a block per (q head, batch, 128-query tile), looping over K_ROWS-key
//   tiles up to the diagonal.
// Both take the forward's shape (flash_hopper_fwd.cu): 2 warpgroups of 64 rows
// each, no producer warpgroup (ptxas would hold every thread of a 384-thread
// block to 168 registers; dK/dV needs about 240 at hd 128), thread 0 issuing
// the first TMA loads and the warpgroup that releases a stage second
// refilling it; tiles in shared memory as 64-column blocks with the 128-byte
// swizzle (hopper.cuh); the results leave through each warpgroup's own freed
// tile rows by TMA store, which skips rows past S.
// - dK/dV: K and V (this block's 128 keys) load once; the Q and dO tiles of
//   each (q tile, q head) pair ride a 2-stage ring by TMA, with that pair's
//   lse and delta, which the refilling warp's lanes copy by cp.async (rows
//   of [B, Hq, S] f32 do not start 16-byte aligned for an odd S, as a TMA box
//   would need) and which arrive on the stage's barrier when they land.
//   Each warpgroup forms S^T = K.Q^T and dP^T = V.dO^T for its 64 keys
//   (wgmma m64nQ_ROWSk16, both operands K-major in shared memory; P^T's
//   exponentials, one ex2.approx with LOG2E folded in, run under the dP^T
//   product), then dS^T in the accumulators, and adds dV += P^T.dO and
//   dK += dS^T.Q with P^T and dS^T from registers (the RS form) and dO and Q
//   through MN-major descriptors (m64nHDk16). dK and dV (64 x hd f32 each)
//   stay in registers and are written once.
// - dQ: Q and dO (128 rows) load once; K_ROWS-key K and V tiles ride a
//   2-stage ring. S = Q.K^T and dP = dO.V^T (m64nK_ROWSk16, K-major), P and
//   dS in the accumulators (P's exponentials under the dP product), dQ +=
//   dS.K with dS from registers and K MN-major (m64nHDk16). lse and delta of
//   the thread's two rows are read once.
// - causal: dK/dV blocks start at the diagonal q tile and dQ blocks stop at
//   it; a warpgroup skips the products of a tile its rows cannot see (keys
//   all after its queries) and masks only the tiles that cross the diagonal
//   or the ragged end (or every tile, with segment ids). The heaviest blocks
//   launch first (low key tiles for dK/dV, high q tiles for dQ). TMA
//   zero-fills rows past S.
// Any other head_dim d <= 256 (a multiple of 8; the wrapper pads others)
// runs the instance of the next of 64, 128 and 256 on tensor maps whose
// innermost extent is d (columns past d load as zeros; the stores clip at d),
// with the delta pass bounded at d and the scale 1/sqrt(d).
// Head_dim 256 (129-256): a warpgroup's dK and dV over 64 keys would be 256
// f32 accumulators a thread, more than a thread has. So a dK/dV block takes
// 64 keys and its two warpgroups split each (q tile, q head) pair's work:
// warpgroup 0 forms S^T = K.Q^T and P^T and adds dV += P^T.dO, warpgroup 1
// forms dP^T = V.dO^T, takes P^T (f32) from shared memory, forms dS^T and
// adds dK += dS^T.Q. Each holds one 64 x 256 sum (128 registers) and issues
// the same products (one m64n64 product over K = 256, one m64n256 over K =
// 64), and no product is issued twice (a grid axis over halves of the
// columns would recompute S^T and dP^T in both). P^T passes through a 16 KB
// buffer between named barriers (ready, then free for the next pair). K and
// V are 32 KB each, the 2-stage ring of 64-query Q and dO stages 128 KB: 210
// KB with P^T. dQ takes the template with 32-key K/V stages: Q and dO are 64
// KB each at 128 rows, so two 32-key stages (16 KB each of K and V) fit
// beside them (192 KB); dQ is 128 registers, S and dP 16 each.
// Head_dim 128: 64-query dK/dV stages and 128-key dQ tiles, one block an SM
// for each kernel (dK/dV 130 KB of shared memory, 240 registers; dQ 193 KB,
// 226). Head_dim 64 halves the accumulators of dK, dV and dQ, not those of S
// and dP; its configuration (Hd64 below) was chosen by timing two on the card
// (NVIDIA H100 80GB HBM3, 700 W, causal, B2 S2048, 32 q / 8 kv heads; how:
// PERF.md section 6): dK/dV with 128-query stages (99 KB, 253 registers, no
// spill) read 0.182 ms against 0.220-0.222 with 64-query stages (176
// registers): a stage's waits, lse/delta copies and ring refill are spread
// over twice the products; dQ with 64-key tiles at two blocks an SM (65 KB,
// 126 registers, no spill) read 0.131 ms against 0.133 with 128-key tiles at
// one block an SM (194 registers).
// Its times on the card beside its bound and SDPA's: PERF.md section 6.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hopper.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ssi::hopper;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // two warpgroups
constexpr int STAGES = 2;
constexpr int BOX = 64;       // rows of every TMA box
constexpr int KV_ROWS = 128;  // keys a dK/dV block
constexpr int DQ_ROWS = 128;  // queries a dQ block
constexpr float LOG2E = 1.4426950408889634f;

// HD: head_dim; Q_ROWS: queries a Q/dO stage of dK/dV; K_ROWS: keys a K/V
// stage of dQ; DQ_BLOCKS: dQ blocks an SM the registers are budgeted for
template <int HD_, int Q_ROWS_, int K_ROWS_, int DQ_BLOCKS_>
struct Config {
    static constexpr int HD = HD_;
    static constexpr int Q_ROWS = Q_ROWS_;
    static constexpr int K_ROWS = K_ROWS_;
    static constexpr int DQ_BLOCKS = DQ_BLOCKS_;
    static constexpr int BLOCKS = HD_ / 64;  // 64-column blocks of a tile row
};

// head_dim 64: the configuration that measured fastest on the card (see the
// top of the file); head_dim 128: the tiles of its first design; head_dim
// 256: 32-key dQ stages (its dK/dV kernel is dkdv_split_kernel, 64 x 64 tiles)
using Hd64 = Config<64, 128, 64, 2>;
using Hd128 = Config<128, 64, 128, 1>;
using Hd256 = Config<256, 64, 32, 1>;

// one k16 step of a product with both operands K-major in shared memory, by
// the accumulator's size (m64n32, m64n64 or m64n128)
__device__ __forceinline__ void ss_step(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void ss_step(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void ss_step(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_n128(d, a, b, acc);
}
// one k16 step with A from registers and B MN-major, by the accumulator's size
__device__ __forceinline__ void rs_step(float (&d)[32], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n64_mn(d, a[0], a[1], a[2], a[3], b, 1);
}
__device__ __forceinline__ void rs_step(float (&d)[64], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n128_mn(d, a[0], a[1], a[2], a[3], b, 1);
}
__device__ __forceinline__ void rs_step(float (&d)[128], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n256_mn(d, a[0], a[1], a[2], a[3], b, 1);
}

// the [ELEMS / 64 rows x HD] tile at (h, s0, b) of `map` into `dst` (BLOCKS
// column blocks of ELEMS / 64 rows x 64, a TMA box per ROWS rows: the map's
// box), completing on bar
template <int BLOCKS, int ELEMS, int ROWS = BOX>
__device__ __forceinline__ void load_rows(bf16 (&dst)[BLOCKS][ELEMS], const CUtensorMap* map, uint64_t* bar, int h,
                                          int s0, int b) {
#pragma unroll
    for (int blk = 0; blk < BLOCKS; ++blk)
#pragma unroll
        for (int r = 0; r < ELEMS / 64; r += ROWS) hw::tma_load_4d(&dst[blk][r * 64], map, bar, 64 * blk, h, s0 + r, b);
}

// ---- delta = rowsum(o * do) ---------------------------------------------------------

constexpr int DELTA_THREADS = 256;

// HD / 8 lanes a (b, s, q head) row of hd columns (hd <= HD, a multiple of
// 8), each lane 8 columns read as 16 bytes (lanes past hd add 0): a warp
// reads up to 512 contiguous bytes of o and of do; the lanes' f32 sums meet
// in a fixed shuffle tree
template <int HD>
__global__ void __launch_bounds__(DELTA_THREADS) delta_hopper_kernel(const bf16* __restrict__ o,
                                                                     const bf16* __restrict__ dout,
                                                                     float* __restrict__ delta, int S, int Hq, int hd,
                                                                     long long rows) {
    constexpr int LANES = HD / 8;
    const long long r = (blockIdx.x * (long long)DELTA_THREADS + threadIdx.x) / LANES;  // row (b * S + s) * Hq + h
    const int c = (threadIdx.x % LANES) * 8;
    float acc = 0.f;
    if (r < rows && c < hd) {
        float a[8], d[8];
        ssi::load8(o + r * hd + c, a);
        ssi::load8(dout + r * hd + c, d);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], d[i], acc);
    }
#pragma unroll
    for (int w = LANES / 2; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (r < rows && threadIdx.x % LANES == 0) {
        const long long h = r % Hq;
        const long long bs = r / Hq;
        delta[(bs / S * Hq + h) * S + bs % S] = acc;
    }
}

// ---- dK / dV ----------------------------------------------------------------------

template <class C>
struct DkdvSmem {
    bf16 k[C::BLOCKS][KV_ROWS * 64];
    bf16 v[C::BLOCKS][KV_ROWS * 64];
    bf16 q[STAGES][C::BLOCKS][C::Q_ROWS * 64];
    bf16 dout[STAGES][C::BLOCKS][C::Q_ROWS * 64];
    float lse[STAGES][C::Q_ROWS];
    float delta[STAGES][C::Q_ROWS];
    uint64_t kv_full, full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
template <class C>
constexpr int dkdv_smem() {
    return sizeof(DkdvSmem<C>) + 1024;  // + slack to align the tiles to 1024 bytes
}

template <class C>
__global__ void __launch_bounds__(THREADS, 1) dkdv_hopper_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg, int S, int Hq, int Hkv, int causal, float scale) {
    constexpr int HD = C::HD, Q_ROWS = C::Q_ROWS, BLOCKS = C::BLOCKS;
    constexpr uint32_t KV_BLOCK_BYTES = KV_ROWS * 128;  // one 64-column block of K or V
    constexpr uint32_t Q_BLOCK_BYTES = Q_ROWS * 128;    // ... of a Q or dO stage
    extern __shared__ unsigned char smem_raw[];
    DkdvSmem<C>& sm = *reinterpret_cast<DkdvSmem<C>*>(hw::align1024(smem_raw));

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.z * KV_ROWS;  // low key tiles (the most q tiles under causal) launch first
    const int n_rep = Hq / Hkv;
    const int n_q = (S + Q_ROWS - 1) / Q_ROWS;
    const int qi0 = causal ? k0 / Q_ROWS : 0;  // causal: q tiles before the diagonal see no key here
    const int n_pairs = (n_q - qi0) * n_rep;

    // stage pair p (q tile qi0 + p / n_rep, q head kvh * n_rep + p % n_rep), by the 32
    // lanes of one warp: lane 0 its Q and dO rows by TMA (zero past S), every
    // lane Q_ROWS / 32 of its queries' lse and delta by cp.async (lse and delta rows
    // of an odd S do not start 16-byte aligned, as TMA wants; 0 past S)
    auto load_pair = [&](int p, int st, int lane) {
        const int q0 = (qi0 + p / n_rep) * Q_ROWS;
        const int h = kvh * n_rep + p % n_rep;
        if (lane == 0) {
            hw::mbar_expect_tx(&sm.full[st], 2 * BLOCKS * Q_BLOCK_BYTES);
            load_rows(sm.q[st], &tq, &sm.full[st], h, q0, b);
            load_rows(sm.dout[st], &tdo, &sm.full[st], h, q0, b);
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
            hw::mbar_expect_tx(&sm.kv_full, 2 * BLOCKS * KV_BLOCK_BYTES);
            load_rows(sm.k, &tk, &sm.kv_full, kvh, k0, b);
            load_rows(sm.v, &tv, &sm.kv_full, kvh, k0, b);
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
    const uint32_t k_base = ssi::smem_addr(sm.k[0]) + cw * 64 * 128;  // the warpgroup's 64 keys of block 0
    const uint32_t v_base = ssi::smem_addr(sm.v[0]) + cw * 64 * 128;

    float dk_acc[HD / 2], dv_acc[HD / 2];  // [64 keys x HD]: n8 block j of the columns at [4j ..]
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
            float s[Q_ROWS / 2], dp[Q_ROWS / 2];  // S^T, dP^T [64 keys x Q_ROWS queries]
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * KV_BLOCK_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * Q_BLOCK_BYTES + (kk % 4) * 32;
                ss_step(s, hw::desc_sw128(k_addr + a_off, 16, 1024), hw::desc_sw128(q_addr + b_off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * KV_BLOCK_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * Q_BLOCK_BYTES + (kk % 4) * 32;
                ss_step(dp, hw::desc_sw128(v_addr + a_off, 16, 1024), hw::desc_sw128(do_addr + b_off, 16, 1024),
                        kk > 0);
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
            uint32_t pa[Q_ROWS / 4], da[Q_ROWS / 4];
            hw::pack_a<Q_ROWS / 2>(pa, s);
            hw::pack_a<Q_ROWS / 2>(da, dp);
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < Q_ROWS / 16; ++kk)  // dV += P^T . dO
                rs_step(dv_acc, &pa[4 * kk], hw::desc_sw128(do_addr + kk * 16 * 128, Q_BLOCK_BYTES, 1024));
#pragma unroll
            for (int kk = 0; kk < Q_ROWS / 16; ++kk)  // dK += dS^T . Q
                rs_step(dk_acc, &da[4 * kk], hw::desc_sw128(q_addr + kk * 16 * 128, Q_BLOCK_BYTES, 1024));
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
    hw::store_tile(dk_acc, scale, scale, reinterpret_cast<unsigned char*>(sm.k[0]) + cw * 64 * 128, KV_BLOCK_BYTES,
                   &tdk, kvh, kr0, b, 1 + cw);
    hw::store_tile(dv_acc, 1.f, 1.f, reinterpret_cast<unsigned char*>(sm.v[0]) + cw * 64 * 128, KV_BLOCK_BYTES, &tdv,
                   kvh, kr0, b, 1 + cw);
}

// ---- dK / dV at head_dim 256: the two warpgroups split each pair's work -----------

constexpr int SPLIT_ROWS = 64;  // keys a block, queries a Q/dO stage
constexpr int SPLIT_BLOCKS = 4;  // 64-column blocks of a 256-column row
constexpr int P_READY = 3, P_FREE = 4;  // named barriers of the P^T hand-over (1, 2: store_tile's)

struct SplitSmem {
    bf16 k[SPLIT_BLOCKS][SPLIT_ROWS * 64];
    bf16 v[SPLIT_BLOCKS][SPLIT_ROWS * 64];
    bf16 q[STAGES][SPLIT_BLOCKS][SPLIT_ROWS * 64];
    bf16 dout[STAGES][SPLIT_BLOCKS][SPLIT_ROWS * 64];
    float p[SPLIT_ROWS / 2][128];  // P^T of the current pair: element i of thread t at [i][t]
    float lse[STAGES][SPLIT_ROWS];
    float delta[STAGES][SPLIT_ROWS];
    uint64_t kv_full, full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
constexpr int split_smem() { return sizeof(SplitSmem) + 1024; }

// A block per (kv head, batch, 64-key tile), looping over the 64-query tiles
// from the causal diagonal on and, inside each, over the n_rep q heads, as
// dkdv_hopper_kernel; every such pair holds keys the queries see (the first
// q tile of a block starts at its keys). Warpgroup 0 forms P^T and dV,
// warpgroup 1 dP^T, dS^T and dK (see the top of the file). hd <= HD (256; a
// template, so that only the translation unit that launches it compiles it).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1) dkdv_split_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg, int S, int Hq, int Hkv, int causal, float scale) {
    static_assert(HD == 64 * SPLIT_BLOCKS, "a 256-column row");
    constexpr int ROWS = SPLIT_ROWS, BLOCKS = SPLIT_BLOCKS;
    constexpr uint32_t BLOCK_BYTES = ROWS * 128;  // one 64-column block of a K, V, Q or dO tile
    extern __shared__ unsigned char smem_raw[];
    SplitSmem& sm = *reinterpret_cast<SplitSmem*>(hw::align1024(smem_raw));

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.z * ROWS;  // low key tiles (the most q tiles under causal) launch first
    const int n_rep = Hq / Hkv;
    const int n_q = (S + ROWS - 1) / ROWS;
    const int qi0 = causal ? blockIdx.z : 0;  // causal: q tiles before the diagonal see no key here
    const int n_pairs = (n_q - qi0) * n_rep;

    // stage pair p (q tile qi0 + p / n_rep, q head kvh * n_rep + p % n_rep) by
    // one warp, as dkdv_hopper_kernel's load_pair
    auto load_pair = [&](int p, int st, int lane) {
        const int q0 = (qi0 + p / n_rep) * ROWS;
        const int h = kvh * n_rep + p % n_rep;
        if (lane == 0) {
            hw::mbar_expect_tx(&sm.full[st], 2 * BLOCKS * BLOCK_BYTES);
            load_rows(sm.q[st], &tq, &sm.full[st], h, q0, b);
            load_rows(sm.dout[st], &tdo, &sm.full[st], h, q0, b);
        }
        const long long row = ((long long)b * Hq + h) * S;
        for (int i = lane; i < ROWS; i += 32) {
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
            hw::mbar_expect_tx(&sm.kv_full, 2 * BLOCKS * BLOCK_BYTES);
            load_rows(sm.k, &tk, &sm.kv_full, kvh, k0, b);
            load_rows(sm.v, &tv, &sm.kv_full, kvh, k0, b);
        }
        __syncwarp();
        for (int p = 0; p < min(STAGES, n_pairs); ++p) load_pair(p, p, threadIdx.x);
    }
    __syncthreads();

    const int cw = threadIdx.x / 128;  // 0: P^T and dV; 1: dP^T, dS^T and dK
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    // this thread's two key rows: lo (g) and hi (g + 8) of its warp's 16
    const int kp_lo = k0 + warp * 16 + g;
    const int kp_hi = kp_lo + 8;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;
    const int kseg_lo = (segb != nullptr && kp_lo < S) ? segb[kp_lo] : 0;
    const int kseg_hi = (segb != nullptr && kp_hi < S) ? segb[kp_hi] : 0;
    const float scale2 = scale * LOG2E;

    float acc[HD / 2];  // dV (warpgroup 0) or dK (1): [64 keys x 256], n8 block j of the columns at [4j ..]
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    hw::mbar_wait(&sm.kv_full, 0);
    for (int p = 0; p < n_pairs; ++p) {
        const int st = p % STAGES;
        const int q0 = (qi0 + p / n_rep) * ROWS;
        hw::mbar_wait(&sm.full[st], (p / STAGES) & 1);
        const uint32_t q_addr = hw::opaque(ssi::smem_addr(sm.q[st][0]));
        const uint32_t do_addr = hw::opaque(ssi::smem_addr(sm.dout[st][0]));
        float x[ROWS / 2];  // warpgroup 0: S^T, then P^T; 1: dP^T, then dS^T [64 keys x 64 queries]
        uint32_t xa[ROWS / 4];
        if (cw == 0) {
            const uint32_t k_addr = hw::opaque(ssi::smem_addr(sm.k[0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk / 4) * BLOCK_BYTES + (kk % 4) * 32;
                ss_step(x, hw::desc_sw128(k_addr + off, 16, 1024), hw::desc_sw128(q_addr + off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
            hw::fence_regs(x);
            // P^T = exp(scale S^T - lse[q]) (0 where masked)
            const bool need_mask = segb != nullptr || q0 + ROWS > S || (causal && q0 < k0 + ROWS);
#pragma unroll
            for (int j = 0; j < ROWS / 8; ++j) {
                const int c = j * 8 + 2 * t4;  // this thread's two query columns: c, c + 1
                const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[st][c]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float pr = hw::exp2_ftz(fmaf(x[4 * j + e], scale2, -((e & 1) ? ls.y : ls.x) * LOG2E));
                    if (need_mask) {
                        const int qp = q0 + c + (e & 1);
                        const int kp = e < 2 ? kp_lo : kp_hi;
                        bool keep = qp < S && (!causal || kp <= qp);
                        if (segb != nullptr) keep = keep && segb[qp] == (e < 2 ? kseg_lo : kseg_hi);
                        pr = keep ? pr : 0.f;
                    }
                    x[4 * j + e] = pr;
                }
            }
            if (p > 0) hw::named_sync(P_FREE, THREADS);  // warpgroup 1 has read the last pair's P^T
#pragma unroll
            for (int i = 0; i < ROWS / 2; ++i) sm.p[i][t] = x[i];
            hw::named_arrive(P_READY, THREADS);
            hw::pack_a<ROWS / 2>(xa, x);
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < ROWS / 16; ++kk)  // dV += P^T . dO
                rs_step(acc, &xa[4 * kk], hw::desc_sw128(do_addr + kk * 16 * 128, BLOCK_BYTES, 1024));
            hw::wgmma_commit();
        } else {
            const uint32_t v_addr = hw::opaque(ssi::smem_addr(sm.v[0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk / 4) * BLOCK_BYTES + (kk % 4) * 32;
                ss_step(x, hw::desc_sw128(v_addr + off, 16, 1024), hw::desc_sw128(do_addr + off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
            hw::fence_regs(x);
            hw::named_sync(P_READY, THREADS);  // warpgroup 0's P^T of this pair
            // dS^T = P^T (dP^T - delta[q])
#pragma unroll
            for (int j = 0; j < ROWS / 8; ++j) {
                const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[st][j * 8 + 2 * t4]);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    x[4 * j + e] = sm.p[4 * j + e][t] * (x[4 * j + e] - ((e & 1) ? dl.y : dl.x));
            }
            if (p + 1 < n_pairs) hw::named_arrive(P_FREE, THREADS);
            hw::pack_a<ROWS / 2>(xa, x);
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < ROWS / 16; ++kk)  // dK += dS^T . Q
                rs_step(acc, &xa[4 * kk], hw::desc_sw128(q_addr + kk * 16 * 128, BLOCK_BYTES, 1024));
            hw::wgmma_commit();
        }
        hw::fence_regs(xa);
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::fence_regs(xa);
        if (warp == 0) {  // the second warpgroup done with this stage refills it with pair p + STAGES
            const bool last = __shfl_sync(0xffffffffu, lane == 0 && hw::release_last(&sm.done[st]), 0);
            if (last && p + STAGES < n_pairs) load_pair(p + STAGES, st, lane);
        }
    }

    // every product is done with K and V: dV into V's rows, dK into K's, then out by TMA
    __syncthreads();
    if (cw == 0)
        hw::store_tile(acc, 1.f, 1.f, reinterpret_cast<unsigned char*>(sm.v[0]), BLOCK_BYTES, &tdv, kvh, k0, b, 1);
    else
        hw::store_tile(acc, scale, scale, reinterpret_cast<unsigned char*>(sm.k[0]), BLOCK_BYTES, &tdk, kvh, k0, b, 2);
}

// ---- dQ ---------------------------------------------------------------------------

template <class C>
struct DqSmem {
    bf16 q[C::BLOCKS][DQ_ROWS * 64];
    bf16 dout[C::BLOCKS][DQ_ROWS * 64];
    bf16 k[STAGES][C::BLOCKS][C::K_ROWS * 64];
    bf16 v[STAGES][C::BLOCKS][C::K_ROWS * 64];
    uint64_t q_full, full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
template <class C>
constexpr int dq_smem() {
    return sizeof(DqSmem<C>) + 1024;
}
// rows of a K or V box of dQ (its maps' box): a stage's keys, at most BOX
template <class C>
constexpr int DQ_BOX = C::K_ROWS < BOX ? C::K_ROWS : BOX;

template <class C>
__global__ void __launch_bounds__(THREADS, C::DQ_BLOCKS) dq_hopper_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, int S, int Hq, int Hkv, int causal, float scale) {
    constexpr int HD = C::HD, K_ROWS = C::K_ROWS, BLOCKS = C::BLOCKS;
    constexpr uint32_t DQ_BLOCK_BYTES = DQ_ROWS * 128;  // one 64-column block of Q or dO
    constexpr uint32_t K_BLOCK_BYTES = K_ROWS * 128;    // ... of a K or V stage
    extern __shared__ unsigned char smem_raw[];
    DqSmem<C>& sm = *reinterpret_cast<DqSmem<C>*>(hw::align1024(smem_raw));

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;  // last q tiles (most keys) first
    const int kvh = h / (Hq / Hkv);
    const int kv_end = causal ? min(S, q0 + DQ_ROWS) : S;  // causal: keys past the q tile are masked
    const int n_tiles = (kv_end + K_ROWS - 1) / K_ROWS;

    auto load_kv = [&](int it, int st) {  // key tile it's K and V into stage st
        hw::mbar_expect_tx(&sm.full[st], 2 * BLOCKS * K_BLOCK_BYTES);
        load_rows<BLOCKS, K_ROWS * 64, DQ_BOX<C>>(sm.k[st], &tk, &sm.full[st], kvh, it * K_ROWS, b);
        load_rows<BLOCKS, K_ROWS * 64, DQ_BOX<C>>(sm.v[st], &tv, &sm.full[st], kvh, it * K_ROWS, b);
    };
    if (threadIdx.x == 0) {  // barriers, then Q and dO and the first K/V tiles
        hw::mbar_init(&sm.q_full, 1);
        for (int st = 0; st < STAGES; ++st) {
            hw::mbar_init(&sm.full[st], 1);
            sm.done[st] = 0;
        }
        hw::fence_barrier_init();
        hw::mbar_expect_tx(&sm.q_full, 2 * BLOCKS * DQ_BLOCK_BYTES);
        load_rows(sm.q, &tq, &sm.q_full, h, q0, b);
        load_rows(sm.dout, &tdo, &sm.q_full, h, q0, b);
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
    const uint32_t q_base = ssi::smem_addr(sm.q[0]) + cw * 64 * 128;  // the warpgroup's 64 queries of block 0
    const uint32_t do_base = ssi::smem_addr(sm.dout[0]) + cw * 64 * 128;

    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;

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
                const uint32_t a_off = (kk / 4) * DQ_BLOCK_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * K_BLOCK_BYTES + (kk % 4) * 32;
                ss_step(s, hw::desc_sw128(q_addr + a_off, 16, 1024), hw::desc_sw128(k_addr + b_off, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t a_off = (kk / 4) * DQ_BLOCK_BYTES + (kk % 4) * 32;
                const uint32_t b_off = (kk / 4) * K_BLOCK_BYTES + (kk % 4) * 32;
                ss_step(dp, hw::desc_sw128(do_addr + a_off, 16, 1024), hw::desc_sw128(v_addr + b_off, 16, 1024),
                        kk > 0);
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
                rs_step(dq_acc, &da[4 * kk], hw::desc_sw128(k_addr + kk * 16 * 128, K_BLOCK_BYTES, 1024));
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
    hw::store_tile(dq_acc, scale, scale, reinterpret_cast<unsigned char*>(sm.q[0]) + cw * 64 * 128, DQ_BLOCK_BYTES,
                   &tdq, h, r0, b, 1 + cw);
}

// hd: the operands' head_dim, at most C::HD. The tensor maps' innermost
// extent is hd: a tile's columns past hd load as zeros (they add nothing to S
// or dP, and the gradients' columns past hd are zeros that the stores,
// clipped at hd, never write).
template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                   float* delta, const int* seg, void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv, int hd,
                   int causal, float scale, cudaStream_t stream) {
    constexpr int HD = C::HD;
    const long long rows = (long long)B * S * Hq;
    delta_hopper_kernel<HD><<<(unsigned)((rows * (HD / 8) + DELTA_THREADS - 1) / DELTA_THREADS), DELTA_THREADS, 0,
                              stream>>>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, S, Hq,
                                        hd, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long q_ss = (long long)Hq * hd;  // contiguous [B, S, H, hd]
    const long long kv_ss = (long long)Hkv * hd;
    CUtensorMap tq, tk, tv, tdo;
    err = hw::map_bshd(&tq, q, B, S, Hq, hd, S * q_ss, q_ss, hd, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdo, dout, B, S, Hq, hd, S * q_ss, q_ss, hd, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tk, k, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tv, v, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, BOX);
    CUtensorMap tdq, tdk, tdv;  // the gradients, stored 64 rows (a warpgroup's) at a time
    if (err == cudaSuccess) err = hw::map_bshd(&tdq, dq, B, S, Hq, hd, S * q_ss, q_ss, hd, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdk, dk, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, BOX);
    if (err == cudaSuccess) err = hw::map_bshd(&tdv, dv, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, BOX);
    CUtensorMap tk_dq = tk, tv_dq = tv;  // dQ's K/V maps: boxes of a stage's keys where a stage is under BOX
    if (DQ_BOX<C> != BOX) {
        if (err == cudaSuccess) err = hw::map_bshd(&tk_dq, k, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, DQ_BOX<C>);
        if (err == cudaSuccess) err = hw::map_bshd(&tv_dq, v, B, S, Hkv, hd, S * kv_ss, kv_ss, hd, DQ_BOX<C>);
    }
    if (err != cudaSuccess) return err;
    static int allowed_dkdv = 0, allowed_dq = 0;
    if constexpr (HD == 256) {  // the dK/dV kernel whose warpgroups split each pair's work
        err = ssi::allow_dynamic_smem(dkdv_split_kernel<HD>, split_smem(), allowed_dkdv);
        if (err != cudaSuccess) return err;
        dkdv_split_kernel<HD><<<dim3(Hkv, B, (S + SPLIT_ROWS - 1) / SPLIT_ROWS), THREADS, split_smem(), stream>>>(
            tq, tk, tv, tdo, tdk, tdv, lse, delta, seg, S, Hq, Hkv, causal, scale);
    } else {
        err = ssi::allow_dynamic_smem(dkdv_hopper_kernel<C>, dkdv_smem<C>(), allowed_dkdv);
        if (err != cudaSuccess) return err;
        dkdv_hopper_kernel<C><<<dim3(Hkv, B, (S + KV_ROWS - 1) / KV_ROWS), THREADS, dkdv_smem<C>(), stream>>>(
            tq, tk, tv, tdo, tdk, tdv, lse, delta, seg, S, Hq, Hkv, causal, scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = ssi::allow_dynamic_smem(dq_hopper_kernel<C>, dq_smem<C>(), allowed_dq);
    if (err != cudaSuccess) return err;
    dq_hopper_kernel<C><<<dim3(Hq, B, (S + DQ_ROWS - 1) / DQ_ROWS), THREADS, dq_smem<C>(), stream>>>(
        tq, tk_dq, tv_dq, tdo, tdq, lse, delta, seg, S, Hq, Hkv, causal, scale);
    return cudaGetLastError();
}

}  // namespace
