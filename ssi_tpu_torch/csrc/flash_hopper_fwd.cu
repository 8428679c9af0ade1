// Flash-attention forward, bf16, head_dim 64 (Llama 3.2 100m and 1B), 128
// (Llama 3.2 3B, Llama 3.1 8B) and 256 (Gemma's heads): causal or full GQA
// with optional packed segment ids, designed for Hopper.
//
// Replaces, in bf16, the TPU kernels ssi_tpu/ops/flash_attention.py
// `_fwd_kernel` and `_fwd_kernel_grouped` (one GQA schedule ports both);
// flash_attention_fwd.cu keeps the f32 parity kernel and dispatches bf16
// here. Semantics are those of that file: unscaled q with `scale` applied to
// the f32 scores, masked scores -1e30, the m_safe = max(m, -0.5e30) /
// l_safe = max(l, 1e-30) clamps (a fully masked row outputs 0 with a finite
// lse), the row sum over the f32 p, p cast to bf16 for P.V, the output
// normalised once at the end. o is contiguous [B, S, Hq, hd], lse [B, Hq, S].
//
// One kernel template serves the three head dims (Config below): the
// schedule, the ring, the masks, the softmax and the epilogue are the same at
// 64, 128 and 256, and only the count of 64-column blocks a tile row spans,
// the products' widths, the tile sizes and the q tiles a block takes differ,
// so a sibling source would repeat all of it.
//
// What bounds it: the 4 * hd FLOP of every allowed (query, key) pair; at the
// main path's shapes (1B prefill B8 S768 and training B2 S2048, 32 q / 8 kv
// heads; 3B training B2 S2048 24/8; 8B prefill B8 S768 32/8) operations, not
// bytes. At head_dim 64 the exponentials weigh as much as the products (one
// MUFU op a pair: 16 a clock on an SM against its 1,024 bf16 MACs, 64 a pair),
// so the softmax has to run under the products. Only wgmma reaches the card's
// tensor-core rate, so the design follows FlashAttention-3 (Shah et al. 2024):
// - a block of 2 warpgroups per (q head, batch) and pair of 128-query tiles
//   (n_q - 1 - k, then k: under causal masking every pair holds the same key
//   work, so the blocks are even, and the K/V ring runs on into the second
//   tile, so its loads land under the first's products), each warpgroup
//   owning 64 query rows. No producer warpgroup: FA3's third,
//   producer warpgroup with setmaxnreg (24 / 240 registers) was built first
//   at head_dim 128, and ptxas compiled its consumer code to the 168
//   registers that 384 threads allow at launch; it spilled and serialised
//   every wgmma. So thread 0 issues the first loads, and whichever warpgroup
//   releases a ring stage second refills it by TMA (hopper::release_last),
//   so no thread waits for the other warpgroup;
// - both Q tiles load once by TMA; BK-key K and V tiles ride a 2-stage ring
//   with a full mbarrier per stage for K and for V apart, so a K stage is
//   refilled as soon as its scores are formed and a V stage once its P.V
//   product is done. Every tile is one (head_dim 64) or two (128) 64-column
//   blocks with the 128-byte swizzle (hopper.cuh);
// - S = Q.K^T is wgmma m64nBKk16 with both operands in shared memory
//   (K-major); the online softmax runs on the accumulator fragments (quad
//   shuffles for the row max and sum, one-op exp2 with LOG2E, scale folded
//   into the exponent's FMA on tiles with no mask); O += P.V takes P from
//   registers (the RS form: the score accumulator repacked to bf16 A
//   fragments) and V through an MN-major descriptor;
// - the scores of tile j+1 are issued before its softmax and the P.V product
//   of tile j behind them, so one tile's exponentials run under the other's
//   products (two groups in flight a warpgroup; O is rescaled once its
//   product has landed), and the two warpgroups take turns to issue (named
//   barriers 1 and 2), so one's softmax runs under the other's products;
// - causal: key tiles past a q tile's last query are never loaded, and a
//   warpgroup applies the mask only to a tile that reaches past its first
//   query row or past the keys (the diagonal or ragged tiles). With segment
//   ids every tile applies the mask (a warpgroup reads the keys' segments);
//   skipping foreign segments' tiles is a separate lever;
// - TMA tensor maps keep S and B as separate dimensions (rank 4 over
//   (hd, H, S, B)), so a box past S is zero-filled: a ragged tile reads
//   zeros, whose masked p is 0 (no 0 x NaN). lse leaves from registers (a 1D
//   TMA box of it need not start 16-byte aligned), O through each
//   warpgroup's own Q rows by TMA store, which skips rows past S;
// - the n_rep q heads of a kv head are neighbouring blocks and share each
//   K/V tile through L2; TMA multicast across a cluster would cut L2 reads
//   but ties n_rep blocks together in scheduling, and n_rep 3 does not divide
//   the cluster sizes that fit the GPC evenly.
// Any other head_dim d <= 256 (a multiple of 8, the wrapper pads others)
// runs the instance of the next of 64, 128 and 256 on tensor maps whose
// innermost extent is d: a tile's columns past d load as zeros, the scale
// stays 1/sqrt(d), and the o store clips at d.
// Head_dim 256 (129-256): O is 128 f32 a thread at 64 rows, so 64-key tiles
// (32 more for S, 16 for P) and one block an SM; a q tile is 64 KB and a
// 64-key K or V stage 32 KB, so a block holds one q tile (the highest first:
// under causal masking the blocks are uneven, and the longest start first)
// and the 2-stage ring: 192 KB. Each tile row is four 64-column boxes.
// Head_dim 128: 2 warpgroups, 128-key tiles, one block an SM (193 KB of
// shared memory, ~200 registers). Head_dim 64 halves the work a key tile and
// not a block's fixed cost (its Q and first K/V loads, one score product with
// nothing under it, the epilogue), which sits exposed on an SM that holds one
// block. Its configuration (Hd64 below) was chosen by timing three on the
// card (NVIDIA H100 80GB HBM3, 700 W, causal, 32 q / 8 kv heads; the numbers
// and how they were taken: PERF.md section 6): 64-key tiles and two blocks an
// SM (65 KB of shared memory and at most 128 registers a thread: 124, no
// spill), so one block's prologue and epilogue run under the other's
// products, read 0.076 ms at B8 S768 and 0.109-0.110 ms at B2 S2048; 128-key
// tiles at one block an SM 0.087 and 0.114 ms, and 3 warpgroups (192 query
// rows, FA3's tile at head_dim 64) at one block an SM 0.089 and 0.121 ms.
// Its times on the card beside its bound and SDPA's: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hopper.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ssi::hopper;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 2;
constexpr float NEG_INF = -1.0e30f;
constexpr float M_CLAMP = -0.5e30f;  // m_safe = max(m, M_CLAMP)
constexpr float LOG2E = 1.4426950408889634f;

constexpr int BQ = 128;       // query rows a q tile: two warpgroups of 64
constexpr int THREADS = 256;  // two warpgroups

// HD: head_dim; BK: keys a K/V tile; MIN_BLOCKS: blocks an SM the registers
// are budgeted for; Q_TILES: q tiles a block takes (2: a pair, see below)
template <int HD_, int BK_, int MIN_BLOCKS_, int Q_TILES_ = 2>
struct Config {
    static constexpr int HD = HD_;
    static constexpr int BK = BK_;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
    static constexpr int Q_TILES = Q_TILES_;
    static constexpr int BLOCKS = HD_ / 64;                 // 64-column blocks of a tile row
    static constexpr uint32_t Q_BLOCK_BYTES = BQ * 128;     // one 64-column block of a q tile
    static constexpr uint32_t KV_BLOCK_BYTES = BK_ * 128;  // ... of a K or V tile
};

// head_dim 64: the configuration that measured fastest on the card (see the
// top of the file); head_dim 128: 128-key tiles, one block an SM; head_dim
// 256: 64-key tiles and one q tile a block, one block an SM
using Hd64 = Config<64, 64, 2>;
using Hd128 = Config<128, 128, 1>;
using Hd256 = Config<256, 64, 1, 1>;

template <class C>
struct Smem {
    bf16 q[C::Q_TILES][C::BLOCKS][BQ * 64];  // the block's q tiles
    bf16 k[STAGES][C::BLOCKS][C::BK * 64];
    bf16 v[STAGES][C::BLOCKS][C::BK * 64];
    uint64_t q_full[2], k_full[STAGES], v_full[STAGES];
    uint32_t k_done[STAGES], v_done[STAGES];  // releases of each stage (hopper::release_last)
};
template <class C>
constexpr int smem_bytes() {
    return sizeof(Smem<C>) + 1024;  // + slack to align the tiles to 1024 bytes
}

template <int BLOCKS, int ELEMS>
__device__ __forceinline__ void load_tile(bf16 (&dst)[BLOCKS][ELEMS], const CUtensorMap* map, uint64_t* bar, int h,
                                          int s0, int b) {
    hw::mbar_expect_tx(bar, BLOCKS * ELEMS * 2);
#pragma unroll
    for (int blk = 0; blk < BLOCKS; ++blk) hw::tma_load_4d(dst[blk], map, bar, 64 * blk, h, s0, b);
}

// the score product of one k16 step, m64n64 or m64n128 by the accumulator's size
__device__ __forceinline__ void scores_step(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void scores_step(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_n128(d, a, b, acc);
}
// the P.V product of one k16 step (P from registers, V MN-major), by O's size
__device__ __forceinline__ void values_step(float (&d)[32], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n64_mn(d, a[0], a[1], a[2], a[3], b, 1);
}
__device__ __forceinline__ void values_step(float (&d)[64], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n128_mn(d, a[0], a[1], a[2], a[3], b, 1);
}
__device__ __forceinline__ void values_step(float (&d)[128], const uint32_t* a, uint64_t b) {
    hw::wgmma_rs_n256_mn(d, a[0], a[1], a[2], a[3], b, 1);
}

// A block takes two q tiles of one (q head, batch): n_q - 1 - pair, then pair
// (one tile when they meet). Under causal masking the pair holds the same key
// work whatever `pair` is, so the blocks are even; the K/V ring runs on from
// the first tile into the second, so the second's loads land under the
// first's products. With Q_TILES 1 (head_dim 256) blockIdx.z counts single
// tiles, and a block takes tile n_q - 1 - blockIdx.z alone.
template <class C>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS) flash_fwd_hopper_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, const int* __restrict__ seg,
    float* __restrict__ lse, int S, int Hq, int n_rep, int causal, float scale) {
    constexpr int HD = C::HD, BK = C::BK;
    extern __shared__ unsigned char smem_raw[];
    Smem<C>& sm = *reinterpret_cast<Smem<C>*>(hw::align1024(smem_raw));

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int kvh = h / n_rep;
    const int n_q = (S + BQ - 1) / BQ;
    const int pair = blockIdx.z;
    const int n_work = C::Q_TILES == 1 || n_q - 1 - pair == pair ? 1 : 2;
    auto q0_of = [&](int w) { return (w == 0 ? n_q - 1 - pair : pair) * BQ; };
    auto kv_end_of = [&](int q0) { return causal ? min(S, q0 + BQ) : S; };
    const int n_first = (kv_end_of(q0_of(0)) + BK - 1) / BK;
    const int n_ring = n_first + (n_work == 2 ? (kv_end_of(q0_of(1)) + BK - 1) / BK : 0);  // K/V tiles the ring carries
    auto key_tile = [&](int r) { return r < n_first ? r : r - n_first; };                 // ring index -> key tile

    if (threadIdx.x == 0) {  // barriers, then the Q tiles and the first K/V tiles
        for (int w = 0; w < 2; ++w) hw::mbar_init(&sm.q_full[w], 1);
        for (int st = 0; st < STAGES; ++st) {
            hw::mbar_init(&sm.k_full[st], 1);
            hw::mbar_init(&sm.v_full[st], 1);
            sm.k_done[st] = sm.v_done[st] = 0;
        }
        hw::fence_barrier_init();
        load_tile(sm.q[0], &tq, &sm.q_full[0], h, q0_of(0), b);
        for (int r = 0; r < min(STAGES, n_ring); ++r) {
            load_tile(sm.k[r], &tk, &sm.k_full[r], kvh, key_tile(r) * BK, b);
            load_tile(sm.v[r], &tv, &sm.v_full[r], kvh, key_tile(r) * BK, b);
        }
        if constexpr (C::Q_TILES == 2)
            if (n_work == 2) load_tile(sm.q[1], &tq, &sm.q_full[1], h, q0_of(1), b);
    }
    __syncthreads();

    const int cw = threadIdx.x / 128;  // this warpgroup's rows: q0 + 64 cw ..
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int* segb = seg != nullptr ? seg + (long long)b * S : nullptr;

    float acc[HD / 2];   // O [64 x HD]: acc[4j + e], n8 block j of the columns
    float s[BK / 2];     // scores, then probabilities, of a [64 x BK keys] tile
    uint32_t p[BK / 4];  // P in bf16 as A fragments: p[4kk ..] for the keys 16kk ..

    // the products of ring tile r read from stage st are done: the last
    // warpgroup to say so refills the stage with ring tile r + STAGES
    auto release_k = [&](int r, int st) {
        if (t == 0 && hw::release_last(&sm.k_done[st]) && r + STAGES < n_ring)
            load_tile(sm.k[st], &tk, &sm.k_full[st], kvh, key_tile(r + STAGES) * BK, b);
    };
    auto release_v = [&](int r, int st) {
        if (t == 0 && hw::release_last(&sm.v_done[st]) && r + STAGES < n_ring)
            load_tile(sm.v[st], &tv, &sm.v_full[st], kvh, key_tile(r + STAGES) * BK, b);
    };
    // the two warpgroups take turns to issue their products (named barriers 1
    // and 2: warpgroup cw's turn), so one's softmax runs under the other's
    // products; warpgroup 0 goes first, and warpgroup 1 skips its last pass so
    // every arrival is waited for
    auto my_turn = [&] { hw::named_sync(1 + cw, THREADS); };
    auto pass_turn = [&] { hw::named_arrive(2 - cw, THREADS); };
    if (cw == 1) pass_turn();

    for (int w = 0, r0 = 0; w < n_work; ++w) {  // r0: the ring index of this tile's first key tile
        const int q0 = q0_of(w);
        const int kv_end = kv_end_of(q0);
        const int n_tiles = (kv_end + BK - 1) / BK;
        const int row0 = q0 + cw * 64;  // the warpgroup's first query row
        // a tile whose keys reach past this (exclusive) end needs the mask
        const int unmasked_end = causal ? min(kv_end, row0 + 1) : kv_end;
        // this thread's two query rows: lo (g) and hi (g + 8) of its warp's 16
        const int row_lo = row0 + warp * 16 + g;
        const int row_hi = row_lo + 8;
        const int qseg_lo = (segb != nullptr && row_lo < S) ? segb[row_lo] : 0;
        const int qseg_hi = (segb != nullptr && row_hi < S) ? segb[row_hi] : 0;
        const uint32_t q_addr = ssi::smem_addr(sm.q[w][0]) + cw * 64 * 128;  // the warpgroup's 64 rows of block 0
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
        float m_lo = NEG_INF, m_hi = NEG_INF;    // running max of the scaled, masked scores
        float ms_lo = M_CLAMP, ms_hi = M_CLAMP;  // m_safe, the exponent's shift
        float l_lo = 0.f, l_hi = 0.f;            // this thread's part of the row sums

        auto issue_scores = [&](int st) {  // s = Q . K^T, one committed group
            const uint32_t qa = hw::opaque(q_addr);
            const uint32_t ka = hw::opaque(ssi::smem_addr(sm.k[st][0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t in_block = (kk % 4) * 32;  // k16 step kk within its 64-column block
                scores_step(s, hw::desc_sw128(qa + (kk / 4) * C::Q_BLOCK_BYTES + in_block, 16, 1024),
                            hw::desc_sw128(ka + (kk / 4) * C::KV_BLOCK_BYTES + in_block, 16, 1024), kk > 0);
            }
            hw::wgmma_commit();
        };
        auto issue_values = [&](int st) {  // acc += P . V, one committed group
            const uint32_t v_addr = hw::opaque(ssi::smem_addr(sm.v[st][0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                values_step(acc, &p[4 * kk], hw::desc_sw128(v_addr + kk * 16 * 128, C::KV_BLOCK_BYTES, 1024));
            hw::wgmma_commit();
            hw::fence_regs(p);
        };
        // scale and mask the scores of tile `it`, fold them into the running
        // max, and replace them by p = exp(s - m_safe); returns the rescale of
        // the earlier sums (alpha) and adds p to the row sums. A tile with no
        // mask keeps its raw scores: the max of scale * s is scale * max(s)
        // (rounding is monotone), and scale joins LOG2E in the exponent's FMA
        auto softmax = [&](int it, float& alpha_lo, float& alpha_hi) {
            const int k0 = it * BK;
            const bool need_mask = segb != nullptr || k0 + BK > unmasked_end;
            float mx_lo = NEG_INF, mx_hi = NEG_INF;
            if (need_mask) {
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
                        const int qp = e < 2 ? row_lo : row_hi;
                        bool keep = kp < kv_end && (!causal || kp <= qp);
                        if (segb != nullptr) keep = keep && segb[kp] == (e < 2 ? qseg_lo : qseg_hi);
                        s[4 * j + e] = keep ? s[4 * j + e] * scale : NEG_INF;
                    }
                    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
                    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
                }
            } else {
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
                    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
                }
            }
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
            if (!need_mask) {
                mx_lo *= scale;
                mx_hi *= scale;
            }
            m_lo = fmaxf(m_lo, mx_lo);
            m_hi = fmaxf(m_hi, mx_hi);
            const float ms_new_lo = fmaxf(m_lo, M_CLAMP);
            const float ms_new_hi = fmaxf(m_hi, M_CLAMP);
            alpha_lo = hw::exp2_ftz((ms_lo - ms_new_lo) * LOG2E);
            alpha_hi = hw::exp2_ftz((ms_hi - ms_new_hi) * LOG2E);
            ms_lo = ms_new_lo;
            ms_hi = ms_new_hi;
            l_lo *= alpha_lo;
            l_hi *= alpha_hi;
            const float c = need_mask ? LOG2E : scale * LOG2E;  // the exponent's factor on s
            const float sh_lo = ms_lo * LOG2E;
            const float sh_hi = ms_hi * LOG2E;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                s[4 * j] = hw::exp2_ftz(fmaf(s[4 * j], c, -sh_lo));
                s[4 * j + 1] = hw::exp2_ftz(fmaf(s[4 * j + 1], c, -sh_lo));
                s[4 * j + 2] = hw::exp2_ftz(fmaf(s[4 * j + 2], c, -sh_hi));
                s[4 * j + 3] = hw::exp2_ftz(fmaf(s[4 * j + 3], c, -sh_hi));
                l_lo += s[4 * j] + s[4 * j + 1];
                l_hi += s[4 * j + 2] + s[4 * j + 3];
            }
        };

        float alpha_lo, alpha_hi;
        hw::mbar_wait(&sm.q_full[w], 0);
        hw::mbar_wait(&sm.k_full[r0 % STAGES], (r0 / STAGES) & 1);
        my_turn();
        issue_scores(r0 % STAGES);
        pass_turn();
        hw::wgmma_wait<0>();
        hw::fence_regs(s);
        release_k(r0, r0 % STAGES);
        softmax(0, alpha_lo, alpha_hi);  // acc is still 0: nothing to rescale
        hw::pack_a<BK / 2>(p, s);
        for (int it = 1; it < n_tiles; ++it) {
            const int r = r0 + it;
            const int st = r % STAGES;
            const int prev = (r - 1) % STAGES;
            hw::mbar_wait(&sm.k_full[st], (r / STAGES) & 1);
            hw::mbar_wait(&sm.v_full[prev], ((r - 1) / STAGES) & 1);
            my_turn();
            issue_scores(st);    // tile it's scores ...
            issue_values(prev);  // ... then tile it-1's P . V behind them
            pass_turn();
            hw::wgmma_wait<1>();  // the scores have landed; P . V may still run
            hw::fence_regs(s);
            release_k(r, st);
            softmax(it, alpha_lo, alpha_hi);
            hw::wgmma_wait<0>();
            hw::fence_regs(acc);
            hw::fence_regs(p);
            release_v(r - 1, prev);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                acc[4 * j] *= alpha_lo;
                acc[4 * j + 1] *= alpha_lo;
                acc[4 * j + 2] *= alpha_hi;
                acc[4 * j + 3] *= alpha_hi;
            }
            hw::pack_a<BK / 2>(p, s);
        }
        const int last = r0 + n_tiles - 1;
        hw::mbar_wait(&sm.v_full[last % STAGES], (last / STAGES) & 1);
        my_turn();
        issue_values(last % STAGES);
        if (cw == 0 || w + 1 < n_work) pass_turn();
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        release_v(last, last % STAGES);

        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
        const float ls_lo = fmaxf(l_lo, 1e-30f);
        const float ls_hi = fmaxf(l_hi, 1e-30f);
        if (t4 == 0 && row_lo < S) lse[((long long)b * Hq + h) * S + row_lo] = ms_lo + logf(ls_lo);
        if (t4 == 0 && row_hi < S) lse[((long long)b * Hq + h) * S + row_hi] = ms_hi + logf(ls_hi);
        // O (one division a row, then products) into this warpgroup's own Q
        // rows, free since its last scores, then out by TMA (named barrier
        // 3 + cw: this warpgroup alone)
        hw::store_tile(acc, 1.f / ls_lo, 1.f / ls_hi, reinterpret_cast<unsigned char*>(sm.q[w][0]) + cw * 64 * 128,
                       C::Q_BLOCK_BYTES, &to, h, row0, b, 3 + cw);
        r0 += n_tiles;
    }
}

// hd: the operands' head_dim, at most C::HD. The tensor maps' innermost
// extent is hd, so the columns of a tile past hd are zero-filled on load (they
// add nothing to a score, and P.V's columns past hd are zeros that the o
// store, clipped at hd, never writes).
template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int B, int S,
                   int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal,
                   float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    cudaError_t err = hw::map_bshd(&tq, q, B, S, Hq, hd, q_sb, q_ss, q_sh, BQ);
    if (err == cudaSuccess) err = hw::map_bshd(&tk, k, B, S, Hkv, hd, k_sb, k_ss, k_sh, C::BK);
    if (err == cudaSuccess) err = hw::map_bshd(&tv, v, B, S, Hkv, hd, v_sb, v_ss, v_sh, C::BK);
    CUtensorMap to;  // o, contiguous [B, S, Hq, hd], stored 64 rows (a warpgroup's) at a time
    if (err == cudaSuccess) err = hw::map_bshd(&to, o, B, S, Hq, hd, (long long)S * Hq * hd, (long long)Hq * hd, hd, 64);
    if (err != cudaSuccess) return err;
    static int allowed = 0;
    err = ssi::allow_dynamic_smem(flash_fwd_hopper_kernel<C>, smem_bytes<C>(), allowed);
    if (err != cudaSuccess) return err;
    const int n_q = (S + BQ - 1) / BQ;
    const dim3 grid(Hq, B, C::Q_TILES == 2 ? (n_q + 1) / 2 : n_q);  // a pair of q tiles a block, or one
    flash_fwd_hopper_kernel<C><<<grid, THREADS, smem_bytes<C>(), stream>>>(tq, tk, tv, to, seg, lse, S, Hq,
                                                                                Hq / Hkv, causal, scale);
    return cudaGetLastError();
}

}  // namespace

cudaError_t ssi::flash_fwd_hopper_bf16(const void* q, const void* k, const void* v, const int* seg, void* o,
                                       float* lse, int B, int S, int Hq, int Hkv, int hd, long long q_sb,
                                       long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
                                       cudaStream_t stream) {
    // TMA reads 16-byte aligned rows with strides that are multiples of 16 bytes
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (long long s : strides)
        if (s % 8 != 0) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return cudaErrorInvalidValue;
    if (B > 65535 || hd <= 0 || hd > 256 || hd % 8 != 0) return cudaErrorInvalidValue;
    // the hd-64 instance up to 64 columns, the hd-128 one up to 128, the hd-256 one above
    if (hd <= 64)
        return launch<Hd64>(q, k, v, seg, o, lse, B, S, Hq, Hkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                            v_sh, causal, scale, stream);
    if (hd > 128)
        return launch<Hd256>(q, k, v, seg, o, lse, B, S, Hq, Hkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                             v_sh, causal, scale, stream);
    return launch<Hd128>(q, k, v, seg, o, lse, B, S, Hq, Hkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                         causal, scale, stream);
}
