// Flash-attention forward, bf16, head_dim 128 (Llama 3.2 3B, Llama 3.1 8B):
// causal or full GQA with optional packed segment ids, designed for Hopper.
//
// Replaces, at head_dim 128 in bf16, the TPU kernels
// ssi_tpu/ops/flash_attention.py `_fwd_kernel` and `_fwd_kernel_grouped`
// (one GQA schedule ports both); flash_attention_fwd.cu keeps the head_dim-64
// and f32 kernels and dispatches here. Semantics are those of that file:
// unscaled q with `scale` applied to the f32 scores, masked scores -1e30, the
// m_safe = max(m, -0.5e30) / l_safe = max(l, 1e-30) clamps (a fully masked
// row outputs 0 with a finite lse), the row sum over the f32 p, p cast to bf16
// for P.V, the output normalised once at the end. o is contiguous
// [B, S, Hq, 128], lse [B, Hq, S].
//
// What bounds it: the 4 * 128 FLOP of every allowed (query, key) pair, at the
// main path's shapes (3B training B2 S2048 24/8 heads, 8B prefill B8 S768 32/8)
// operations, not bytes. Only wgmma reaches the card's tensor-core rate, so
// the design follows FlashAttention-3 (Shah et al. 2024):
// - a block of 2 warpgroups (256 threads) per (q head, batch) and pair of
//   128-query tiles (n_q - 1 - k, then k: under causal masking every pair
//   holds n_q + 1 key tiles, so the blocks are even, and the K/V ring runs on
//   into the second tile, so its loads land under the first's products),
//   each warpgroup owning 64 query rows; under 200 registers a
//   thread, no spill, one block per SM. FA3's third, producer warpgroup with
//   setmaxnreg (24 / 240 registers) was built first: ptxas compiled its
//   consumer code to the 168 registers that 384 threads allow at launch, and
//   it spilled and serialised every wgmma. With 256 threads a thread may hold
//   255 registers, so there is no producer: thread 0 issues the first loads,
//   and whichever warpgroup releases a ring stage second refills it by TMA
//   (hopper::release_last), so no thread waits for the other warpgroup;
// - both Q tiles load once by TMA; 128-key K and V tiles ride a 2-stage ring
//   with a full mbarrier per stage for K and for V apart, so a K stage is
//   refilled as soon as its scores are formed and a V stage once its P.V
//   product is done. Shared memory: 2 x Q 32 KB +
//   2 x (K 32 + V 32) KB = 192 KB (+1 KB of alignment slack), every tile two
//   64-column halves with the 128-byte swizzle (hopper.cuh);
// - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory
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
// - causal: key tiles past a q tile's last query are never loaded, and only
//   the last (diagonal or ragged) tile applies the mask. With segment ids every
//   tile applies the mask (a warpgroup reads the keys' segments); skipping
//   foreign segments' tiles is a separate lever;
// - TMA tensor maps keep S and B as separate dimensions (rank 4 over
//   (128, H, S, B)), so a box past S is zero-filled: a ragged tile reads
//   zeros, whose masked p is 0 (no 0 x NaN). O leaves through each
//   warpgroup's own Q rows by TMA store, which skips rows past S;
// - the n_rep q heads of a kv head are neighbouring blocks and share each
//   K/V tile through L2 (50 MB holds the 3B training shape's K and V, 16 MB,
//   many times over); TMA multicast across a cluster would cut L2 reads but
//   ties n_rep blocks together in scheduling, and n_rep 3 does not divide
//   the cluster sizes that fit the GPC evenly.
// Its times on the card beside its bound and SDPA's: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_hd128.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ssi::hopper;
using bf16 = __nv_bfloat16;

constexpr int HD = 128;
constexpr int BQ = 128;  // query rows a block: two warpgroups of 64
constexpr int BK = 128;  // keys a K/V tile
constexpr int STAGES = 2;
constexpr int THREADS = 256;               // two warpgroups
constexpr int HALF = 128 * 64;             // elements of a 64-column half of a 128-row tile
constexpr uint32_t HALF_BYTES = HALF * 2;  // 16 KB
constexpr float NEG_INF = -1.0e30f;
constexpr float M_CLAMP = -0.5e30f;  // m_safe = max(m, M_CLAMP)
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
    bf16 q[2][2][HALF];  // the block's two q tiles
    bf16 k[STAGES][2][HALF];
    bf16 v[STAGES][2][HALF];
    uint64_t q_full[2], k_full[STAGES], v_full[STAGES];
    uint32_t k_done[STAGES], v_done[STAGES];  // releases of each stage (hopper::release_last)
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + slack to align the tiles to 1024 bytes

__device__ __forceinline__ void load_tile(bf16 (&dst)[2][HALF], const CUtensorMap* map, uint64_t* bar, int h, int s0,
                                          int b) {
    hw::mbar_expect_tx(bar, 2 * HALF_BYTES);
    hw::tma_load_4d(dst[0], map, bar, 0, h, s0, b);
    hw::tma_load_4d(dst[1], map, bar, 64, h, s0, b);
}

// A block takes two q tiles of one (q head, batch): n_q - 1 - pair, then pair
// (one tile when they meet). Under causal masking the pair holds n_q + 1 key
// tiles whatever `pair` is, so the blocks are even; the K/V ring runs on from
// the first tile into the second, so the second's loads land under the
// first's products.
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_hd128_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to, const int* __restrict__ seg,
    float* __restrict__ lse, int S, int Hq, int n_rep, int causal, float scale) {
    extern __shared__ unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(hw::align1024(smem_raw));

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int kvh = h / n_rep;
    const int n_q = (S + BQ - 1) / BQ;
    const int pair = blockIdx.z;
    const int n_work = n_q - 1 - pair == pair ? 1 : 2;
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

    float acc[64];   // O [64 x 128]: acc[4j + e], n8 block j of the columns
    float s[64];     // scores, then probabilities, of a [64 x 128 keys] tile
    uint32_t p[32];  // P in bf16 as A fragments: p[4kk ..] for the keys 16kk ..

    // the products of ring tile r read from stage st are done: the second
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
    // products; warpgroup 0 goes first, and warpgroup 1 skips its last pass
    // so every arrival is waited for
    auto my_turn = [&] { hw::named_sync(1 + cw, THREADS); };
    auto pass_turn = [&] { hw::named_arrive(2 - cw, THREADS); };
    if (cw == 1) pass_turn();

    for (int w = 0, r0 = 0; w < n_work; ++w) {  // r0: the ring index of this tile's first key tile
        const int q0 = q0_of(w);
        const int kv_end = kv_end_of(q0);
        const int n_tiles = (kv_end + BK - 1) / BK;
        // this thread's two query rows: lo (g) and hi (g + 8) of its warp's 16
        const int row_lo = q0 + cw * 64 + warp * 16 + g;
        const int row_hi = row_lo + 8;
        const int qseg_lo = (segb != nullptr && row_lo < S) ? segb[row_lo] : 0;
        const int qseg_hi = (segb != nullptr && row_hi < S) ? segb[row_hi] : 0;
        const uint32_t q_addr = ssi::smem_addr(sm.q[w][0]) + cw * 64 * 128;  // the warpgroup's 64 rows of half 0
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        float m_lo = NEG_INF, m_hi = NEG_INF;    // running max of the scaled, masked scores
        float ms_lo = M_CLAMP, ms_hi = M_CLAMP;  // m_safe, the exponent's shift
        float l_lo = 0.f, l_hi = 0.f;            // this thread's part of the row sums

        auto issue_scores = [&](int st) {  // s = Q . K^T, one committed group
            const uint32_t qa = hw::opaque(q_addr);
            const uint32_t ka = hw::opaque(ssi::smem_addr(sm.k[st][0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
                hw::wgmma_ss_n128(s, hw::desc_sw128(qa + off, 16, 1024), hw::desc_sw128(ka + off, 16, 1024),
                                  kk > 0);
            }
            hw::wgmma_commit();
        };
        auto issue_values = [&](int st) {  // acc += P . V, one committed group
            const uint32_t v_addr = hw::opaque(ssi::smem_addr(sm.v[st][0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                hw::wgmma_rs_n128_mn(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                     hw::desc_sw128(v_addr + kk * 16 * 128, HALF_BYTES, 1024), 1);
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
            const bool need_mask = segb != nullptr || it == n_tiles - 1;
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
        hw::pack_a<64>(p, s);
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
            hw::pack_a<64>(p, s);
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
        // rows, free since its last scores, then out by TMA
        hw::store_tile(acc, 1.f / ls_lo, 1.f / ls_hi, reinterpret_cast<unsigned char*>(sm.q[w][0]) + cw * 64 * 128,
                       HALF_BYTES, &to, h, q0 + cw * 64, b, 3 + cw);
        r0 += n_tiles;
    }
}

}  // namespace

cudaError_t ssi::flash_fwd_hd128_bf16(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse,
                                      int B, int S, int Hq, int Hkv, long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                      long long v_sh, int causal, float scale, cudaStream_t stream) {
    // TMA reads 16-byte aligned rows with strides that are multiples of 16 bytes
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (long long s : strides)
        if (s % 8 != 0) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
        return cudaErrorInvalidValue;
    if (B > 65535) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    cudaError_t err = hw::map_bshd(&tq, q, B, S, Hq, q_sb, q_ss, q_sh, BQ);
    if (err == cudaSuccess) err = hw::map_bshd(&tk, k, B, S, Hkv, k_sb, k_ss, k_sh, BK);
    if (err == cudaSuccess) err = hw::map_bshd(&tv, v, B, S, Hkv, v_sb, v_ss, v_sh, BK);
    CUtensorMap to;  // o, contiguous [B, S, Hq, 128], stored 64 rows (a warpgroup's) at a time
    if (err == cudaSuccess) err = hw::map_bshd(&to, o, B, S, Hq, (long long)S * Hq * HD, (long long)Hq * HD, HD, 64);
    if (err != cudaSuccess) return err;
    static int allowed = 0;
    err = ssi::allow_dynamic_smem(flash_fwd_hd128_kernel, SMEM_BYTES, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid(Hq, B, ((S + BQ - 1) / BQ + 1) / 2);  // a pair of q tiles a block
    flash_fwd_hd128_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(tq, tk, tv, to, seg, lse, S, Hq, Hq / Hkv, causal,
                                                                   scale);
    return cudaGetLastError();
}
