// Paged attention over the flat KV pool, split across the context: the fused
// single-token decode (kernel #8) and the T-token write + verify of
// speculative decoding (kernel #9) on one core. Any head_dim hd <= 256 (64:
// the 100m and 1B models; 128: 3B and 8B; 16: tiny_test; 256: Gemma's heads),
// by an instance at HD 64, one at 128 and one at 256 that each take the
// head_dims up to theirs; any GQA ratio n_rep and T <= 8; f32 or bf16
// storage; page sizes that are multiples of 8. A head_dim that is not a
// multiple of 8 takes the plain-load kernels (below): TMA cannot describe
// its pools.
//
// Replaces the TPU kernels ssi_tpu/generate/paged_pallas.py
// `paged_attention_pallas` -> `_kernel` and `paged_attention_pallas_multi`
// -> `_kernel_multi`. Semantics kept: the pools are [L*n_pages + 1,
// page_size, Hkv*hd] (head-flattened rows, trash row last), updated in place
// (torch tensors are mutable, so the TPU kernels' input_output_aliases has no
// counterpart); `page_table` [slots, max_pages] holds PHYSICAL rows; q
// [slots, T, Hq, hd] is unscaled and scaled here by `scale`; the history is
// the hist_len tokens resident in the pages before the step, and in-flight
// token t attends the history plus in-flight tokens 0..t (causal), taken
// from k_new / v_new, never re-read from the cells just written.
// - #8 (T = 1): `seq_lens` counts the incoming token, so hist_len =
//   seq_len - 1 (an inactive slot has seq_len 0 and reads no history); the
//   token is written to row `write_rows[slot]` at offset (seq_len - 1) mod ps,
//   inactive slots to the trash row;
// - #9 (T <= 8): `hist_lens` is hist_len; token t goes to row
//   `write_rows[slot, t]` at offset (hist_len + t) mod ps, and a row equal to
//   the trash row is skipped (an inactive slot, or a position at or past the
//   slot's write cap). The TPU kernel persists the T tokens through two
//   aligned 8-row read-modify-write windows, a TPU DMA alignment rule; here
//   each token has its own write row.
//
// What bounds it on Hopper: the bytes of the history pages (each history K
// and V element is read once per step and used by all T * n_rep query rows of
// its kv head: ~4 FLOP per byte at T 1, ~32 at T 8, far below the 295 at
// which the tensor cores would bound it). At the serving shapes a call reads
// 10-40 MB, ~3-12 us at the card's rate, so the fixed costs of a launch and
// of a block weigh as much as the streaming. And a kv head's stripe of a key
// row is 128 or 256 bytes, 1-2 KB from the next key's: TMA moves such rows
// at a bounded rate per SM, with a cost per box on top (`python3 -m
// ssi_tpu_torch.profile_paged` reads both), so a ragged batch is as fast as
// the SM its longest slots land on, and boxes are as large as a page allows. The bf16 design (one kernel for both head_dims and
// T 1-8) is spent on those:
// - one block of 5 warps per (split, kv head, slot), each split walking
//   `split_keys` keys (whole pages; the wrapper's split plan: 1,280 keys, so
//   the serving shapes take one split and no merge); splits past a slot's
//   history exit at once. Up to 64 query rows of the kv head (R = T * n_rep)
//   are in the block, so at R <= 64 (every registry model) every history
//   byte is read once per call. A larger R (n_rep 16 at T 8: 128 rows, as
//   Llama 3.1 405B's 128 q / 8 kv heads) takes ceil(R / 64) row groups, a
//   block each (a grid axis beside the splits), each reading the pages again;
// - pages arrive by TMA: the pools are 3D tensor maps [rows * ps, Hkv, hd]
//   (encoded on the host, cached by the wrapper) read in boxes of `box` keys
//   (the largest power of two dividing ps, at most the tile: a box never
//   crosses a page) by one kv head by 64 columns, 128-byte swizzled. A box's
//   columns past hd are zero-filled: at hd 80 the second 64-column box of a
//   head holds its 16 last columns and zeros, never the next head's keys
//   (which a 2D map over [rows * ps, Hkv * hd] would read). Q and the
//   in-flight rows are loaded with zeros past hd, so every product runs at
//   the instance's HD and the stores stop at hd. Tiles are BK keys (128
//   at head_dim 64, 64 at 128: 32 KB of K and V either way), so at page 128
//   a tile is one box per 64 columns of each of K and V. One lane of a
//   fifth, producer warp issues a tile's boxes onto the stage's `full`
//   mbarrier once the 4 product warps have arrived on its `empty` one; the
//   ring has 2 stages (64 KB: 3 blocks an SM at head_dim 64, 2 at 128; 128
//   KB at 256, one block an SM). The
//   address work of a tile is a page-table read per box in that lane, off
//   the products' path, and the product warps never wait for each other
//   within the key loop;
// - S = Q.K^T and P.V run on mma.sync m16n8k16 (csrc/mma.cuh) with f32
//   accumulators, fed by ldmatrix from the swizzled tiles (conflict-free).
//   R is 3-64 rows: a 64-row wgmma would mostly compute padding, and the
//   products are far from bounding the kernel. The block's 4 warps split the
//   rows' m16 tiles into row groups (a warp holds at most two m16 tiles at
//   head_dim 64, one at 128 and 256: Q's fragments and its [16 x HD] f32
//   sums stay in registers up to 128; at 256 the sums alone are 128 a
//   thread, so Q's fragments are read from its rows in shared memory by
//   ldmatrix at each k16 step, and the in-flight tile gets bytes of its own)
//   and each tile's keys into key slices, one per warp of a
//   row group; each warp runs its own online softmax over its keys, and the
//   slices are combined once, at the end, in slice order. Row r is in-flight
//   token r / n_rep of q head r % n_rep; padding rows are computed and never
//   stored. As in the flash forward, scores are scaled and masked in f32
//   (masked: -1e30, with the m_safe clamp), the row sums add the f32
//   probabilities, and P is cast to bf16 for P.V;
// - keys past the history: a box brings whole page rows, so a slot's last
//   tile holds keys at or past hist_len with whatever the pool holds there
//   (stale data, NaN, Inf), and rows no box was issued for hold an earlier
//   tile's bytes. Their scores are replaced (a select, not arithmetic) by the
//   mask value and their V rows are zeroed in shared memory before P.V, so
//   no such value reaches the output (0 * NaN would);
// - the in-flight K/V rows (T <= 8) are read with plain 16-byte loads at the
//   block's start (registers), written to their cells from there, and stored
//   as one 16-key tile after the history. Every read that needs no history
//   length (Q, these rows, the split's first page) is issued before the
//   length's own;
// - one launch per call: a slot whose history fits one split is finished by
//   that split, which writes the normalised output itself. Otherwise each
//   split writes its unnormalised state to the scratch `part` and counts its
//   arrival on the (slot, kv head, row group)'s counter; the split that
//   arrives last combines the group's rows of all the slot's splits, in split
//   order, and resets the counter to 0. Which block merges depends on
//   timing; what it computes does not, so two launches give the same bits.
// - f32 (the parity path), and bf16 at a head_dim that is not a multiple of
//   8: the same split with scalar FMAs, one block of 128 threads holding a
//   row group's rows, K and V staged as f32 by plain loads, and a merge
//   kernel launched right after (two launches a call).
//
// Scratch (allocated by the wrapper; the kernels allocate nothing):
//   o  [slots, Hkv, n_splits, R, hd] f32: sum over the split's keys of
//      exp(s - m) * v;
//   ml [slots, Hkv, n_splits, R, 2]  f32: (m, sum of exp(s - m)),
// the ml block following the o block; its size is bounded by the wrapper's
// cap on n_splits: a long context gives each split more pages, not more
// splits. `counters` [slots * Hkv * row groups] int32, zero between calls
// (bf16 only).
//
// The split that holds the slot's last history key (split 0 when the history
// is empty) also folds in the in-flight tokens, and its block of row group 0
// does the token writes (in bf16 first, from the registers its in-flight rows
// are read into; in f32 at its end). No block reads what another writes: the
// token writes land at positions >= hist_len of their own slot, in their own
// kv head's columns, and only that split's own last box reaches past hist_len
// (masked, whatever it reads there, in every row group); a page shared
// through the prefix cache holds prompt positions <= p-2 only and is never a
// write target. In every kernel here
// blockIdx.y is the kv head, and blockIdx.x the split (split + n_splits *
// row group in the split kernels).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "paged_common.cuh"

using namespace ssi::paged;

namespace {

namespace hw = ssi::hopper;

constexpr int CONSUMERS = 128;           // bf16: 4 warps run the products
constexpr int BF16_THREADS = CONSUMERS + 32;  // and a producer warp issues the page loads

// ---- bf16: TMA page loads, tensor cores, one launch ---------------------------

// keys per tile (a TMA box of up to BK rows per 64 columns, two column
// blocks at head_dim 128, four at 256) and the ring's stages: a 64 KB ring,
// 128 KB at head_dim 256 (64-key tiles there too: a warp's key slice is at
// least one k16 step)
template <int HD>
constexpr int BK = HD == 64 ? 128 : 64;
constexpr int STAGES = 2;
constexpr int IN_ROWS = 16;               // the in-flight tile: T <= 8 keys, padded to one k16 step

// Byte offset of 16-byte chunk `ch` (of HD / 8) of row `r` in a [ROWS, HD]
// bf16 tile stored as HD / 64 blocks of [ROWS, 64], 128 bytes a row, with the
// 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8)): what a TMA box
// with CU_TENSOR_MAP_SWIZZLE_128B writes at a 1024-byte aligned address. The
// 8 rows of an ldmatrix matrix fall in 8 distinct bank groups.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
    return (ch / 8) * (ROWS * 128) + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
}

// How the 4 warps share a block's 16 * MT query rows (MT m16 tiles: 1, 2 or
// 4) and each tile's BK keys: warp w holds m16 tiles [rg * MTW, (rg + 1) *
// MTW) of row group rg = w / KW, and keys [kw * NK, (kw + 1) * NK) of every
// tile, kw = w % KW.
template <int HD, int MT>
struct WarpSplit {
    static constexpr int MTW = HD == 64 ? (MT < 2 ? MT : 2) : 1;
    static constexpr int RG = MT / MTW;
    static constexpr int KW = WARPS / RG;
    static constexpr int NK = BK<HD> / KW;
};

template <int HD, int MT>
struct Combine {  // each key slice's partial state, after the key loop
    static constexpr int KW = WarpSplit<HD, MT>::KW;
    float o[KW][16 * MT][HD + 4];  // f32 rows padded by 4
    float m[KW][16 * MT];
    float l[KW][16 * MT];
};

// Q's A fragments held in registers (head_dim up to 128), or read from Q's
// rows in shared memory by ldmatrix at each use (256: the fragments would be
// 64 registers a thread beside O's 128)
template <int HD>
constexpr bool Q_IN_REGS = HD <= 128;

// Q's rows and the in-flight tile: at head_dim up to 128 the tile takes Q's
// bytes once Q's fragments are in registers; at 256 Q stays in shared memory
template <int HD, int MT, bool SHARE = Q_IN_REGS<HD>>
struct QIn {
    union {
        bf16 q[16 * MT][ssi::lds<HD>];  // until Q's fragments are in registers
        struct {
            bf16 k[IN_ROWS * HD];  // then the in-flight tile, swz<IN_ROWS>
            bf16 v[IN_ROWS * HD];
        } in;
    };
};
template <int HD, int MT>
struct QIn<HD, MT, false> {
    bf16 q[16 * MT][ssi::lds<HD>];
    struct {
        bf16 k[IN_ROWS * HD];
        bf16 v[IN_ROWS * HD];
    } in;
};

template <int HD, int MT>
struct PagedSmem {
    union {
        struct {
            bf16 k[STAGES][BK<HD> * HD];  // TMA destinations, swz<BK> (each stage 1024-byte aligned)
            bf16 v[STAGES][BK<HD> * HD];
        } ring;
        Combine<HD, MT> cb;  // after the key loop
    };
    QIn<HD, MT> qi;
    uint64_t full[STAGES];   // a stage's tile has landed
    uint64_t empty[STAGES];  // the 4 warps are done with a stage
    int merge;  // this block arrived last: it merges the slot's splits
};
static_assert(sizeof(Combine<64, 4>) <= sizeof(PagedSmem<64, 4>::ring) &&
              sizeof(Combine<64, 2>) <= sizeof(PagedSmem<64, 2>::ring) &&
              sizeof(Combine<128, 1>) <= sizeof(PagedSmem<128, 1>::ring) &&
              sizeof(Combine<128, 4>) <= sizeof(PagedSmem<128, 4>::ring) &&
              sizeof(Combine<256, 1>) <= sizeof(PagedSmem<256, 1>::ring) &&
              sizeof(Combine<256, 4>) <= sizeof(PagedSmem<256, 4>::ring),
              "the combine reuses the ring's bytes");
static_assert(sizeof(PagedSmem<128, 4>) + 1024 <= 227 * 1024 && sizeof(PagedSmem<256, 4>) + 1024 <= 227 * 1024,
              "a block's shared memory");

// a warp's online-softmax state over its keys, for its MTW m16 tiles of rows
template <int HD, int MTW>
struct RowState {
    float acc[MTW][HD / 8][4];  // O: [16 x HD] per m16 tile, the mma.sync C layout
    float m_lo[MTW], m_hi[MTW], ms_lo[MTW], ms_hi[MTW], l_lo[MTW], l_hi[MTW];
};

// Q's A fragments of a warp's MTW m16 tiles, in registers (Q_IN_REGS) or
// read from shared memory (q: the warp's first row) at each k16 step
template <int HD, int MTW, bool REGS = Q_IN_REGS<HD>>
struct QFrags {
    uint32_t f[MTW][HD / 16][4];
};
template <int HD, int MTW>
struct QFrags<HD, MTW, false> {
    const bf16 (*q)[ssi::lds<HD>];
};

// One key step of a warp over NKS keys, rows j0 .. j0 + NKS of the tile at
// k / v (ROWS rows, swz<ROWS>): S = Q.K^T, scale and mask, the online-softmax
// update, O += P.V. mask 0: every key is history; 1: keys >= kend are past
// it; 2: the in-flight tile (key j is token j: row r sees it when j < T and
// j <= r's token). Masking is a select, so a score made from garbage never
// enters a sum.
template <int HD, int MTW, int NKS, int ROWS>
__device__ __forceinline__ void attend(RowState<HD, MTW>& st, const QFrags<HD, MTW>& qf,
                                       const unsigned char* k, const unsigned char* v, int j0, int mask, int kend,
                                       int row0, const Args& a) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    float s[MTW][NKS / 8][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int nb = 0; nb < NKS / 8; ++nb) s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        if constexpr (Q_IN_REGS<HD>) {
#pragma unroll
            for (int j2 = 0; j2 < NKS / 16; ++j2) {
                uint32_t kf[4];
                ssi::ldmatrix_x4(kf, k + swz<ROWS>(j0 + j2 * 16 + (lane / 16) * 8 + lane % 8, kk * 2 + (lane / 8) % 2));
#pragma unroll
                for (int mt = 0; mt < MTW; ++mt) {
                    ssi::mma_bf16(s[mt][2 * j2], qf.f[mt][kk], kf[0], kf[1]);
                    ssi::mma_bf16(s[mt][2 * j2 + 1], qf.f[mt][kk], kf[2], kf[3]);
                }
            }
        } else {
            uint32_t qk[MTW][4];  // Q's k16 step kk of each m16 tile, from shared memory
#pragma unroll
            for (int mt = 0; mt < MTW; ++mt)
                ssi::ldmatrix_x4(qk[mt], &qf.q[mt * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
            for (int j2 = 0; j2 < NKS / 16; ++j2) {
                uint32_t kf[4];
                ssi::ldmatrix_x4(kf, k + swz<ROWS>(j0 + j2 * 16 + (lane / 16) * 8 + lane % 8, kk * 2 + (lane / 8) % 2));
#pragma unroll
                for (int mt = 0; mt < MTW; ++mt) {
                    ssi::mma_bf16(s[mt][2 * j2], qk[mt], kf[0], kf[1]);
                    ssi::mma_bf16(s[mt][2 * j2 + 1], qk[mt], kf[2], kf[3]);
                }
            }
        }
    }

    uint32_t pf[MTW][NKS / 16][4];  // P as the A fragments of P.V, a k16 step per 16 keys
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
        float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
        for (int nb = 0; nb < NKS / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[mt][nb][e] * a.scale;
                if (mask) {
                    const int j = j0 + nb * 8 + 2 * t4 + (e & 1);
                    const int r = row0 + mt * 16 + g + (e < 2 ? 0 : 8);
                    const bool keep = mask == 1 ? j < kend : (j < a.t_q && j <= r / a.n_rep);
                    x = keep ? x : NEG_INF;
                }
                s[mt][nb][e] = x;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(s[mt][nb][0], s[mt][nb][1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[mt][nb][2], s[mt][nb][3]));
        }
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        st.m_lo[mt] = fmaxf(st.m_lo[mt], mx_lo);
        st.m_hi[mt] = fmaxf(st.m_hi[mt], mx_hi);
        const float ms_new_lo = fmaxf(st.m_lo[mt], M_CLAMP);
        const float ms_new_hi = fmaxf(st.m_hi[mt], M_CLAMP);
        const float alpha_lo = exp2f((st.ms_lo[mt] - ms_new_lo) * LOG2E);
        const float alpha_hi = exp2f((st.ms_hi[mt] - ms_new_hi) * LOG2E);
        st.ms_lo[mt] = ms_new_lo;
        st.ms_hi[mt] = ms_new_hi;
        st.l_lo[mt] *= alpha_lo;
        st.l_hi[mt] *= alpha_hi;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            st.acc[mt][j][0] *= alpha_lo;
            st.acc[mt][j][1] *= alpha_lo;
            st.acc[mt][j][2] *= alpha_hi;
            st.acc[mt][j][3] *= alpha_hi;
        }
        // P = exp(s - m_safe): f32 for the row sums, bf16 A fragments for P . V
        const float sh_lo = ms_new_lo * LOG2E;
        const float sh_hi = ms_new_hi * LOG2E;
#pragma unroll
        for (int nb = 0; nb < NKS / 8; ++nb) {
            const float p0 = exp2f(fmaf(s[mt][nb][0], LOG2E, -sh_lo));
            const float p1 = exp2f(fmaf(s[mt][nb][1], LOG2E, -sh_lo));
            const float p2 = exp2f(fmaf(s[mt][nb][2], LOG2E, -sh_hi));
            const float p3 = exp2f(fmaf(s[mt][nb][3], LOG2E, -sh_hi));
            st.l_lo[mt] += p0 + p1;
            st.l_hi[mt] += p2 + p3;
            pf[mt][nb / 2][(nb % 2) * 2] = ssi::pack_bf16(p0, p1);
            pf[mt][nb / 2][(nb % 2) * 2 + 1] = ssi::pack_bf16(p2, p3);
        }
    }

#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
#pragma unroll
        for (int j2 = 0; j2 < NKS / 16; ++j2) {
            uint32_t vf[4];
            ssi::ldmatrix_x4_trans(vf, v + swz<ROWS>(j0 + j2 * 16 + ((lane / 8) % 2) * 8 + lane % 8, dd * 2 + lane / 16));
#pragma unroll
            for (int mt = 0; mt < MTW; ++mt) {
                ssi::mma_bf16(st.acc[mt][2 * dd], pf[mt][j2], vf[0], vf[1]);
                ssi::mma_bf16(st.acc[mt][2 * dd + 1], pf[mt][j2], vf[2], vf[3]);
            }
        }
    }
}

// One block per (split and row group, kv head, slot); MT m16 tiles hold the
// row group's query rows. Warps 0-3 run the products; warp 4 (one lane)
// issues the page loads, so its page-table reads never stall the products.
// The body of the two kernels below, which differ only in their launch bounds.
template <int HD, int MT>
__device__ __forceinline__ void paged_hopper_body(const Args& a, const CUtensorMap& kmap, const CUtensorMap& vmap) {
    using W = WarpSplit<HD, MT>;
    constexpr int ST = STAGES;
    constexpr int PIECES = HD / 8;  // 16-byte pieces of a row
    extern __shared__ unsigned char smem_raw[];
    PagedSmem<HD, MT>& sm = *reinterpret_cast<PagedSmem<HD, MT>*>(hw::align1024(smem_raw));

    const int split = blockIdx.x % a.n_splits;
    const int rbase = blockIdx.x / a.n_splits * GROUP_ROWS;  // this block's row group: rows rbase ..
    const int nrows = min(GROUP_ROWS, a.rows - rbase);       // .. rbase + nrows - 1 of the R
    const int kvh = blockIdx.y;
    const int slot = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int kw = warp % W::KW;                   // this warp's key slice (warps 0-3)
    const int row0 = (warp / W::KW) * W::MTW * 16;  // its first query row
    const int* pt = a.page_table + (long long)slot * a.max_pages;

    // Reads that need no history length are issued before the block learns
    // it (the latencies overlap): Q rows into shared memory (zero past R);
    // the in-flight K/V rows (zero past T) and their write rows into
    // registers; the split's first page-table entry (the producer).
    constexpr int IN_PER = IN_ROWS * PIECES / CONSUMERS;  // in-flight 16-byte pieces a thread holds
    uint4 kin[IN_PER], vin[IN_PER];
    int wrow[IN_PER];
    int first_page = 0;
    if (warp < WARPS) {
        const bf16* qb = static_cast<const bf16*>(a.q);
        for (int idx = tid; idx < 16 * MT * PIECES; idx += CONSUMERS) {
            const int i = idx / PIECES;
            const int c = (idx % PIECES) * 8;
            uint4 x = make_uint4(0, 0, 0, 0);  // rows past the group and columns past hd: zeros
            if (i < nrows && c < a.hd) x = *reinterpret_cast<const uint4*>(qb + q_index(a, slot, rbase + i) + c);
            *reinterpret_cast<uint4*>(&sm.qi.q[i][c]) = x;
        }
        const long long new_base = ((long long)slot * a.t_q * a.Hkv + kvh) * a.hd;
#pragma unroll
        for (int i = 0; i < IN_PER; ++i) {
            const int idx = tid + i * CONSUMERS;
            const int j = idx / PIECES;
            kin[i] = vin[i] = make_uint4(0, 0, 0, 0);
            wrow[i] = a.trash;  // no write: no token, or a piece past hd
            if (j < a.t_q && (idx % PIECES) * 8 < a.hd) {
                const long long off = new_base + (long long)j * a.Hkv * a.hd + (idx % PIECES) * 8;
                kin[i] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.k_new) + off);
                vin[i] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.v_new) + off);
                wrow[i] = a.write_rows[slot * a.t_q + j];
            }
        }
    } else if (lane == 0) {
        first_page = pt[split * a.split_keys / a.ps];
    }
    if (tid == CONSUMERS) {
        for (int s = 0; s < ST; ++s) {
            hw::mbar_init(&sm.full[s], 1);
            hw::mbar_init(&sm.empty[s], WARPS);
        }
        hw::fence_barrier_init();
    }
    const Span sp = span_of<BK<HD>>(a, slot, split);
    if (split >= sp.n_live) return;

    // The last split (of row group 0) writes the in-flight tokens into their
    // cells first: positions >= hist_len, which only the last split's own last
    // box may cover (masked, in every row group).
    if (sp.last && rbase == 0 && warp < WARPS) {
        const long long kvd = (long long)a.Hkv * a.hd;
#pragma unroll
        for (int i = 0; i < IN_PER; ++i) {
            const int idx = tid + i * CONSUMERS;
            const int j = idx / PIECES;
            if (j < a.t_q && wrow[i] != a.trash) {
                const int off = ((sp.hist_raw + j) % a.ps + a.ps) % a.ps;
                const long long dst = ((long long)wrow[i] * a.ps + off) * kvd + (long long)kvh * a.hd + (idx % PIECES) * 8;
                *reinterpret_cast<uint4*>(static_cast<bf16*>(a.k_pool) + dst) = kin[i];
                *reinterpret_cast<uint4*>(static_cast<bf16*>(a.v_pool) + dst) = vin[i];
            }
        }
    }
    if constexpr (!Q_IN_REGS<HD>) {  // the in-flight tile has its own bytes: store it now, not after the loop
        if (sp.last && warp < WARPS) {
#pragma unroll
            for (int i = 0; i < IN_PER; ++i) {
                const int idx = tid + i * CONSUMERS;
                const uint32_t off = swz<IN_ROWS>(idx / PIECES, idx % PIECES);
                *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(sm.qi.in.k) + off) = kin[i];
                *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(sm.qi.in.v) + off) = vin[i];
            }
        }
    }
    __syncthreads();

    RowState<HD, W::MTW> rs;
    if (warp == WARPS) {
        // the producer: history tile t of this split into ring stage t % ST once
        // the 4 warps have released it: a box per `a.box` keys that hold
        // history, per 64 columns, K and V; the rows past the last box keep an
        // earlier tile's bytes
        if (lane == 0) {
            for (int t = 0; t < sp.n_hist_tiles; ++t) {
                const int st = t % ST;
                if (t >= ST) hw::mbar_wait(&sm.empty[st], (t / ST + 1) & 1);
                const int key0 = sp.k0 + t * BK<HD>;
                const int boxes = (min(BK<HD>, sp.k1 - key0) + a.box - 1) / a.box;
                hw::mbar_expect_tx(&sm.full[st], boxes * a.box * HD * 2 * 2);
                for (int b = 0; b < boxes; ++b) {
                    const int key = key0 + b * a.box;
                    const int page = key - sp.k0 < a.ps ? first_page : pt[key / a.ps];
                    const int row = page * a.ps + key % a.ps;
#pragma unroll
                    for (int h = 0; h < HD / 64; ++h) {
                        const int dst = h * BK<HD> * 64 + b * a.box * 64;
                        hw::tma_load_3d(&sm.ring.k[st][dst], &kmap, &sm.full[st], h * 64, kvh, row);
                        hw::tma_load_3d(&sm.ring.v[st][dst], &vmap, &sm.full[st], h * 64, kvh, row);
                    }
                }
            }
        }
    } else {
        QFrags<HD, W::MTW> qf;  // Q's A fragments
        if constexpr (Q_IN_REGS<HD>) {
#pragma unroll
            for (int mt = 0; mt < W::MTW; ++mt)
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    ssi::ldmatrix_x4(qf.f[mt][kk], &sm.qi.q[row0 + mt * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
        } else {
            qf.q = &sm.qi.q[row0];
        }

#pragma unroll
        for (int mt = 0; mt < W::MTW; ++mt) {
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                rs.acc[mt][j][0] = rs.acc[mt][j][1] = rs.acc[mt][j][2] = rs.acc[mt][j][3] = 0.f;
            rs.m_lo[mt] = rs.m_hi[mt] = NEG_INF;
            rs.ms_lo[mt] = rs.ms_hi[mt] = M_CLAMP;
            rs.l_lo[mt] = rs.l_hi[mt] = 0.f;
        }

        for (int it = 0; it < sp.n_hist_tiles; ++it) {
            const int st = it % ST;
            hw::mbar_wait(&sm.full[st], (it / ST) & 1);
            const int kend = sp.k1 - (sp.k0 + it * BK<HD>);  // history keys in this tile
            unsigned char* kt = reinterpret_cast<unsigned char*>(sm.ring.k[st]);
            unsigned char* vt = reinterpret_cast<unsigned char*>(sm.ring.v[st]);
            if (kend < BK<HD>) {  // the ragged last tile (never refilled): V rows past the history to zero
                for (int idx = tid; idx < (BK<HD> - kend) * PIECES; idx += CONSUMERS)
                    *reinterpret_cast<uint4*>(vt + swz<BK<HD>>(kend + idx / PIECES, idx % PIECES)) =
                        make_uint4(0, 0, 0, 0);
                hw::named_sync(1, CONSUMERS);
            }
            if (kw * W::NK < kend)  // else every key of this warp's slice is past the history
                attend<HD, W::MTW, W::NK, BK<HD>>(rs, qf, kt, vt, kw * W::NK, kend < BK<HD> ? 1 : 0, kend,
                                                  rbase + row0, a);
            __syncwarp();
            if (lane == 0) hw::mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
        }
        if (sp.last) {  // the in-flight tokens, a 16-key tile of key slice 0
            if constexpr (Q_IN_REGS<HD>) {
                hw::named_sync(1, CONSUMERS);  // Q's bytes are free
#pragma unroll
                for (int i = 0; i < IN_PER; ++i) {
                    const int idx = tid + i * CONSUMERS;
                    const uint32_t off = swz<IN_ROWS>(idx / PIECES, idx % PIECES);
                    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(sm.qi.in.k) + off) = kin[i];
                    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(sm.qi.in.v) + off) = vin[i];
                }
                hw::named_sync(1, CONSUMERS);
            }
            if (kw == 0)
                attend<HD, W::MTW, IN_ROWS, IN_ROWS>(rs, qf, reinterpret_cast<const unsigned char*>(sm.qi.in.k),
                                                     reinterpret_cast<const unsigned char*>(sm.qi.in.v), 0, 2, 0,
                                                     rbase + row0, a);
        }
    }
    __syncthreads();  // the ring's bytes are free for the combine

    // each key slice's state (m_safe, row sum, O) into shared memory
    auto& cb = sm.cb;
    if (warp < WARPS) {
#pragma unroll
        for (int mt = 0; mt < W::MTW; ++mt) {
            float l_lo = rs.l_lo[mt], l_hi = rs.l_hi[mt];
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
            const int i_lo = row0 + mt * 16 + g;
            const int i_hi = i_lo + 8;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                *reinterpret_cast<float2*>(&cb.o[kw][i_lo][j * 8 + 2 * t4]) =
                    make_float2(rs.acc[mt][j][0], rs.acc[mt][j][1]);
                *reinterpret_cast<float2*>(&cb.o[kw][i_hi][j * 8 + 2 * t4]) =
                    make_float2(rs.acc[mt][j][2], rs.acc[mt][j][3]);
            }
            if (t4 == 0) {
                cb.m[kw][i_lo] = rs.ms_lo[mt];
                cb.l[kw][i_lo] = l_lo;
                cb.m[kw][i_hi] = rs.ms_hi[mt];
                cb.l[kw][i_hi] = l_hi;
            }
        }
    }
    __syncthreads();

    // the key slices combined in slice order; one thread per (row, 4 dims):
    // the output itself when one split holds the history, else this split's part
    const bool direct = sp.n_live == 1;
    bf16* out = static_cast<bf16*>(a.out);
    for (int idx = tid; idx < nrows * (HD / 4); idx += BF16_THREADS) {
        const int i = idx / (HD / 4);
        const int d = (idx % (HD / 4)) * 4;
        if (d >= a.hd) continue;
        float m = cb.m[0][i];
#pragma unroll
        for (int w = 1; w < W::KW; ++w) m = fmaxf(m, cb.m[w][i]);
        float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
        for (int w = 0; w < W::KW; ++w) {
            const float wt = exp2f((cb.m[w][i] - m) * LOG2E);
            const float4 o = *reinterpret_cast<const float4*>(&cb.o[w][i][d]);
            l = fmaf(cb.l[w][i], wt, l);
            o0 = fmaf(o.x, wt, o0);
            o1 = fmaf(o.y, wt, o1);
            o2 = fmaf(o.z, wt, o2);
            o3 = fmaf(o.w, wt, o3);
        }
        if (direct) {
            const float ls = fmaxf(l, 1e-30f);
            store4(out + q_index(a, slot, rbase + i) + d, o0 / ls, o1 / ls, o2 / ls, o3 / ls);
        } else {
            store4(part_o(a, slot, split, rbase + i) + d, o0, o1, o2, o3);
            if (d == 0) *reinterpret_cast<float2*>(part_ml(a, slot, split, rbase + i)) = make_float2(m, l);
        }
    }

    if (!direct) {
        // count this split's arrival once its part is visible to the whole card;
        // the last to arrive merges the slot's live splits in split order (a
        // counter per row group: each group's splits merge its own rows)
        __threadfence();
        __syncthreads();
        int* count = a.counters + ((long long)slot * a.Hkv + kvh) * a.groups + rbase / GROUP_ROWS;
        if (tid == 0) sm.merge = atomicAdd(count, 1) == sp.n_live - 1;
        __syncthreads();
        if (sm.merge) {
            __threadfence();
            if (tid == 0) *count = 0;  // every split has arrived: zero for the next call
            for (int idx = tid; idx < nrows * (HD / 4); idx += BF16_THREADS) {
                const int r = rbase + idx / (HD / 4);
                const int d = (idx % (HD / 4)) * 4;
                if (d >= a.hd) continue;
                float m = NEG_INF;
                for (int s = 0; s < sp.n_live; ++s) m = fmaxf(m, __ldcg(part_ml(a, slot, s, r)));
                float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
                for (int s = 0; s < sp.n_live; ++s) {
                    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml(a, slot, s, r)));
                    const float wt = exp2f((ml.x - m) * LOG2E);
                    const float4 o = __ldcg(reinterpret_cast<const float4*>(part_o(a, slot, s, r) + d));
                    l = fmaf(ml.y, wt, l);
                    o0 = fmaf(o.x, wt, o0);
                    o1 = fmaf(o.y, wt, o1);
                    o2 = fmaf(o.z, wt, o2);
                    o3 = fmaf(o.w, wt, o3);
                }
                const float ls = fmaxf(l, 1e-30f);
                store4(out + q_index(a, slot, r) + d, o0 / ls, o1 / ls, o2 / ls, o3 / ls);
            }
        }
    }
}

template <int HD, int MT>
__global__ void __launch_bounds__(BF16_THREADS) paged_hopper_kernel(const __grid_constant__ Args a,
                                                                    const __grid_constant__ CUtensorMap kmap,
                                                                    const __grid_constant__ CUtensorMap vmap) {
    paged_hopper_body<HD, MT>(a, kmap, vmap);
}

// The hd-64 two-tile instance (#9 at T 8 at 1B: 32 rows), its registers held
// to two blocks an SM (166, 64 bytes spilled): left to itself ptxas gives it
// 220, one block an SM, and #9 at T 8 read 1.3x slower. A minimum of blocks on
// the other instances moved their registers too (a floor of 3 on the hd-64
// one-tile instance spilled; one of 1 gave the hd-128 two-tile instance 212,
// and #8/#9 at hd 128 read 6-17% slower), so they keep the plain bound.
template <int HD, int MT>
__global__ void __launch_bounds__(BF16_THREADS, 2) paged_hopper_2blocks_kernel(const __grid_constant__ Args a,
                                                                               const __grid_constant__ CUtensorMap kmap,
                                                                               const __grid_constant__ CUtensorMap vmap) {
    paged_hopper_body<HD, MT>(a, kmap, vmap);
}

template <int HD, int MT>
cudaError_t launch_bf16(const Args& a, const CUtensorMap& kmap, const CUtensorMap& vmap, cudaStream_t st) {
    static int allowed = 0;
    const int smem = (int)sizeof(PagedSmem<HD, MT>) + 1024;  // + the slack to align the ring to 1024 bytes
    const auto kernel = [] {  // only the chosen kernel is instantiated
        if constexpr (HD == 64 && MT == 2)
            return paged_hopper_2blocks_kernel<HD, MT>;
        else
            return paged_hopper_kernel<HD, MT>;
    }();
    const cudaError_t err = ssi::allow_dynamic_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(a.n_splits * a.groups, a.Hkv, a.n_slots), BF16_THREADS, smem, st>>>(a, kmap, vmap);
    return cudaGetLastError();
}

// the bf16 kernel at instance HD: its checks, then the instance for the rows a block holds
template <int HD>
cudaError_t launch_tma(const Args& a, const void* k_map, const void* v_map, cudaStream_t st) {
    // 16-byte loads of q and the in-flight rows; TMA needs the pools 16-byte aligned
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k_pool) |
                           reinterpret_cast<uintptr_t>(a.v_pool) | reinterpret_cast<uintptr_t>(a.k_new) |
                           reinterpret_cast<uintptr_t>(a.v_new) | reinterpret_cast<uintptr_t>(a.part);
    if (ptrs % 16 != 0 || k_map == nullptr || v_map == nullptr || (a.n_splits > 1 && a.counters == nullptr) ||
        a.box < 8 || a.box > BK<HD> || (a.box & (a.box - 1)) != 0 || a.ps % a.box != 0)
        return cudaErrorInvalidValue;
    CUtensorMap kmap, vmap;  // the wrapper's encoded maps (ssi_paged_pool_map), 128 bytes each
    std::memcpy(&kmap, k_map, sizeof kmap);
    std::memcpy(&vmap, v_map, sizeof vmap);
    const int rows = std::min(a.rows, GROUP_ROWS);  // a block's: one row group
    return rows <= 16   ? launch_bf16<HD, 1>(a, kmap, vmap, st)
           : rows <= 32 ? launch_bf16<HD, 2>(a, kmap, vmap, st)
                        : launch_bf16<HD, 4>(a, kmap, vmap, st);
}

cudaError_t launch(int dtype, const Args& a, const void* k_map, const void* v_map, cudaStream_t st) {
    if (a.Hkv <= 0 || a.n_rep <= 0 || a.t_q < 1 || a.t_q > MAX_T || a.hd <= 0 || a.hd > 256 || a.ps <= 0 ||
        a.ps % 8 != 0 || a.max_pages <= 0 || a.n_slots <= 0 || a.split_keys <= 0 || a.split_keys % a.ps != 0 ||
        a.n_splits <= 0 || (long long)(a.n_splits - 1) * a.split_keys >= (long long)a.max_pages * a.ps ||
        (long long)a.n_splits * a.split_keys < (long long)a.max_pages * a.ps)
        return cudaErrorInvalidValue;
    // f32, and rows that TMA cannot describe (hd not a multiple of 8): the plain-load kernels
    if (dtype != ssi::kBFloat16 || a.hd % 8 != 0) return launch_plain(dtype, a, st);
    // the hd-64 instance up to 64 columns, the hd-128 one up to 128, the hd-256 one above
    return a.hd <= 64    ? launch_tma<64>(a, k_map, v_map, st)
           : a.hd <= 128 ? launch_tma<128>(a, k_map, v_map, st)
                         : launch_tma<256>(a, k_map, v_map, st);
}

Args make_args(const void* q, void* k_pool, void* v_pool, const void* page_table, const void* lens,
               const void* k_new, const void* v_new, const void* write_rows, void* out, void* part, void* counters,
               int n_slots, int t_q, int Hq, int Hkv, int hd, int ps, int max_pages, int pages_per_split,
               int n_splits, int box, float scale) {
    Args a;
    a.q = q;
    a.k_pool = k_pool;
    a.v_pool = v_pool;
    a.page_table = static_cast<const int*>(page_table);
    a.lens = static_cast<const int*>(lens);
    a.k_new = k_new;
    a.v_new = v_new;
    a.write_rows = static_cast<const int*>(write_rows);
    a.out = out;
    a.part = static_cast<float*>(part);
    a.counters = static_cast<int*>(counters);
    a.lens_shift = 0;
    a.trash = -1;
    a.n_slots = n_slots;
    a.t_q = t_q;
    a.Hkv = Hkv;
    a.n_rep = Hkv > 0 ? Hq / Hkv : 0;
    a.hd = hd;
    a.ps = ps;
    a.max_pages = max_pages;
    a.split_keys = pages_per_split * ps;
    a.n_splits = n_splits;
    a.rows = t_q * a.n_rep;
    a.groups = (a.rows + GROUP_ROWS - 1) / GROUP_ROWS;
    a.box = box;
    a.scale = scale;
    return a;
}

}  // namespace

// The tensor map of a bf16 pool [rows, ps, Hkv * hd] as the bf16 kernel reads
// it: a 3D [n_rows = rows * ps, Hkv, hd] tensor in boxes of `box` keys by one
// kv head by 64 columns, 128-byte swizzled (a box's columns past hd are
// zeros, never the next head's), written into `map` (128 bytes; the wrapper
// caches it per pool pointer and shape). hd: a multiple of 8 (16-byte strides).
extern "C" int ssi_paged_pool_map(void* map, const void* pool, long long n_rows, int Hkv, int hd, int box) {
    static_assert(sizeof(CUtensorMap) == 128, "the wrapper holds 128-byte tensor maps");
    if (Hkv <= 0 || hd <= 0 || hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap m;
    const cudaError_t err = hw::map_rows_heads(&m, pool, n_rows, Hkv, hd, box);
    if (err == cudaSuccess) std::memcpy(map, &m, sizeof m);
    return static_cast<int>(err);
}

// #8: one token per slot; seq_lens counts it. hd: head_dim, at most 256 (one
// that is not a multiple of 8 on the plain-load kernels, no tensor maps). `part`: the split scratch, n_slots * Hkv * n_splits * n_rep
// * (hd + 2) floats (unused when n_splits is 1); `counters`: n_slots * Hkv *
// ceil(n_rep / 64) ints, zero (bf16; every launch leaves them zero); k_map /
// v_map: the pools' tensor maps (bf16, hd a multiple of 8), in boxes of `box` keys.
extern "C" int ssi_paged_attention_fused(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* seq_lens,
    const void* k_new, const void* v_new, const void* write_rows, void* out, void* part, void* counters,
    const void* k_map, const void* v_map, int n_slots, int Hq, int Hkv, int hd, int ps, int max_pages,
    int pages_per_split, int n_splits, int box, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    Args a = make_args(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows, out, part, counters,
                       n_slots, 1, Hq, Hkv, hd, ps, max_pages, pages_per_split, n_splits, box, scale);
    a.lens_shift = -1;
    return static_cast<int>(launch(dtype, a, k_map, v_map, static_cast<cudaStream_t>(stream)));
}

// #9: T tokens per slot after hist_lens resident ones; a write row equal to
// `trash` is skipped. `part`: n_slots * Hkv * n_splits * T * n_rep * (hd + 2)
// floats; `counters`: n_slots * Hkv * ceil(T * n_rep / 64) ints; the rest as
// #8.
extern "C" int ssi_paged_attention_multi(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* hist_lens,
    const void* k_new, const void* v_new, const void* write_rows, void* out, void* part, void* counters,
    const void* k_map, const void* v_map, int n_slots, int t_q, int Hq, int Hkv, int hd, int ps, int max_pages,
    int trash, int pages_per_split, int n_splits, int box, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    Args a = make_args(q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows, out, part, counters,
                       n_slots, t_q, Hq, Hkv, hd, ps, max_pages, pages_per_split, n_splits, box, scale);
    a.trash = trash;
    return static_cast<int>(launch(dtype, a, k_map, v_map, static_cast<cudaStream_t>(stream)));
}
