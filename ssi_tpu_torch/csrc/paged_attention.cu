// Paged attention over the flat KV pool, split across the context: the fused
// single-token decode (kernel #8) and the T-token write + verify of
// speculative decoding (kernel #9) on one core. head_dim 64 (the 100m and
// 1B models) or 128 (3B and 8B), any GQA ratio n_rep with T * n_rep <= 64,
// f32 or bf16 storage.
//
// Replaces the TPU kernels ssi_tpu/generate/paged_pallas.py
// `paged_attention_pallas` -> `_kernel` and `paged_attention_pallas_multi`
// -> `_kernel_multi`. Semantics kept: the pools are [L*n_pages + 1,
// page_size, Hkv*HD] (head-flattened rows, trash row last), updated in place
// (torch tensors are mutable, so the TPU kernels' input_output_aliases has no
// counterpart); `page_table` [slots, max_pages] holds PHYSICAL rows; q
// [slots, T, Hq, HD] is unscaled and scaled here by `scale`; the history is
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
// which the tensor cores would bound it). So the design is about keeping
// enough bytes in flight on every SM:
// - the context is split: one block per (split, kv head, slot), each split
//   walking `split_keys` keys (a whole number of pages; the wrapper's split
//   plan). At the 1B serving shape (32 slots, 8 kv heads, context 1,280,
//   256-key splits) that is 1,280 blocks, several resident on every SM,
//   where one block per (slot, kv head) gave 256. Splits past a slot's
//   history exit at once;
// - each block streams its keys in 64-key tiles (16 KB of K and V in bf16)
//   through a cp.async ring of STAGES stages: the next tiles load while
//   tile i is used. A page of the pool is one contiguous [ps, Hkv*HD] slab
//   and this kv head's stripe of it is ps rows of 2 * HD bytes (bf16), so
//   HD / 8 threads move one key's K row and as many its V row, 16 bytes
//   each;
// - bf16: S = Q.K^T and P.V run on mma.sync m16n8k16 (csrc/mma.cuh) with f32
//   accumulators. The R = T * n_rep query rows of the kv head are one or two
//   m16 tiles (R 4 at #8's n_rep 4, padded with zero rows; 16 at T 4; 32 at
//   T 8); R above 32 takes two row groups of blocks, each reading the pages.
//   Row r is in-flight token r / n_rep of q head r % n_rep, whatever n_rep
//   divides (3B's n_rep 3 gives R 3 at T 1 and 12 at T 4, one m16 tile
//   with padding rows that are computed and never stored).
//   At head_dim 128 a block holds one m16 tile (BLOCK_ROWS 16: R above 16
//   takes more row groups), so Q's fragments and the [16 x 128] f32 sum stay
//   within the registers a thread has, and the Q tile and the 2-stage K/V
//   ring (72 KB, past the 48 KB static limit) live in dynamic shared memory;
//   Each of the 4 warps takes 16 keys of every tile and runs its own online
//   softmax over them, so the tile loop needs no exchange between warps; the
//   four partial states are combined once, at the end, in warp order. As in
//   the flash forward, scores are scaled and masked in f32 (masked: -1e30,
//   with the m_safe clamp), the row sums add the f32 probabilities, and P is
//   cast to bf16 for P.V;
// - f32 (the parity path): the same split and merge with scalar FMAs, one
//   block of 128 threads holding all R rows, K and V staged as f32.
//
// Merge: the split that holds the slot's last history key (split 0 when the
// history is empty) also folds in the in-flight tokens and does the token
// writes. A slot whose history fits in one split is finished by that split,
// which writes the normalised output itself. Otherwise each split writes its
// unnormalised state to the scratch `part` (allocated by the wrapper; the
// kernels allocate nothing):
//   o  [slots, Hkv, n_splits, R, HD] f32: sum over the split's keys of
//      exp(s - m) * v;
//   ml [slots, Hkv, n_splits, R, 2]  f32: (m, sum of exp(s - m)),
// the ml block following the o block. Its size is bounded by the wrapper's
// cap on n_splits: a long context gives each split more pages, not more
// splits. The merge kernel (launched from the same C entry point, right
// after) combines a slot's live splits in split order: no atomics, so two
// launches give the same bits.
//
// No block reads what another writes: the token writes land at positions
// >= hist_len of their own slot, in their own kv head's columns, and no split
// of the launch reads a position >= hist_len (a page shared through the
// prefix cache holds prompt positions <= p-2 only and is never a write
// target). In every kernel here blockIdx.y is the kv head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;          // keys per tile
constexpr int MAX_T = 8;        // in-flight tokens per slot
constexpr int MAX_ROWS = 64;    // T * n_rep
// query rows one bf16 block holds: two m16 tiles at head_dim 64, one at 128
template <int HD>
constexpr int BLOCK_ROWS = HD == 64 ? 32 : 16;
constexpr float NEG_INF = -1.0e30f;
constexpr float M_CLAMP = -0.5e30f;  // m_safe = max(m, M_CLAMP)
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Args {
    const void* q;           // [slots, T, Hq, HD]
    void* k_pool;            // [rows, ps, Hkv*HD], written in place
    void* v_pool;
    const int* page_table;   // [slots, max_pages] physical rows
    const int* lens;         // [slots]: hist_len = lens + lens_shift
    const void* k_new;       // [slots, T, Hkv, HD]
    const void* v_new;
    const int* write_rows;   // [slots, T]
    void* out;               // [slots, T, Hq, HD]
    float* part;             // the split scratch (see the top of the file)
    int lens_shift;          // -1 (#8: seq_lens counts the incoming token) or 0 (#9)
    int trash;               // a write row equal to it is skipped; -1: none is (#8)
    int n_slots, t_q, Hkv, n_rep, ps, max_pages;
    int split_keys;          // keys per split (pages per split * ps)
    int n_splits;            // splits per (slot, kv head)
    int rows;                // R = t_q * n_rep
    float scale;
};

struct Span {  // what one split block of one slot covers
    int hist_raw;  // lens + lens_shift, unclamped (the write offsets use it)
    int n_live;    // splits holding history keys (1 when the history is empty)
    bool last;     // this split folds in the in-flight tokens and writes them
    int k0, k1;    // history keys [k0, k1)
    int n_hist_tiles;
};

__device__ __forceinline__ int live_splits(const Args& a, int hist) {
    return hist > 0 ? (hist - 1) / a.split_keys + 1 : 1;
}

__device__ __forceinline__ int clamp_hist(const Args& a, int hist_raw) {
    return min(max(hist_raw, 0), a.max_pages * a.ps);
}

__device__ __forceinline__ Span span_of(const Args& a, int slot, int split) {
    Span s;
    s.hist_raw = a.lens[slot] + a.lens_shift;
    const int hist = clamp_hist(a, s.hist_raw);
    s.n_live = live_splits(a, hist);
    s.last = split == s.n_live - 1;
    s.k0 = split * a.split_keys;
    s.k1 = min(hist, s.k0 + a.split_keys);
    s.n_hist_tiles = s.k1 > s.k0 ? (s.k1 - s.k0 + TK - 1) / TK : 0;
    return s;
}

template <int HD>
__device__ __forceinline__ long long q_index(const Args& a, int slot, int r) {
    const int Hq = a.Hkv * a.n_rep;
    return (((long long)slot * a.t_q + r / a.n_rep) * Hq + (long long)blockIdx.y * a.n_rep + r % a.n_rep) * HD;
}

template <int HD>
__device__ __forceinline__ float* part_o(const Args& a, int slot, int split, int r) {
    return a.part + ((((long long)slot * a.Hkv + blockIdx.y) * a.n_splits + split) * a.rows + r) * HD;
}

template <int HD>
__device__ __forceinline__ float* part_ml(const Args& a, int slot, int split, int r) {
    const long long o_size = (long long)a.n_slots * a.Hkv * a.n_splits * a.rows * HD;
    return a.part + o_size + ((((long long)slot * a.Hkv + blockIdx.y) * a.n_splits + split) * a.rows + r) * 2;
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float x, float y, float z, float w);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float x, float y, float z, float w) {
    *reinterpret_cast<float4*>(dst) = make_float4(x, y, z, w);
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* dst, float x, float y, float z, float w) {
    reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(x, y);
    reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(z, w);
}

// The in-flight tokens' K/V into their cells: this kv head's stripe of each
// token's row (positions >= hist_len, which no split reads).
template <typename T, int HD>
__device__ void write_tokens(const Args& a, int slot, int hist_raw) {
    const int kvh = blockIdx.y;
    const long long kvd = (long long)a.Hkv * HD;
    for (int idx = threadIdx.x; idx < a.t_q * HD; idx += THREADS) {
        const int t = idx / HD;
        const int d = idx % HD;
        const int row = a.write_rows[slot * a.t_q + t];
        if (row == a.trash) continue;
        const int off = ((hist_raw + t) % a.ps + a.ps) % a.ps;
        const long long dst = ((long long)row * a.ps + off) * kvd + kvh * HD + d;
        const long long src = (((long long)slot * a.t_q + t) * a.Hkv + kvh) * HD + d;
        static_cast<T*>(a.k_pool)[dst] = static_cast<const T*>(a.k_new)[src];
        static_cast<T*>(a.v_pool)[dst] = static_cast<const T*>(a.v_new)[src];
    }
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int STAGES = 2;  // a third stage bought a few percent at T 1 and nothing at T 8 on an H100

template <int HD, int MT>
struct Bf16Tiles {
    bf16 q[16 * MT][ssi::lds<HD>];  // rows padded to 144 (HD 64) or 272 (HD 128) bytes
    bf16 k[STAGES][TK][ssi::lds<HD>];
    bf16 v[STAGES][TK][ssi::lds<HD>];
};

// after the key loop the same bytes hold each warp's partial state
template <int HD, int MT>
struct Bf16Combine {
    float o[WARPS][16 * MT][HD + 4];  // f32 rows padded by 4
    float m[WARPS][16 * MT];
    float l[WARPS][16 * MT];
};

template <int HD, int MT>
struct Bf16Smem {
    union {
        Bf16Tiles<HD, MT> tiles;
        Bf16Combine<HD, MT> combine;
    };
};

// MT: m16 tiles of query rows per block (rows r0 .. r0 + 16*MT of R; the
// grid's z is slot * row_groups + row group)
template <int HD, int MT>
__global__ void __launch_bounds__(THREADS) paged_split_bf16_kernel(Args a, int row_groups) {
    // under 48 KB at head_dim 64: static; 72 KB at 128: dynamic
    Bf16Smem<HD, MT>& smem = ssi::block_tiles<Bf16Smem<HD, MT>, HD == 64>();
    auto& sm = smem.tiles;
    auto& cb = smem.combine;

    const int split = blockIdx.x;
    const int kvh = blockIdx.y;
    const int slot = blockIdx.z / row_groups;
    const int r0 = (blockIdx.z % row_groups) * BLOCK_ROWS<HD>;
    const Span sp = span_of(a, slot, split);
    if (split >= sp.n_live) return;
    const int nr = min(16 * MT, a.rows - r0);  // real query rows of this block
    const int n_tiles = sp.n_hist_tiles + (sp.last ? 1 : 0);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const long long kvd = (long long)a.Hkv * HD;
    const int* pt = a.page_table + (long long)slot * a.max_pages;
    const bf16* qb = static_cast<const bf16*>(a.q);
    const bf16* kp = static_cast<const bf16*>(a.k_pool) + kvh * HD;
    const bf16* vp = static_cast<const bf16*>(a.v_pool) + kvh * HD;
    const long long new_base = ((long long)slot * a.t_q * a.Hkv + kvh) * HD;
    const bf16* kn = static_cast<const bf16*>(a.k_new) + new_base;
    const bf16* vn = static_cast<const bf16*>(a.v_new) + new_base;

    // Q rows (zero past the block's real rows), with tile 0 in one copy group
    constexpr int PIECES = HD / 8;  // 16-byte pieces of a row
    for (int idx = tid; idx < 16 * MT * PIECES; idx += THREADS) {
        const int i = idx / PIECES;
        const int c = (idx % PIECES) * 8;
        const bool in = i < nr;
        ssi::cp_async16(&sm.q[i][c], in ? qb + q_index<HD>(a, slot, r0 + i) + c : qb, in ? 16 : 0);
    }
    // tile `tile` of this split into ring stage `st`: history keys from the
    // pages, or the in-flight tokens; keys that do not exist are zero-filled
    // (they are masked, and a zero V row keeps 0 * garbage out of P.V)
    auto load_tile = [&](int st, int tile) {
        const bool inflight = tile == sp.n_hist_tiles;
        const int key0 = sp.k0 + tile * TK;
#pragma unroll
        for (int i = 0; i < TK * PIECES / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int j = idx / PIECES;
            const int c = (idx % PIECES) * 8;
            long long off = 0;
            bool in;
            const bf16 *ks = kp, *vs = vp;
            if (inflight) {
                in = j < a.t_q;
                if (in) {
                    off = (long long)j * a.Hkv * HD + c;
                    ks = kn;
                    vs = vn;
                }
            } else {
                const int key = key0 + j;
                in = key < sp.k1;
                if (in) off = ((long long)pt[key / a.ps] * a.ps + key % a.ps) * kvd + c;
            }
            ssi::cp_async16(&sm.k[st][j][c], ks + off, in ? 16 : 0);
            ssi::cp_async16(&sm.v[st][j][c], vs + off, in ? 16 : 0);
        }
    };
    // the ring's first STAGES - 1 tiles, one copy group each (Q joins tile 0's)
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n_tiles) load_tile(i, i);
        ssi::cp_async_commit();
    }

    uint32_t qf[MT][HD / 16][4];  // Q's A fragments
    float acc[MT][HD / 8][4];     // this warp's O over its keys: [16 x HD] per m tile
    float m_lo[MT], m_hi[MT], ms_lo[MT], ms_hi[MT], l_lo[MT], l_hi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
        m_lo[mt] = m_hi[mt] = NEG_INF;
        ms_lo[mt] = ms_hi[mt] = M_CLAMP;
        l_lo[mt] = l_hi[mt] = 0.f;
    }

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        const int ahead = it + STAGES - 1;
        if (ahead < n_tiles) load_tile(ahead % STAGES, ahead);  // loads while this tile is used
        ssi::cp_async_commit();
        ssi::cp_async_wait<STAGES - 1>();  // Q and this tile have landed
        __syncthreads();
        if (it == 0) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
                    ssi::ldmatrix_x4(qf[mt][kk], &sm.q[mt * 16 + lane % 16][kk * 16 + (lane / 16) * 8]);
        }
        const bool inflight = it == sp.n_hist_tiles;

        // S = Q . K^T over this warp's 16 keys of the tile
        float s[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t kf[4];
            ssi::ldmatrix_x4(kf, &sm.k[st][warp * 16 + (lane / 16) * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ssi::mma_bf16(s[mt][0], qf[mt][kk], kf[0], kf[1]);
                ssi::mma_bf16(s[mt][1], qf[mt][kk], kf[2], kf[3]);
            }
        }

        // scale; mask the ragged last history tile and the in-flight tile
        // (key j of it is token j: row r sees it when j <= r's token)
        const bool need_mask = inflight || it == sp.n_hist_tiles - 1;
        const int kend = sp.k1 - (sp.k0 + it * TK);  // history keys of this tile
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[mt][nb][e] * a.scale;
                    if (need_mask) {
                        const int j = warp * 16 + nb * 8 + 2 * t4 + (e & 1);
                        const int r = r0 + mt * 16 + g + (e < 2 ? 0 : 8);
                        const bool keep = inflight ? (j < a.t_q && j <= r / a.n_rep) : j < kend;
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
            m_lo[mt] = fmaxf(m_lo[mt], mx_lo);
            m_hi[mt] = fmaxf(m_hi[mt], mx_hi);
            const float ms_new_lo = fmaxf(m_lo[mt], M_CLAMP);
            const float ms_new_hi = fmaxf(m_hi[mt], M_CLAMP);
            const float alpha_lo = exp2f((ms_lo[mt] - ms_new_lo) * LOG2E);
            const float alpha_hi = exp2f((ms_hi[mt] - ms_new_hi) * LOG2E);
            ms_lo[mt] = ms_new_lo;
            ms_hi[mt] = ms_new_hi;
            l_lo[mt] *= alpha_lo;
            l_hi[mt] *= alpha_hi;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
                acc[mt][j][0] *= alpha_lo;
                acc[mt][j][1] *= alpha_lo;
                acc[mt][j][2] *= alpha_hi;
                acc[mt][j][3] *= alpha_hi;
            }
            // P = exp(s - m_safe): f32 for the row sums, bf16 A fragments for P . V
            const float sh_lo = ms_lo[mt] * LOG2E;
            const float sh_hi = ms_hi[mt] * LOG2E;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
                const float p0 = exp2f(fmaf(s[mt][nb][0], LOG2E, -sh_lo));
                const float p1 = exp2f(fmaf(s[mt][nb][1], LOG2E, -sh_lo));
                const float p2 = exp2f(fmaf(s[mt][nb][2], LOG2E, -sh_hi));
                const float p3 = exp2f(fmaf(s[mt][nb][3], LOG2E, -sh_hi));
                l_lo[mt] += p0 + p1;
                l_hi[mt] += p2 + p3;
                pf[mt][nb * 2] = ssi::pack_bf16(p0, p1);
                pf[mt][nb * 2 + 1] = ssi::pack_bf16(p2, p3);
            }
        }

        // O += P . V over the same 16 keys
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
            uint32_t vf[4];
            ssi::ldmatrix_x4_trans(vf, &sm.v[st][warp * 16 + ((lane / 8) % 2) * 8 + lane % 8][dd * 16 + (lane / 16) * 8]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ssi::mma_bf16(acc[mt][2 * dd], pf[mt], vf[0], vf[1]);
                ssi::mma_bf16(acc[mt][2 * dd + 1], pf[mt], vf[2], vf[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
    }
    ssi::cp_async_wait<0>();
    __syncthreads();

    // each warp's state (m_safe, row sum, O) into shared memory
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        l_lo[mt] += __shfl_xor_sync(0xffffffffu, l_lo[mt], 1);
        l_lo[mt] += __shfl_xor_sync(0xffffffffu, l_lo[mt], 2);
        l_hi[mt] += __shfl_xor_sync(0xffffffffu, l_hi[mt], 1);
        l_hi[mt] += __shfl_xor_sync(0xffffffffu, l_hi[mt], 2);
        const int i_lo = mt * 16 + g;
        const int i_hi = i_lo + 8;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            *reinterpret_cast<float2*>(&cb.o[warp][i_lo][j * 8 + 2 * t4]) = make_float2(acc[mt][j][0], acc[mt][j][1]);
            *reinterpret_cast<float2*>(&cb.o[warp][i_hi][j * 8 + 2 * t4]) = make_float2(acc[mt][j][2], acc[mt][j][3]);
        }
        if (t4 == 0) {
            cb.m[warp][i_lo] = ms_lo[mt];
            cb.l[warp][i_lo] = l_lo[mt];
            cb.m[warp][i_hi] = ms_hi[mt];
            cb.l[warp][i_hi] = l_hi[mt];
        }
    }
    __syncthreads();

    // the four warps combined in warp order; one thread per (row, 4 dims)
    for (int idx = tid; idx < nr * (HD / 4); idx += THREADS) {
        const int i = idx / (HD / 4);
        const int d = (idx % (HD / 4)) * 4;
        float m = cb.m[0][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m = fmaxf(m, cb.m[w][i]);
        float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float wt = exp2f((cb.m[w][i] - m) * LOG2E);
            const float4 o = *reinterpret_cast<const float4*>(&cb.o[w][i][d]);
            l = fmaf(cb.l[w][i], wt, l);
            o0 = fmaf(o.x, wt, o0);
            o1 = fmaf(o.y, wt, o1);
            o2 = fmaf(o.z, wt, o2);
            o3 = fmaf(o.w, wt, o3);
        }
        const int r = r0 + i;
        if (sp.n_live == 1) {
            const float ls = fmaxf(l, 1e-30f);
            store4(static_cast<bf16*>(a.out) + q_index<HD>(a, slot, r) + d, o0 / ls, o1 / ls, o2 / ls, o3 / ls);
        } else {
            store4(part_o<HD>(a, slot, split, r) + d, o0, o1, o2, o3);
            if (d == 0) *reinterpret_cast<float2*>(part_ml<HD>(a, slot, split, r)) = make_float2(m, l);
        }
    }
    if (sp.last && r0 == 0) write_tokens<bf16, HD>(a, slot, sp.hist_raw);
}

// ---- f32: scalar FMAs (parity path) -----------------------------------------

template <int HD>
size_t f32_smem(int rows) {
    constexpr int KPAD = HD + 1;  // padded K row (conflict-free column reads)
    return sizeof(float) * ((size_t)rows * HD + (size_t)TK * KPAD + (size_t)TK * HD + (size_t)rows * TK + 3 * rows);
}

// One block of 128 threads per (split, kv head, slot) holding all R rows;
// RPT: rows per thread (two row groups of 64 threads), at least ceil(R / 2).
// Per 64-key tile: K and V staged as f32; thread (row group, key) forms its
// rows' scores; one warp per row updates the online softmax; thread (row
// group, dim) rescales and accumulates P.V, for dims col, col + 64, ...
template <int HD, int RPT>
__global__ void __launch_bounds__(THREADS) paged_split_f32_kernel(Args a) {
    constexpr int KPAD = HD + 1;
    constexpr int DPT = HD / 64;  // dims per thread in P.V
    extern __shared__ float smem[];
    const int R = a.rows;
    float* q_sm = smem;              // [R][HD], pre-scaled
    float* k_sm = q_sm + R * HD;     // [TK][KPAD]
    float* v_sm = k_sm + TK * KPAD;  // [TK][HD]
    float* s_sm = v_sm + TK * HD;    // [R][TK] scores, then probabilities
    float* m_sm = s_sm + R * TK;     // [R] running max
    float* l_sm = m_sm + R;          // [R] running sum
    float* a_sm = l_sm + R;          // [R] this tile's rescale factor

    const int split = blockIdx.x;
    const int kvh = blockIdx.y;
    const int slot = blockIdx.z;
    const Span sp = span_of(a, slot, split);
    if (split >= sp.n_live) return;
    const int n_tiles = sp.n_hist_tiles + (sp.last ? 1 : 0);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rg = tid >> 6;   // row group: rows rg, rg + 2, ...
    const int col = tid & 63;  // key (scores) or dim (P.V) of this thread
    const long long kvd = (long long)a.Hkv * HD;
    const int* pt = a.page_table + (long long)slot * a.max_pages;
    const float* qb = static_cast<const float*>(a.q);
    const float* kp = static_cast<const float*>(a.k_pool);
    const float* vp = static_cast<const float*>(a.v_pool);
    const float* kn = static_cast<const float*>(a.k_new);
    const float* vn = static_cast<const float*>(a.v_new);

    for (int idx = tid; idx < R * HD; idx += THREADS) q_sm[idx] = qb[q_index<HD>(a, slot, idx / HD) + idx % HD] * a.scale;
    for (int r = tid; r < R; r += THREADS) {
        m_sm[r] = -INFINITY;
        l_sm[r] = 0.f;
    }

    float acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const bool inflight = tile == sp.n_hist_tiles;
        const int key0 = sp.k0 + tile * TK;
        const int n_keys = inflight ? a.t_q : min(TK, sp.k1 - key0);  // keys of this tile that exist
        __syncthreads();  // the previous tile's P.V is done with k_sm, v_sm, s_sm

        // 1) stage K and V of the tile (absent keys as zeros; they are masked)
        for (int c = tid; c < TK * (HD / 8); c += THREADS) {
            const int j = c / (HD / 8);
            const int e8 = (c % (HD / 8)) * 8;
            float kr[8], vr[8];
            if (j < n_keys) {
                if (inflight) {
                    const long long src = (((long long)slot * a.t_q + j) * a.Hkv + kvh) * HD + e8;
                    ssi::load8(kn + src, kr);
                    ssi::load8(vn + src, vr);
                } else {
                    const int key = key0 + j;
                    const long long row = (long long)pt[key / a.ps] * a.ps + key % a.ps;
                    ssi::load8(kp + row * kvd + kvh * HD + e8, kr);
                    ssi::load8(vp + row * kvd + kvh * HD + e8, vr);
                }
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) kr[e] = vr[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                k_sm[j * KPAD + e8 + e] = kr[e];
                v_sm[j * HD + e8 + e] = vr[e];
            }
        }
        __syncthreads();

        // 2) scores of key `col` against this thread's rows
        {
            float s[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) s[i] = 0.f;
            for (int d0 = 0; d0 < HD; d0 += 4) {
                float kr[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) kr[e] = k_sm[col * KPAD + d0 + e];
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    const int r = rg + 2 * i;
                    if (r < R) {
                        const float4 qv = *reinterpret_cast<const float4*>(q_sm + r * HD + d0);
                        s[i] = fmaf(qv.x, kr[0], fmaf(qv.y, kr[1], fmaf(qv.z, kr[2], fmaf(qv.w, kr[3], s[i]))));
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = rg + 2 * i;
                if (r < R) {
                    // in-flight token t (row r) sees in-flight keys 0..t
                    const bool ok = col < n_keys && (!inflight || col <= r / a.n_rep);
                    s_sm[r * TK + col] = ok ? s[i] : -INFINITY;
                }
            }
        }
        __syncthreads();

        // 3) per row: online-softmax update, probabilities in place
        for (int r = warp; r < R; r += WARPS) {
            const float m_old = m_sm[r];
            const float x0 = s_sm[r * TK + lane];
            const float x1 = s_sm[r * TK + lane + 32];
            float mt = fmaxf(x0, x1);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m_old, mt);
            float p0 = 0.f, p1 = 0.f, alpha = 1.f;
            if (m_new != -INFINITY) {  // else nothing valid yet: the row stays empty
                p0 = expf(x0 - m_new);
                p1 = expf(x1 - m_new);
                alpha = expf(m_old - m_new);
            }
            s_sm[r * TK + lane] = p0;
            s_sm[r * TK + lane + 32] = p1;
            float sum = p0 + p1;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
                m_sm[r] = m_new;
                l_sm[r] = l_sm[r] * alpha + sum;
                a_sm[r] = alpha;
            }
        }
        __syncthreads();

        // 4) rescale and accumulate P.V for dims col, col + 64, ..., four keys
        //    at a time (probabilities and V rows past n_keys are 0 up to the
        //    tile's end)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = rg + 2 * i;
            if (r < R) {
#pragma unroll
                for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= a_sm[r];
            }
        }
        for (int j = 0; j < n_keys; j += 4) {
#pragma unroll
            for (int dd = 0; dd < DPT; ++dd) {
                float vj[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) vj[e] = v_sm[(j + e) * HD + col + 64 * dd];
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    const int r = rg + 2 * i;
                    if (r < R) {
                        const float4 p = *reinterpret_cast<const float4*>(s_sm + r * TK + j);
                        acc[i][dd] = fmaf(p.x, vj[0], fmaf(p.y, vj[1], fmaf(p.z, vj[2], fmaf(p.w, vj[3], acc[i][dd]))));
                    }
                }
            }
        }
    }

    // every row of a live split has a valid key, so m is finite here
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = rg + 2 * i;
        if (r < R) {
#pragma unroll
            for (int dd = 0; dd < DPT; ++dd) {
                const int d = col + 64 * dd;
                if (sp.n_live == 1) {
                    static_cast<float*>(a.out)[q_index<HD>(a, slot, r) + d] = acc[i][dd] / fmaxf(l_sm[r], 1e-30f);
                } else {
                    part_o<HD>(a, slot, split, r)[d] = acc[i][dd];
                }
            }
            if (sp.n_live > 1 && col == 0)
                *reinterpret_cast<float2*>(part_ml<HD>(a, slot, split, r)) = make_float2(m_sm[r], l_sm[r]);
        }
    }
    if (sp.last) write_tokens<float, HD>(a, slot, sp.hist_raw);
}

// ---- the merge ----------------------------------------------------------------

// One block per (kv head, slot): each output row combines the slot's live
// splits in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_merge_kernel(Args a) {
    const int slot = blockIdx.z;
    const int n_live = live_splits(a, clamp_hist(a, a.lens[slot] + a.lens_shift));
    if (n_live == 1) return;  // that split wrote the output itself
    for (int idx = threadIdx.x; idx < a.rows * (HD / 4); idx += THREADS) {
        const int r = idx / (HD / 4);
        const int d = (idx % (HD / 4)) * 4;
        float m = NEG_INF;
        for (int s = 0; s < n_live; ++s) m = fmaxf(m, part_ml<HD>(a, slot, s, r)[0]);
        float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
        for (int s = 0; s < n_live; ++s) {
            const float2 ml = *reinterpret_cast<const float2*>(part_ml<HD>(a, slot, s, r));
            const float wt = exp2f((ml.x - m) * LOG2E);
            const float4 o = *reinterpret_cast<const float4*>(part_o<HD>(a, slot, s, r) + d);
            l = fmaf(ml.y, wt, l);
            o0 = fmaf(o.x, wt, o0);
            o1 = fmaf(o.y, wt, o1);
            o2 = fmaf(o.z, wt, o2);
            o3 = fmaf(o.w, wt, o3);
        }
        const float ls = fmaxf(l, 1e-30f);
        store4(static_cast<T*>(a.out) + q_index<HD>(a, slot, r) + d, o0 / ls, o1 / ls, o2 / ls, o3 / ls);
    }
}

template <int HD, int MT>
cudaError_t launch_bf16(const Args& a, cudaStream_t st) {
    const int row_groups = (a.rows + BLOCK_ROWS<HD> - 1) / BLOCK_ROWS<HD>;
    int smem = 0;
    if constexpr (HD != 64) {
        static int allowed = 0;
        smem = sizeof(Bf16Smem<HD, MT>);
        const cudaError_t err = ssi::allow_dynamic_smem(paged_split_bf16_kernel<HD, MT>, smem, allowed);
        if (err != cudaSuccess) return err;
    }
    paged_split_bf16_kernel<HD, MT><<<dim3(a.n_splits, a.Hkv, a.n_slots * row_groups), THREADS, smem, st>>>(
        a, row_groups);
    return cudaGetLastError();
}

template <int HD, int RPT>
cudaError_t launch_f32(const Args& a, cudaStream_t st) {
    static int allowed = 0;
    const size_t smem = f32_smem<HD>(a.rows);
    if (smem > 48 * 1024) {
        const cudaError_t err = ssi::allow_dynamic_smem(paged_split_f32_kernel<HD, RPT>, (int)smem, allowed);
        if (err != cudaSuccess) return err;
    }
    paged_split_f32_kernel<HD, RPT><<<dim3(a.n_splits, a.Hkv, a.n_slots), THREADS, smem, st>>>(a);
    return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t st) {
    cudaError_t err;
    if (dtype == ssi::kBFloat16) {
        // cp.async moves 16-byte pieces: every row start must be 16-byte aligned
        const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k_pool) |
                               reinterpret_cast<uintptr_t>(a.v_pool) | reinterpret_cast<uintptr_t>(a.k_new) |
                               reinterpret_cast<uintptr_t>(a.v_new) | reinterpret_cast<uintptr_t>(a.part);
        if (ptrs % 16 != 0) return cudaErrorInvalidValue;
        if constexpr (HD == 64)
            err = a.rows <= 16 ? launch_bf16<HD, 1>(a, st) : launch_bf16<HD, 2>(a, st);
        else
            err = launch_bf16<HD, 1>(a, st);
    } else if (dtype == ssi::kFloat32) {
        const int need = (a.rows + 1) / 2;
        err = need <= 1    ? launch_f32<HD, 1>(a, st)
              : need <= 2  ? launch_f32<HD, 2>(a, st)
              : need <= 4  ? launch_f32<HD, 4>(a, st)
              : need <= 8  ? launch_f32<HD, 8>(a, st)
              : need <= 16 ? launch_f32<HD, 16>(a, st)
                           : launch_f32<HD, 32>(a, st);
    } else {
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || a.n_splits == 1) return err;
    if (dtype == ssi::kBFloat16)
        paged_merge_kernel<bf16, HD><<<dim3(1, a.Hkv, a.n_slots), THREADS, 0, st>>>(a);
    else
        paged_merge_kernel<float, HD><<<dim3(1, a.Hkv, a.n_slots), THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

cudaError_t launch(int dtype, int hd, const Args& a, cudaStream_t st) {
    if (a.Hkv <= 0 || a.n_rep <= 0 || a.t_q < 1 || a.t_q > MAX_T || a.rows > MAX_ROWS || a.ps <= 0 ||
        a.max_pages <= 0 || a.n_slots <= 0 || a.split_keys <= 0 || a.split_keys % a.ps != 0 || a.n_splits <= 0 ||
        (long long)(a.n_splits - 1) * a.split_keys >= (long long)a.max_pages * a.ps ||
        (long long)a.n_splits * a.split_keys < (long long)a.max_pages * a.ps)
        return cudaErrorInvalidValue;
    if (hd == 64) return launch<64>(dtype, a, st);
    if (hd == 128) return launch<128>(dtype, a, st);
    return cudaErrorInvalidValue;
}

Args make_args(const void* q, void* k_pool, void* v_pool, const void* page_table, const void* lens,
               const void* k_new, const void* v_new, const void* write_rows, void* out, void* part,
               int n_slots, int t_q, int Hq, int Hkv, int ps, int max_pages, int pages_per_split, int n_splits,
               float scale) {
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
    a.lens_shift = 0;
    a.trash = -1;
    a.n_slots = n_slots;
    a.t_q = t_q;
    a.Hkv = Hkv;
    a.n_rep = Hkv > 0 ? Hq / Hkv : 0;
    a.ps = ps;
    a.max_pages = max_pages;
    a.split_keys = pages_per_split * ps;
    a.n_splits = n_splits;
    a.rows = t_q * a.n_rep;
    a.scale = scale;
    return a;
}

}  // namespace

// #8: one token per slot; seq_lens counts it. hd: head_dim, 64 or 128.
// `part`: the split scratch, n_slots * Hkv * n_splits * n_rep * (hd + 2)
// floats (unused when n_splits is 1).
extern "C" int ssi_paged_attention_fused(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* seq_lens,
    const void* k_new, const void* v_new, const void* write_rows, void* out, void* part,
    int n_slots, int Hq, int Hkv, int hd, int ps, int max_pages, int pages_per_split, int n_splits, float scale,
    void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    Args a = make_args(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows, out, part, n_slots, 1,
                       Hq, Hkv, ps, max_pages, pages_per_split, n_splits, scale);
    a.lens_shift = -1;
    return static_cast<int>(launch(dtype, hd, a, static_cast<cudaStream_t>(stream)));
}

// #9: T tokens per slot after hist_lens resident ones; a write row equal to
// `trash` is skipped. `part`: n_slots * Hkv * n_splits * T * n_rep * (hd + 2)
// floats.
extern "C" int ssi_paged_attention_multi(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* hist_lens,
    const void* k_new, const void* v_new, const void* write_rows, void* out, void* part,
    int n_slots, int t_q, int Hq, int Hkv, int hd, int ps, int max_pages, int trash, int pages_per_split,
    int n_splits, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    Args a = make_args(q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows, out, part, n_slots, t_q,
                       Hq, Hkv, ps, max_pages, pages_per_split, n_splits, scale);
    a.trash = trash;
    return static_cast<int>(launch(dtype, hd, a, static_cast<cudaStream_t>(stream)));
}
