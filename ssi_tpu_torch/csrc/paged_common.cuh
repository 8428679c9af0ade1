// What both halves of the paged core share (paged_attention.cu: the bf16
// kernel on TMA page loads and the C entry points; paged_split.cuh: the
// plain-load split kernel and its merge): the launch arguments, a split's
// span, the scratch layout and the in-flight token writes. The design and
// the semantics: the top of paged_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ssi::paged {

constexpr int THREADS = 128;             // plain-load blocks
constexpr int WARPS = THREADS / 32;
constexpr int TK = 64;          // keys per tile
constexpr int MAX_T = 8;        // in-flight tokens per slot
constexpr int GROUP_ROWS = 64;  // query rows a block holds at most: a row group of T * n_rep
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
    int* counters;           // [slots * Hkv * groups] arrivals of split blocks (bf16)
    int lens_shift;          // -1 (#8: seq_lens counts the incoming token) or 0 (#9)
    int trash;               // a write row equal to it is skipped; -1: none is (#8)
    int n_slots, t_q, Hkv, n_rep, ps, max_pages;
    int hd;                  // head_dim: <= the instance's HD, a multiple of 8
    int split_keys;          // keys per split (pages per split * ps)
    int n_splits;            // splits per (slot, kv head)
    int rows;                // R = t_q * n_rep
    int groups;              // row groups: ceil(R / GROUP_ROWS), a block each
    int box;                 // keys per TMA box (bf16): divides ps and 64
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

template <int KEYS = TK>  // keys per tile
__device__ __forceinline__ Span span_of(const Args& a, int slot, int split) {
    Span s;
    s.hist_raw = a.lens[slot] + a.lens_shift;
    const int hist = clamp_hist(a, s.hist_raw);
    s.n_live = live_splits(a, hist);
    s.last = split == s.n_live - 1;
    s.k0 = split * a.split_keys;
    s.k1 = min(hist, s.k0 + a.split_keys);
    s.n_hist_tiles = s.k1 > s.k0 ? (s.k1 - s.k0 + KEYS - 1) / KEYS : 0;
    return s;
}

// the element of q and out where query row r (of all R) of this block's kv
// head starts
__device__ __forceinline__ long long q_index(const Args& a, int slot, int r) {
    const int Hq = a.Hkv * a.n_rep;
    return (((long long)slot * a.t_q + r / a.n_rep) * Hq + (long long)blockIdx.y * a.n_rep + r % a.n_rep) * a.hd;
}

__device__ __forceinline__ float* part_o(const Args& a, int slot, int split, int r) {
    return a.part + ((((long long)slot * a.Hkv + blockIdx.y) * a.n_splits + split) * a.rows + r) * a.hd;
}

__device__ __forceinline__ float* part_ml(const Args& a, int slot, int split, int r) {
    const long long o_size = (long long)a.n_slots * a.Hkv * a.n_splits * a.rows * a.hd;
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

// The in-flight tokens' K/V into their cells (f32): this kv head's stripe of
// each token's row (positions >= hist_len, which no split reads).
template <typename T>
__device__ void write_tokens(const Args& a, int slot, int hist_raw) {
    const int kvh = blockIdx.y;
    const long long kvd = (long long)a.Hkv * a.hd;
    for (int idx = threadIdx.x; idx < a.t_q * a.hd; idx += THREADS) {
        const int t = idx / a.hd;
        const int d = idx % a.hd;
        const int row = a.write_rows[slot * a.t_q + t];
        if (row == a.trash) continue;
        const int off = ((hist_raw + t) % a.ps + a.ps) % a.ps;
        const long long dst = ((long long)row * a.ps + off) * kvd + (long long)kvh * a.hd + d;
        const long long src = (((long long)slot * a.t_q + t) * a.Hkv + kvh) * a.hd + d;
        static_cast<T*>(a.k_pool)[dst] = static_cast<const T*>(a.k_new)[src];
        static_cast<T*>(a.v_pool)[dst] = static_cast<const T*>(a.v_new)[src];
    }
}

// The plain-load kernels (paged_split.cu): the f32 parity path at every
// head_dim, and bf16 at a head_dim that is not a multiple of 8. `a` is
// checked by the caller.
cudaError_t launch_plain(int dtype, const Args& a, cudaStream_t st);
// launch_plain at 128 < hd <= 256 (paged_split_hd256.cu)
cudaError_t launch_plain_hd256(int dtype, const Args& a, cudaStream_t st);

}  // namespace ssi::paged
