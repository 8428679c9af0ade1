// Fused single-token decode over the flat paged KV pool: write the incoming
// token's K/V into its page, then one exact GQA softmax over the slot's valid
// history pages plus the incoming token. head_dim 64, f32 or bf16 storage,
// f32 math.
//
// Replaces the TPU kernel ssi_tpu/generate/paged_pallas.py
// `paged_attention_pallas` -> `_kernel`. Layout and semantics kept: the pools
// are [L*n_pages + 1, page_size, Hkv*64] (head-flattened rows, trash row
// last); `page_table` [slots, max_pages] holds PHYSICAL rows; `seq_lens`
// counts the incoming token, so hist_len = seq_len - 1 tokens are read from
// the pages (inactive slots carry seq_len 0 and read nothing); the incoming
// token is written to row `write_rows[slot]`, offset `write_offs[slot]`, and
// folded into the softmax from registers, never re-read from the cell just
// written; q is scaled in f32 by 1/sqrt(64).
//
// What bounds it on Hopper: the bytes of the pages read (every history K and
// V element is used once per step; 32 slots x ~700 tokens x 16 layers is
// ~0.7 GB per decode step in bf16). The design reads each history row once,
// coalesced: 8 threads cover one key's 64 dims with 16-byte loads, 16 keys
// per pass over a 128-thread block.
//
// Design (one block per (slot, kv head), all n_rep q heads of that kv head):
// 1. scores for every history key into shared memory (n_rep x max_pages*ps
//    floats), 8-lane shuffle reductions;
// 2. one warp per q head takes the max (incoming token included), turns the
//    scores into exp(s - max) in place and sums them;
// 3. every thread accumulates p * V for its 8 dims over its share of the
//    keys; a shared-memory reduction over the 16 key groups adds the
//    incoming token's p * v_new and divides by the sum.
// The pools are updated in place: torch tensors are mutable, so the aliasing
// the TPU kernel needed (input_output_aliases) has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;
constexpr int GROUPS = THREADS / 8;  // keys handled per pass
constexpr int WARPS = THREADS / 32;

template <typename T, int NREP>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, T* __restrict__ k_pool, T* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ write_rows, const int* __restrict__ write_offs,
    T* __restrict__ out, int Hkv, int ps, int max_pages, float scale) {
    extern __shared__ float smem[];
    const int cap = max_pages * ps;
    float* p_sm = smem;                // [NREP][cap] scores, then probabilities
    float* red_sm = smem + NREP * cap;  // [GROUPS][NREP * HD] partial P.V sums
    __shared__ float q_sm[NREP][HD];
    __shared__ float kn_sm[HD];
    __shared__ float vn_sm[HD];
    __shared__ float pcur_sm[NREP];
    __shared__ float l_sm[NREP];

    const int slot = blockIdx.x;
    const int kvh = blockIdx.y;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int Hq = Hkv * NREP;
    const long long kvd = (long long)Hkv * HD;
    // history tokens resident in pages (-1 if inactive); never past the table
    const int hist = min(seq_lens[slot] - 1, cap);
    const int* pt = page_table + (long long)slot * max_pages;

    for (int idx = t; idx < NREP * HD; idx += THREADS) {
        const int r = idx / HD;
        q_sm[r][idx % HD] = ssi::to_f32(q[((long long)slot * Hq + kvh * NREP + r) * HD + idx % HD]) * scale;
    }
    const long long new_base = ((long long)slot * Hkv + kvh) * HD;
    if (t < HD) {
        kn_sm[t] = ssi::to_f32(k_new[new_base + t]);
        vn_sm[t] = ssi::to_f32(v_new[new_base + t]);
    }
    __syncthreads();

    // 1) scores of the history keys (trip count uniform across the block, so
    //    every lane reaches the shuffles)
    const int g = t >> 3;
    const int l8 = t & 7;
    for (int base = 0; base < hist; base += GROUPS) {
        const int j = base + g;
        const bool ok = j < hist;
        float kv[8];
        if (ok) {
            const long long row = (long long)pt[j / ps] * ps + j % ps;
            ssi::load8(k_pool + row * kvd + kvh * HD + l8 * 8, kv);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) part = fmaf(q_sm[r][l8 * 8 + e], kv[e], part);
            part += __shfl_xor_sync(0xffffffffu, part, 4);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            if (ok && l8 == 0) p_sm[r * cap + j] = part;
        }
    }
    __syncthreads();

    // 2) per q head: max (incoming token included), exp in place, sum
    for (int r = warp; r < NREP; r += WARPS) {
        float cur = q_sm[r][lane] * kn_sm[lane] + q_sm[r][lane + 32] * kn_sm[lane + 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) cur += __shfl_xor_sync(0xffffffffu, cur, off);
        float m = cur;
        for (int j = lane; j < hist; j += 32) m = fmaxf(m, p_sm[r * cap + j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.f;
        for (int j = lane; j < hist; j += 32) {
            const float p = expf(p_sm[r * cap + j] - m);
            p_sm[r * cap + j] = p;
            l += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) {
            const float pc = expf(cur - m);
            pcur_sm[r] = pc;
            l_sm[r] = l + pc;
        }
    }
    __syncthreads();

    // 3) P.V over the history, 8 dims per thread
    float acc[NREP][8];
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    for (int j = g; j < hist; j += GROUPS) {
        const long long row = (long long)pt[j / ps] * ps + j % ps;
        float vv[8];
        ssi::load8(v_pool + row * kvd + kvh * HD + l8 * 8, vv);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
            const float p = p_sm[r * cap + j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
        }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) red_sm[g * (NREP * HD) + r * HD + l8 * 8 + e] = acc[r][e];
    __syncthreads();

    for (int idx = t; idx < NREP * HD; idx += THREADS) {
        const int r = idx / HD;
        const int c = idx % HD;
        float sum = 0.f;
#pragma unroll
        for (int gg = 0; gg < GROUPS; ++gg) sum += red_sm[gg * (NREP * HD) + idx];
        sum += pcur_sm[r] * vn_sm[c];
        out[((long long)slot * Hq + kvh * NREP + r) * HD + c] = ssi::from_f32<T>(sum / fmaxf(l_sm[r], 1e-30f));
    }

    // the token write: this slot's stripe of its page row (never read above)
    if (t < HD) {
        const long long dst = ((long long)write_rows[slot] * ps + write_offs[slot]) * kvd + kvh * HD + t;
        k_pool[dst] = k_new[new_base + t];
        v_pool[dst] = v_new[new_base + t];
    }
}

template <typename T, int NREP>
cudaError_t launch(const void* q, void* k_pool, void* v_pool, const int* page_table, const int* seq_lens,
                   const void* k_new, const void* v_new, const int* write_rows, const int* write_offs,
                   void* out, int n_slots, int Hkv, int ps, int max_pages, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((size_t)NREP * max_pages * ps + (size_t)GROUPS * NREP * HD);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            paged_decode_kernel<T, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    paged_decode_kernel<T, NREP><<<dim3(n_slots, Hkv), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<T*>(k_pool), static_cast<T*>(v_pool), page_table, seq_lens,
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), write_rows, write_offs,
        static_cast<T*>(out), Hkv, ps, max_pages, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rep(int n_rep, const void* q, void* k_pool, void* v_pool, const int* page_table,
                         const int* seq_lens, const void* k_new, const void* v_new, const int* write_rows,
                         const int* write_offs, void* out, int n_slots, int Hkv, int ps, int max_pages,
                         float scale, cudaStream_t stream) {
#define SSI_PAGED_CASE(N)                                                                              \
    case N:                                                                                            \
        return launch<T, N>(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows,         \
                            write_offs, out, n_slots, Hkv, ps, max_pages, scale, stream);
    switch (n_rep) {
        SSI_PAGED_CASE(1)
        SSI_PAGED_CASE(2)
        SSI_PAGED_CASE(4)
        SSI_PAGED_CASE(8)
        default:
            return cudaErrorInvalidValue;
    }
#undef SSI_PAGED_CASE
}

}  // namespace

extern "C" int ssi_paged_attention_fused(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* seq_lens,
    const void* k_new, const void* v_new, const void* write_rows, const void* write_offs, void* out,
    int n_slots, int Hq, int Hkv, int ps, int max_pages, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int n_rep = Hq / Hkv;
    const int* pt = static_cast<const int*>(page_table);
    const int* sl = static_cast<const int*>(seq_lens);
    const int* wr = static_cast<const int*>(write_rows);
    const int* wo = static_cast<const int*>(write_offs);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == ssi::kFloat32) {
        err = dispatch_rep<float>(n_rep, q, k_pool, v_pool, pt, sl, k_new, v_new, wr, wo, out,
                                  n_slots, Hkv, ps, max_pages, scale, st);
    } else if (dtype == ssi::kBFloat16) {
        err = dispatch_rep<__nv_bfloat16>(n_rep, q, k_pool, v_pool, pt, sl, k_new, v_new, wr, wo, out,
                                          n_slots, Hkv, ps, max_pages, scale, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
