// Fused T-token write + verify attention over the flat paged KV pool: the
// verify pass of n-gram speculative decoding. For every slot, each of the T
// candidate tokens attends the slot's history read from its pages plus the
// in-flight tokens 0..t (causal), then the T tokens' K/V are stored into
// their pages. head_dim 64, f32 or bf16 storage, f32 math.
//
// Replaces the TPU kernel ssi_tpu/generate/paged_pallas.py
// `paged_attention_pallas_multi` -> `_kernel_multi`. Semantics kept: the
// pools are [L*n_pages + 1, page_size, Hkv*64] (trash row last);
// `page_table` [slots, max_pages] holds PHYSICAL rows; `hist_lens` counts
// the tokens resident in the pages BEFORE the step, and only those are read
// (positions < hist_len); q [slots, T, Hq, 64] is unscaled and scaled here
// by 1/sqrt(64) in f32. What differs: the TPU kernel persists the T tokens
// through two aligned 8-row read-modify-write windows, a TPU DMA alignment
// rule; here each token has its own physical write row, `write_rows`
// [slots, T], at offset (hist_len + t) % page_size, and a token whose row is
// the trash row is not written at all (inactive slot, or a position at or
// beyond the slot's write cap).
//
// What bounds it on Hopper: the bytes of the history pages (each history K
// and V element is read once per step and used by all T * n_rep query rows
// of its kv head), as for the single-token kernel. The TPU kernel keeps every
// history score of a slot in VMEM; 227 KB of shared memory cannot hold
// T * n_rep = 32 rows of a 1,280-token context in f32, so this kernel runs an
// online softmax over 64-key tiles instead.
//
// Design (one block of 128 threads per (slot, kv head), holding all
// R = T * n_rep query rows of that kv head, t-major):
// 1. stage the tile's 64 keys of K and V in shared memory as f32 (16-byte
//    loads, 8 threads per key); the last tile is the in-flight block, taken
//    from k_new / v_new instead of the pages;
// 2. scores: thread (row group, key) forms R/2 dot products against its
//    key's K row (rows padded to 65 floats: no bank conflicts; q read as
//    16-byte broadcasts), masked to -inf past hist_len, or past token t in
//    the in-flight block;
// 3. one warp per row: tile max, running max, exp in place, running sum, and
//    the factor that rescales the row's accumulator;
// 4. thread (row group, dim) rescales its R/2 accumulators and adds p * V,
//    four keys' probabilities per 16-byte load.
// The rows per thread are a template parameter (the power of two at or
// above R/2), so no thread loops over rows its block does not have.
// The history is read before any token is written, and a block writes only
// positions >= hist_len of its own slot in its own kv head's columns, so no
// block reads what another writes (a page shared through the prefix cache
// holds prompt positions <= p-2 only and is never a write target).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;
constexpr int TK = 64;              // keys per tile
constexpr int KPAD = HD + 1;        // padded K row (conflict-free column reads)
constexpr int MAX_ROWS = 64;        // T * n_rep <= 8 * 8
constexpr int WARPS = THREADS / 32;

size_t smem_bytes(int rows) {
    return sizeof(float) * ((size_t)rows * HD + (size_t)TK * KPAD + (size_t)TK * HD + (size_t)rows * TK + 3 * rows);
}

// RPT: rows per thread (two row groups of 64 threads), at least ceil(R / 2)
template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS) paged_multi_kernel(
    const T* __restrict__ q, T* __restrict__ k_pool, T* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ hist_lens,
    const T* __restrict__ k_new, const T* __restrict__ v_new, const int* __restrict__ write_rows,
    T* __restrict__ out, int t_q, int Hkv, int n_rep, int ps, int max_pages, int trash, float scale) {
    extern __shared__ float smem[];
    const int R = t_q * n_rep;
    float* q_sm = smem;              // [R][HD], pre-scaled
    float* k_sm = q_sm + R * HD;     // [TK][KPAD]
    float* v_sm = k_sm + TK * KPAD;  // [TK][HD]
    float* s_sm = v_sm + TK * HD;    // [R][TK] scores, then probabilities
    float* m_sm = s_sm + R * TK;     // [R] running max
    float* l_sm = m_sm + R;          // [R] running sum
    float* a_sm = l_sm + R;          // [R] this tile's rescale factor

    const int slot = blockIdx.x;
    const int kvh = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rg = tid >> 6;   // row group: rows rg, rg + 2, ...
    const int col = tid & 63;  // key (scores) or dim (P.V) of this thread
    const int Hq = Hkv * n_rep;
    const long long kvd = (long long)Hkv * HD;
    const int hist_raw = hist_lens[slot];
    const int hist = min(max(hist_raw, 0), max_pages * ps);
    const int* pt = page_table + (long long)slot * max_pages;

    for (int idx = tid; idx < R * HD; idx += THREADS) {
        const int r = idx / HD;
        const int d = idx % HD;
        const int t = r / n_rep;
        const int g = r % n_rep;
        q_sm[idx] = ssi::to_f32(q[(((long long)slot * t_q + t) * Hq + kvh * n_rep + g) * HD + d]) * scale;
    }
    for (int r = tid; r < R; r += THREADS) {
        m_sm[r] = -INFINITY;
        l_sm[r] = 0.f;
    }

    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

    const int n_hist_tiles = (hist + TK - 1) / TK;
    for (int tile = 0; tile <= n_hist_tiles; ++tile) {
        const bool inflight = tile == n_hist_tiles;
        const int key0 = tile * TK;
        const int n_keys = inflight ? t_q : min(TK, hist - key0);  // keys of this tile that exist
        __syncthreads();  // the previous tile's P.V is done with k_sm, v_sm, s_sm

        // 1) stage K and V of the tile (absent keys as zeros; they are masked)
        for (int c = tid; c < TK * 8; c += THREADS) {
            const int j = c >> 3;
            const int e8 = (c & 7) * 8;
            float kr[8], vr[8];
            if (j < n_keys) {
                if (inflight) {
                    const long long src = (((long long)slot * t_q + j) * Hkv + kvh) * HD + e8;
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        kr[e] = ssi::to_f32(k_new[src + e]);
                        vr[e] = ssi::to_f32(v_new[src + e]);
                    }
                } else {
                    const int jg = key0 + j;
                    const long long row = (long long)pt[jg / ps] * ps + jg % ps;
                    ssi::load8(k_pool + row * kvd + kvh * HD + e8, kr);
                    ssi::load8(v_pool + row * kvd + kvh * HD + e8, vr);
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
                    const bool ok = col < n_keys && (!inflight || col <= r / n_rep);
                    s_sm[r * TK + col] = ok ? s[i] : -INFINITY;
                }
            }
        }
        __syncthreads();

        // 3) per row: online-softmax update, probabilities in place
        for (int r = warp; r < R; r += WARPS) {
            const float m_old = m_sm[r];
            const float a = s_sm[r * TK + lane];
            const float b = s_sm[r * TK + lane + 32];
            float mt = fmaxf(a, b);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m_old, mt);
            float pa = 0.f, pb = 0.f, alpha = 1.f;
            if (m_new != -INFINITY) {  // else nothing valid yet: the row stays empty
                pa = expf(a - m_new);
                pb = expf(b - m_new);
                alpha = expf(m_old - m_new);
            }
            s_sm[r * TK + lane] = pa;
            s_sm[r * TK + lane + 32] = pb;
            float sum = pa + pb;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
                m_sm[r] = m_new;
                l_sm[r] = l_sm[r] * alpha + sum;
                a_sm[r] = alpha;
            }
        }
        __syncthreads();

        // 4) rescale and accumulate P.V for dim `col`, four keys at a time
        //    (probabilities and V rows past n_keys are 0 up to the tile's end)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = rg + 2 * i;
            if (r < R) acc[i] *= a_sm[r];
        }
        for (int j = 0; j < n_keys; j += 4) {
            float vj[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) vj[e] = v_sm[(j + e) * HD + col];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = rg + 2 * i;
                if (r < R) {
                    const float4 p = *reinterpret_cast<const float4*>(s_sm + r * TK + j);
                    acc[i] = fmaf(p.x, vj[0], fmaf(p.y, vj[1], fmaf(p.z, vj[2], fmaf(p.w, vj[3], acc[i]))));
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = rg + 2 * i;
        if (r < R) {
            const int t = r / n_rep;
            const int g = r % n_rep;
            out[(((long long)slot * t_q + t) * Hq + kvh * n_rep + g) * HD + col] =
                ssi::from_f32<T>(acc[i] / fmaxf(l_sm[r], 1e-30f));
        }
    }

    // the token writes: this kv head's stripe of each token's cell (positions
    // >= hist_len, never read above); the trash row means skip
    for (int idx = tid; idx < t_q * HD; idx += THREADS) {
        const int t = idx / HD;
        const int d = idx % HD;
        const int row = write_rows[slot * t_q + t];
        if (row == trash) continue;
        const int off = ((hist_raw + t) % ps + ps) % ps;
        const long long dst = ((long long)row * ps + off) * kvd + kvh * HD + d;
        const long long src = (((long long)slot * t_q + t) * Hkv + kvh) * HD + d;
        k_pool[dst] = k_new[src];
        v_pool[dst] = v_new[src];
    }
}

template <typename T, int RPT>
cudaError_t launch(const void* q, void* k_pool, void* v_pool, const int* page_table, const int* hist_lens,
                   const void* k_new, const void* v_new, const int* write_rows, void* out, int n_slots, int t_q,
                   int Hkv, int n_rep, int ps, int max_pages, int trash, float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes(t_q * n_rep);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            paged_multi_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    paged_multi_kernel<T, RPT><<<dim3(n_slots, Hkv), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<T*>(k_pool), static_cast<T*>(v_pool), page_table, hist_lens,
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), write_rows, static_cast<T*>(out),
        t_q, Hkv, n_rep, ps, max_pages, trash, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* q, void* k_pool, void* v_pool, const int* page_table, const int* hist_lens,
                          const void* k_new, const void* v_new, const int* write_rows, void* out, int n_slots,
                          int t_q, int Hkv, int n_rep, int ps, int max_pages, int trash, float scale,
                          cudaStream_t stream) {
    const int need = (t_q * n_rep + 1) / 2;
#define SSI_MULTI_CASE(N)                                                                                     \
    if (need <= N)                                                                                            \
        return launch<T, N>(q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows, out, n_slots, \
                            t_q, Hkv, n_rep, ps, max_pages, trash, scale, stream);
    SSI_MULTI_CASE(1)
    SSI_MULTI_CASE(2)
    SSI_MULTI_CASE(4)
    SSI_MULTI_CASE(8)
    SSI_MULTI_CASE(16)
    SSI_MULTI_CASE(32)
#undef SSI_MULTI_CASE
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssi_paged_attention_multi(
    int dtype, const void* q, void* k_pool, void* v_pool, const void* page_table, const void* hist_lens,
    const void* k_new, const void* v_new, const void* write_rows, void* out,
    int n_slots, int t_q, int Hq, int Hkv, int ps, int max_pages, int trash, float scale, void* stream) {
    if (Hkv <= 0 || Hq % Hkv != 0 || t_q < 2 || t_q * (Hq / Hkv) > MAX_ROWS || ps <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_rep = Hq / Hkv;
    const int* pt = static_cast<const int*>(page_table);
    const int* hl = static_cast<const int*>(hist_lens);
    const int* wr = static_cast<const int*>(write_rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == ssi::kFloat32)
        return static_cast<int>(dispatch_rows<float>(q, k_pool, v_pool, pt, hl, k_new, v_new, wr, out, n_slots,
                                                     t_q, Hkv, n_rep, ps, max_pages, trash, scale, st));
    if (dtype == ssi::kBFloat16)
        return static_cast<int>(dispatch_rows<__nv_bfloat16>(q, k_pool, v_pool, pt, hl, k_new, v_new, wr, out,
                                                             n_slots, t_q, Hkv, n_rep, ps, max_pages, trash, scale,
                                                             st));
    return static_cast<int>(cudaErrorInvalidValue);
}
