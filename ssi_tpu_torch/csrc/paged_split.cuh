// Paged attention, the plain-load kernels of the core (#8 and #9; the design
// and semantics: paged_attention.cu) and their launchers, instantiated by
// paged_split.cu at the instances HD 64 and 128 and by paged_split_hd256.cu
// at 256: translation units of their own, so that their instances (the
// longest to compile of the library) compile beside each other and beside
// the bf16 kernel's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "paged_common.cuh"

using namespace ssi::paged;

namespace {

// The same split with scalar f32 FMAs, K and V staged in shared memory by the
// threads' own loads, and a merge kernel. f32 storage (the parity path) at
// every head_dim; and bf16 storage at a head_dim that is not a multiple of 8
// (VEC false): its pool rows are not 16-byte strided, so no tensor map
// describes them (TMA strides are multiples of 16 bytes), and the engine's
// pools stay as they are (a padded pool would change its state). Those
// copies are element by element (consecutive threads on consecutive
// elements), the arithmetic f32 on the bf16 values, the output cast to bf16.

template <int HD>
size_t f32_smem(int rows) {
    constexpr int KPAD = HD + 1;  // padded K row (conflict-free column reads)
    return sizeof(float) * ((size_t)rows * HD + (size_t)TK * KPAD + (size_t)TK * HD + (size_t)rows * TK + 3 * rows);
}

// One block of 128 threads per (split and row group, kv head, slot) holding
// the group's rows (all R up to 64); RPT: rows per thread (two halves of 64
// threads), at least ceil(rows / 2). Columns past hd are staged as zeros.
// Per 64-key tile: K and V staged as f32; thread (row group, key) forms its
// rows' scores; one warp per row updates the online softmax; thread (row
// group, dim) rescales and accumulates P.V, for dims col, col + 64, ...
// T: the storage type; VEC: hd a multiple of 8, rows copied 8 elements at a
// time (else one).
template <typename T, int HD, int RPT, bool VEC>
__global__ void __launch_bounds__(THREADS) paged_split_kernel(Args a) {
    constexpr int KPAD = HD + 1;
    constexpr int DPT = HD / 64;  // dims per thread in P.V
    const int split = blockIdx.x % a.n_splits;
    const int rbase = blockIdx.x / a.n_splits * GROUP_ROWS;  // this block's rows: rbase + [0, R)
    const int R = min(GROUP_ROWS, a.rows - rbase);
    extern __shared__ float smem[];
    float* q_sm = smem;              // [R][HD], pre-scaled
    float* k_sm = q_sm + R * HD;     // [TK][KPAD]
    float* v_sm = k_sm + TK * KPAD;  // [TK][HD]
    float* s_sm = v_sm + TK * HD;    // [R][TK] scores, then probabilities
    float* m_sm = s_sm + R * TK;     // [R] running max
    float* l_sm = m_sm + R;          // [R] running sum
    float* a_sm = l_sm + R;          // [R] this tile's rescale factor

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
    const long long kvd = (long long)a.Hkv * a.hd;
    const int* pt = a.page_table + (long long)slot * a.max_pages;
    const T* qb = static_cast<const T*>(a.q);
    const T* kp = static_cast<const T*>(a.k_pool);
    const T* vp = static_cast<const T*>(a.v_pool);
    const T* kn = static_cast<const T*>(a.k_new);
    const T* vn = static_cast<const T*>(a.v_new);

    for (int idx = tid; idx < R * HD; idx += THREADS)
        q_sm[idx] = idx % HD < a.hd ? ssi::to_f32(qb[q_index(a, slot, rbase + idx / HD) + idx % HD]) * a.scale : 0.f;
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
        if constexpr (!VEC) {
            // one element a copy, UNROLL of them a thread in flight at a time (a
            // whole tile at HD 64): a thread's loads are issued before its stores,
            // so their latencies overlap; with a block or two an SM nothing else
            // hides them
            constexpr int UNROLL = 32;
            static_assert(TK * HD % (THREADS * UNROLL) == 0, "whole rounds of copies");
#pragma unroll 1
            for (int base = tid; base < TK * HD; base += THREADS * UNROLL) {
                float kr[UNROLL], vr[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int idx = base + u * THREADS;
                    const int j = idx / HD;
                    const int e = idx % HD;
                    kr[u] = vr[u] = 0.f;
                    if (j < n_keys && e < a.hd) {
                        long long src;
                        const T* kb = kp;
                        const T* vb = vp;
                        if (inflight) {
                            src = (((long long)slot * a.t_q + j) * a.Hkv + kvh) * a.hd + e;
                            kb = kn;
                            vb = vn;
                        } else {
                            const int key = key0 + j;
                            src = ((long long)pt[key / a.ps] * a.ps + key % a.ps) * kvd + (long long)kvh * a.hd + e;
                        }
                        kr[u] = ssi::to_f32(kb[src]);
                        vr[u] = ssi::to_f32(vb[src]);
                    }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int idx = base + u * THREADS;
                    k_sm[idx / HD * KPAD + idx % HD] = kr[u];
                    v_sm[idx] = vr[u];
                }
            }
        } else for (int c = tid; c < TK * (HD / 8); c += THREADS) {
            const int j = c / (HD / 8);
            const int e8 = (c % (HD / 8)) * 8;
            float kr[8], vr[8];
            if (j < n_keys && e8 < a.hd) {
                if (inflight) {
                    const long long src = (((long long)slot * a.t_q + j) * a.Hkv + kvh) * a.hd + e8;
                    ssi::load8(kn + src, kr);
                    ssi::load8(vn + src, vr);
                } else {
                    const int key = key0 + j;
                    const long long row = (long long)pt[key / a.ps] * a.ps + key % a.ps;
                    ssi::load8(kp + row * kvd + (long long)kvh * a.hd + e8, kr);
                    ssi::load8(vp + row * kvd + (long long)kvh * a.hd + e8, vr);
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
                    const bool ok = col < n_keys && (!inflight || col <= (rbase + r) / a.n_rep);
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
                if (d >= a.hd) continue;
                if (sp.n_live == 1) {
                    static_cast<T*>(a.out)[q_index(a, slot, rbase + r) + d] =
                        ssi::from_f32<T>(acc[i][dd] / fmaxf(l_sm[r], 1e-30f));
                } else {
                    part_o(a, slot, split, rbase + r)[d] = acc[i][dd];
                }
            }
            if (sp.n_live > 1 && col == 0) {
                float* ml = part_ml(a, slot, split, rbase + r);
                if constexpr (VEC) {
                    *reinterpret_cast<float2*>(ml) = make_float2(m_sm[r], l_sm[r]);
                } else {  // the ml block follows hd-float rows: 4-byte aligned only
                    ml[0] = m_sm[r];
                    ml[1] = l_sm[r];
                }
            }
        }
    }
    if (sp.last && rbase == 0) write_tokens<T>(a, slot, sp.hist_raw);
}

// ---- the f32 merge ------------------------------------------------------------

// One block per (kv head, slot): each output row combines the slot's live
// splits in split order (VEC: 4 dims a thread, else one).
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS) paged_merge_kernel(Args a) {
    const int slot = blockIdx.z;
    const int n_live = live_splits(a, clamp_hist(a, a.lens[slot] + a.lens_shift));
    if (n_live == 1) return;  // that split wrote the output itself
    if constexpr (!VEC) {
        for (int idx = threadIdx.x; idx < a.rows * a.hd; idx += THREADS) {
            const int r = idx / a.hd;
            const int d = idx % a.hd;
            float m = NEG_INF;
            for (int s = 0; s < n_live; ++s) m = fmaxf(m, part_ml(a, slot, s, r)[0]);
            float l = 0.f, o = 0.f;
            for (int s = 0; s < n_live; ++s) {
                const float* ml = part_ml(a, slot, s, r);
                const float wt = exp2f((ml[0] - m) * LOG2E);
                l = fmaf(ml[1], wt, l);
                o = fmaf(part_o(a, slot, s, r)[d], wt, o);
            }
            static_cast<T*>(a.out)[q_index(a, slot, r) + d] = ssi::from_f32<T>(o / fmaxf(l, 1e-30f));
        }
        return;
    }
    for (int idx = threadIdx.x; idx < a.rows * (HD / 4); idx += THREADS) {
        const int r = idx / (HD / 4);
        const int d = (idx % (HD / 4)) * 4;
        if (d >= a.hd) continue;
        float m = NEG_INF;
        for (int s = 0; s < n_live; ++s) m = fmaxf(m, part_ml(a, slot, s, r)[0]);
        float l = 0.f, o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
        for (int s = 0; s < n_live; ++s) {
            const float2 ml = *reinterpret_cast<const float2*>(part_ml(a, slot, s, r));
            const float wt = exp2f((ml.x - m) * LOG2E);
            const float4 o = *reinterpret_cast<const float4*>(part_o(a, slot, s, r) + d);
            l = fmaf(ml.y, wt, l);
            o0 = fmaf(o.x, wt, o0);
            o1 = fmaf(o.y, wt, o1);
            o2 = fmaf(o.z, wt, o2);
            o3 = fmaf(o.w, wt, o3);
        }
        const float ls = fmaxf(l, 1e-30f);
        store4(static_cast<T*>(a.out) + q_index(a, slot, r) + d, o0 / ls, o1 / ls, o2 / ls, o3 / ls);
    }
}

template <typename T, int HD, int RPT, bool VEC>
cudaError_t launch_split(const Args& a, cudaStream_t st) {
    static int allowed = 0;
    const size_t smem = f32_smem<HD>(std::min(a.rows, GROUP_ROWS));
    if (smem > 48 * 1024) {
        const cudaError_t err = ssi::allow_dynamic_smem(paged_split_kernel<T, HD, RPT, VEC>, (int)smem, allowed);
        if (err != cudaSuccess) return err;
    }
    paged_split_kernel<T, HD, RPT, VEC><<<dim3(a.n_splits * a.groups, a.Hkv, a.n_slots), THREADS, smem, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.n_splits == 1) return err;
    paged_merge_kernel<T, HD, VEC><<<dim3(1, a.Hkv, a.n_slots), THREADS, 0, st>>>(a);
    return cudaGetLastError();
}

// the split kernel's instance by the rows a block holds: RPT at least half of them
template <typename T, int HD, bool VEC>
cudaError_t launch_split_rows(const Args& a, cudaStream_t st) {
    const int need = (std::min(a.rows, GROUP_ROWS) + 1) / 2;
    if constexpr (!VEC)  // three instances: the route is for shapes no registry model has
        return need <= 2   ? launch_split<T, HD, 2, VEC>(a, st)
               : need <= 8 ? launch_split<T, HD, 8, VEC>(a, st)
                           : launch_split<T, HD, 32, VEC>(a, st);
    else
        return need <= 1    ? launch_split<T, HD, 1, VEC>(a, st)
               : need <= 2  ? launch_split<T, HD, 2, VEC>(a, st)
               : need <= 4  ? launch_split<T, HD, 4, VEC>(a, st)
               : need <= 8  ? launch_split<T, HD, 8, VEC>(a, st)
               : need <= 16 ? launch_split<T, HD, 16, VEC>(a, st)
                            : launch_split<T, HD, 32, VEC>(a, st);
}

// the instance at HD (64, 128 or 256) that runs head_dim a.hd
template <int HD>
cudaError_t launch_hd(int dtype, const Args& a, cudaStream_t st) {
    if (a.hd % 8 != 0) {  // rows not 16-byte strided: one element a copy, in either dtype
        if (dtype == ssi::kBFloat16) return launch_split_rows<bf16, HD, false>(a, st);
        if (dtype == ssi::kFloat32) return launch_split_rows<float, HD, false>(a, st);
        return cudaErrorInvalidValue;
    }
    if (dtype == ssi::kFloat32) return launch_split_rows<float, HD, true>(a, st);
    return cudaErrorInvalidValue;  // bf16 at a multiple of 8 takes the TMA kernel
}

}  // namespace
