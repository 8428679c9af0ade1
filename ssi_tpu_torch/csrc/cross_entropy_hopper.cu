// The cross-entropy's four bf16 products on one GEMM designed for Hopper,
// from h [N, D], E [V, D], the forward's lse [N] and the labels:
// - the logsumexp's partial pairs from the logits h . E^T: per token row and
//   256-column vocab tile the max m over the columns below V and l = sum of
//   exp(logit - m), into m_part / l_part [n_vtiles, N] (cross_entropy.cu
//   merges them in a fixed order); the logits never leave registers;
// - dlogits [N, V] = epi(h . E^T): (exp(logit - lse) - onehot) * valid * g,
//   into the scratch [N, ldv] (ldv = V rounded up to 8; pad columns written
//   0; an ignored label (-100) gives a zero row);
// - dh [N, D] = dlogits . E;
// - dE [V, D] = dlogits^T . h.
//
// Replaces the TPU kernels ssi_tpu/ops/cross_entropy_pallas.py `_lse_kernel`
// (launched from `_compute_lse`), `_dh_kernel` and `_de_kernel` (launched
// from `_bwd_rule`) in bf16, as cross_entropy.cu lays them out: a partial
// pass and a merge for the logsumexp; a dlogits pass that writes dlogits
// once, and the dh and dE products that read it. Semantics kept: logits and
// sums in f32, vocab columns at or past V count as -1e30 in the logsumexp,
// dlogits cast to bf16 before the dh and dE products, the outputs written in
// bf16; rows past N or V are not written. The f32 parity paths and the merge
// stay in cross_entropy.cu.
//
// What bounds it on Hopper: 2 N V D FLOP a product (2.24 TFLOP at N 4096,
// D 2048, V 133,258) against the 1.09 GB of dlogits written or read once:
// operations. Only wgmma reaches the card's tensor-core rate, so the design is
// the usual Hopper GEMM, one kernel template for the four products:
// - output tiles of 128 rows x BN columns (BN 256, or 128 where the columns
//   are D and D is not a multiple of 256), 2 warpgroups of 64 rows each (256
//   threads, one block an SM: 193 KB of shared memory at BN 256); each
//   warpgroup issues wgmma m64nBNk16 with both operands in shared memory,
//   each K-major or MN-major by the instruction's transpose bits, so no
//   operand is copied transposed:
//     lse, dlogits: A = h (K-major), B = E (K-major), K = D;
//     dh:      A = dlogits (K-major), B = E (MN-major: its D is contiguous), K = V;
//     dE:      A = dlogits^T (MN-major: its V is contiguous), B = h (MN-major), K = N;
// - 64-deep K slabs ride a 4-stage ring filled by TMA: [64 x 64] boxes with
//   the 128-byte swizzle (hopper.cuh), 2 of A and BN / 64 of B a stage, one
//   full mbarrier a stage. A box past N, V or D is zero-filled, so ragged
//   tiles need no masking in the products (dlogits' pad columns are 0 as
//   well): the tensor maps' innermost extent is the real D, so a D that is
//   not a multiple of 64 (any multiple of 8: TMA's 16-byte row strides)
//   reads its last K slab of the lse and dlogits products as D columns and
//   zeros, and the D-tail tile of dh and dE stops its stores at D. No
//   producer warpgroup (as the flash kernels, flash_hopper_fwd.cu): thread 0
//   issues the first loads, and the warpgroup that releases a stage
//   last refills it (hopper::release_last), so no thread waits for another;
// - one group of products in flight a warpgroup: slab k's products are issued
//   before slab k-1's are awaited and its stage released;
// - persistent: a grid of one block an SM walks the output tiles (tile
//   blockIdx.x, then + gridDim.x, ...), and the ring runs on from one tile
//   into the next, so a tile's first slabs load under the tile before's last
//   products and its epilogue (from registers: bf16 stores, for dlogits the
//   exponentials first; for the lse a row reduction by quad shuffles, with
//   no shared memory and no barrier) runs while they land. Measured against
//   a block a tile for dE (NVIDIA H100 80GB HBM3, 700 W, N 4096, V 133,258;
//   how: PERF.md section 6): 3.715 against 4.044 ms at D 2048, 5.592
//   against 5.896 ms at D 3072;
// - neighbouring tile indices share an operand slab through L2: for dh and
//   dE the column tiles of one row tile (dlogits comes from device memory
//   about once), for the lse and dlogits the row (token) tiles of one vocab
//   tile (E comes from device memory about once, and h, 16 MB at the main
//   path's shape, stays in L2);
// - each output tile sums its whole K in one block, in a fixed order: no
//   split-K and no atomics, so two launches give the same bits.
// Its times on the card beside its bound and torch.mm's: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ssi::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // rows of an output tile: 2 warpgroups of 64
constexpr int BK = 64;   // K of a slab
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr uint32_t BOX_BYTES = BK * 64 * 2;  // one [64 x 64] box: 8 KB
constexpr int IGNORE = -100;                 // CROSS_ENTROPY_IGNORE_IDX
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1.0e30f;  // the logit of a vocab column at or past V
constexpr int LSE_BN = 256;          // vocab columns of an lse tile: one (m, l) pair a row

template <int BN>
struct Smem {
    bf16 a[STAGES][2][BK * 64];        // A: each warpgroup's 64 rows
    bf16 b[STAGES][BN / 64][BK * 64];  // B: BN / 64 blocks of 64 columns
    uint64_t full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
template <int BN>
constexpr int smem_bytes() {
    return sizeof(Smem<BN>) + 1024;  // + slack to align the tiles to 1024 bytes
}

// the products of one k16 step, m64n128 or m64n256 by the accumulator's size
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void product(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_major_n128<A_MN, B_MN>(d, a, b, acc);
}
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void product(float (&d)[128], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_major_n256<A_MN, B_MN>(d, a, b, acc);
}

// the descriptor of k16 step kk of a slab stored at addr: MN-major, a step is
// 16 rows of K (2048 bytes) and the 64-column blocks lie BOX_BYTES apart;
// K-major, a step is 32 bytes along the row
template <bool MN>
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int kk) {
    return MN ? hw::desc_sw128(addr + kk * 2048, BOX_BYTES, 1024) : hw::desc_sw128(addr + kk * 32, 16, 1024);
}

// Epilogues: a warpgroup's [64 x BN] f32 sums (acc[4j + e]: row `row` for
// e < 2, row + 8 else; column col0 + 8j (+1 for odd e)) out of registers.
// The f32 sums cast to bf16 into C [M, ldc] (dh and dE, contiguous: ldc is
// D); rows past M are not written. TAIL: D is not a multiple of the tile's
// columns, so columns past ldc are not written either (ldc % 8 == 0: a
// column pair never straddles it); without it the instances are those of a
// D that fills its tiles, guard-free.
template <bool TAIL>
struct StoreEpi {
    bf16* c;
    int M, ldc;
    template <int N2>
    __device__ __forceinline__ void operator()(const float (&acc)[N2], int row, int col0) const {
        bf16* out = c + (long long)row * ldc + col0;
#pragma unroll
        for (int j = 0; j < N2 / 4; ++j) {
            if (TAIL && col0 + 8 * j >= ldc) continue;
            if (row < M) *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
            if (row + 8 < M)
                *reinterpret_cast<__nv_bfloat162*>(out + 8LL * ldc + 8 * j) =
                    __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
};

// dlogits from the logits: (exp(logit - lse[row]) - [col == label]) * g in
// bf16 into dl [N, ldv]; an ignored label gives 0, columns in [V, ldv) are
// written 0, columns past ldv and rows past N are not written (ldv % 8 == 0,
// so a column pair never straddles it)
struct DlogitsEpi {
    const float* lse;
    const int* labels;
    const float* g;
    bf16* dl;
    int N, V, ldv;
    __device__ __forceinline__ void row_out(const float (&acc)[128], int hi, int row, int col0) const {
        if (row >= N) return;
        const int lab = labels[row];
        const float gg = lab == IGNORE ? 0.f : *g;
        const float sh = lse[row] * LOG2E;
        bf16* out = dl + (long long)row * ldv;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int col = col0 + 8 * j;
            if (col >= ldv) continue;
            float d0 = 0.f, d1 = 0.f;
            if (col < V) d0 = (hw::exp2_ftz(fmaf(acc[4 * j + 2 * hi], LOG2E, -sh)) - (col == lab ? 1.f : 0.f)) * gg;
            if (col + 1 < V)
                d1 = (hw::exp2_ftz(fmaf(acc[4 * j + 2 * hi + 1], LOG2E, -sh)) - (col + 1 == lab ? 1.f : 0.f)) * gg;
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(d0, d1);
        }
    }
    __device__ __forceinline__ void operator()(const float (&acc)[128], int row, int col0) const {
        row_out(acc, 0, row, col0);
        row_out(acc, 1, row + 8, col0);
    }
};

// The logsumexp's partial pair of each token row over the tile's 256 vocab
// columns: m, the max over the columns below V (the others count as -1e30,
// as the TPU kernel masks them; they hold zero-filled boxes' 0), and l, the
// sum of exp(logit - m) over the same columns, into m_part / l_part
// [n_vtiles, N] at the tile's index col0 / 256; rows past N are not written.
// The four threads of a quad hold a row's 256 columns (64 each): two xor
// shuffles combine m, two more l. No shared memory and no barrier, so the
// next tile's slabs land while it runs.
struct LseEpi {
    float* m_part;
    float* l_part;
    int N, V;
    __device__ __forceinline__ void row_out(const float (&acc)[128], int hi, int row, int col0) const {
        const int lim = V - col0;  // this thread's columns col0 + c are below V where c < lim
        float m = NEG_INF;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            m = fmaxf(m, 8 * j < lim ? acc[4 * j + 2 * hi] : NEG_INF);
            m = fmaxf(m, 8 * j + 1 < lim ? acc[4 * j + 2 * hi + 1] : NEG_INF);
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float sh = m * LOG2E;
        float l0 = 0.f, l1 = 0.f;  // even and odd columns: two chains of adds
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            if (8 * j < lim) l0 += hw::exp2_ftz(fmaf(acc[4 * j + 2 * hi], LOG2E, -sh));
            if (8 * j + 1 < lim) l1 += hw::exp2_ftz(fmaf(acc[4 * j + 2 * hi + 1], LOG2E, -sh));
        }
        float l = l0 + l1;
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (threadIdx.x % 4 == 0 && row < N) {
            const long long idx = (long long)(col0 / LSE_BN) * N + row;
            m_part[idx] = m;
            l_part[idx] = l;
        }
    }
    __device__ __forceinline__ void operator()(const float (&acc)[128], int row, int col0) const {
        row_out(acc, 0, row, col0);
        row_out(acc, 1, row + 8, col0);
    }
};

// C [M, N] = epi(A . B) over K: tile t covers rows m0 = BM * (its row tile)
// and columns n0 = BN * (its column tile); M_FAST numbers the row tiles of a
// column tile consecutively, else the column tiles of a row tile.
template <int BN, bool A_MN, bool B_MN, bool M_FAST, class Epi>
__global__ void __launch_bounds__(THREADS, 1) gemm_hopper_kernel(const __grid_constant__ CUtensorMap ta,
                                                                 const __grid_constant__ CUtensorMap tb, Epi epi,
                                                                 int M, int N, int K) {
    extern __shared__ unsigned char smem_raw[];
    Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(hw::align1024(smem_raw));

    const int m_tiles = (M + BM - 1) / BM;
    const int n_tiles = (N + BN - 1) / BN;
    const int k_slabs = (K + BK - 1) / BK;
    const int tiles = m_tiles * n_tiles;
    const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int n_ring = my_tiles * k_slabs;  // K slabs the ring carries, over all of this block's tiles
    auto tile_of = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
    auto m0_of = [&](int tile) { return (M_FAST ? tile % m_tiles : tile / n_tiles) * BM; };
    auto n0_of = [&](int tile) { return (M_FAST ? tile / m_tiles : tile % n_tiles) * BN; };

    // ring entry r: slab r % k_slabs of this block's tile r / k_slabs, into stage r % STAGES
    auto load = [&](int r) {
        const int tile = tile_of(r / k_slabs);
        const int k0 = (r % k_slabs) * BK;
        const int m0 = m0_of(tile);
        const int n0 = n0_of(tile);
        const int st = r % STAGES;
        hw::mbar_expect_tx(&sm.full[st], (2 + BN / 64) * BOX_BYTES);
        // a box's coordinates are (column, row) of its matrix: (M or N, K) for
        // an MN-major operand, (K, M or N) for a K-major one
#pragma unroll
        for (int w = 0; w < 2; ++w) {
            if constexpr (A_MN)
                hw::tma_load_2d(sm.a[st][w], &ta, &sm.full[st], m0 + 64 * w, k0);
            else
                hw::tma_load_2d(sm.a[st][w], &ta, &sm.full[st], k0, m0 + 64 * w);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
            if constexpr (B_MN)
                hw::tma_load_2d(sm.b[st][j], &tb, &sm.full[st], n0 + 64 * j, k0);
            else
                hw::tma_load_2d(sm.b[st][j], &tb, &sm.full[st], k0, n0 + 64 * j);
        }
    };
    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            hw::mbar_init(&sm.full[st], 1);
            sm.done[st] = 0;
        }
        hw::fence_barrier_init();
        for (int r = 0; r < min(STAGES, n_ring); ++r) load(r);
    }
    __syncthreads();

    const int cw = threadIdx.x / 128;  // this warpgroup's rows: m0 + 64 cw ..
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int t4 = t % 4;
    // both warpgroups are done with ring entry r: the second to say so refills its stage
    auto release = [&](int r) {
        if (t == 0 && hw::release_last(&sm.done[r % STAGES]) && r + STAGES < n_ring) load(r + STAGES);
    };

    float acc[BN / 2];  // [64 x BN]: acc[4j + e], n8 block j of the columns
    for (int i = 0, r = 0; i < my_tiles; ++i) {
        for (int kt = 0; kt < k_slabs; ++kt, ++r) {
            const int st = r % STAGES;
            hw::mbar_wait(&sm.full[st], (r / STAGES) & 1);
            const uint32_t a_addr = hw::opaque(ssi::smem_addr(sm.a[st][cw]));
            const uint32_t b_addr = hw::opaque(ssi::smem_addr(sm.b[st][0]));
            hw::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                product<A_MN, B_MN>(acc, step_desc<A_MN>(a_addr, kk), step_desc<B_MN>(b_addr, kk), kt > 0 || kk > 0);
            hw::wgmma_commit();
            if (kt > 0) {
                hw::wgmma_wait<1>();  // slab kt - 1's products are done
                release(r - 1);
            }
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        release(r - 1);

        const int tile = tile_of(i);
        epi(acc, m0_of(tile) + cw * 64 + warp * 16 + g, n0_of(tile) + 2 * t4);
    }
}

template <int BN, bool A_MN, bool B_MN, bool M_FAST, class Epi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, Epi epi, int M, int N, int K, cudaStream_t stream) {
    static int allowed = 0;
    cudaError_t err = ssi::allow_dynamic_smem(gemm_hopper_kernel<BN, A_MN, B_MN, M_FAST, Epi>, smem_bytes<BN>(), allowed);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
    gemm_hopper_kernel<BN, A_MN, B_MN, M_FAST, Epi>
        <<<std::min(tiles, sms), THREADS, smem_bytes<BN>(), stream>>>(ta, tb, epi, M, N, K);  // a block an SM
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the shapes every product takes: dl [N, V] with row stride ldv (ldv % 8 ==
// 0, 16-byte aligned base), the [*, D] operands contiguous and 16-byte aligned
bool shapes_ok(int N, int V, int D, int ldv) { return N > 0 && V > 0 && D > 0 && D % 8 == 0 && ldv % 8 == 0 && ldv >= V; }

}  // namespace

namespace ssi {

// the logsumexp's vocab tiles: the rows of its (max, sum) scratch [n, N]
int cross_entropy_lse_hopper_splits(int V) { return (V + LSE_BN - 1) / LSE_BN; }

// m_part / l_part [ceil(V / 256), N]: each token row's (max, sum of exp) over
// each 256-column vocab tile of h [N, D] . E [V, D]^T
cudaError_t cross_entropy_lse_hopper_bf16(const void* h, const void* e, float* m_part, float* l_part, int N, int V,
                                          int D, cudaStream_t stream) {
    // no dlogits scratch here: V rounded up to 8 stands for its row stride
    if (!shapes_ok(N, V, D, (V + 7) / 8 * 8) || !aligned16(h) || !aligned16(e)) return cudaErrorInvalidValue;
    CUtensorMap th, te;
    cudaError_t err = hw::map_2d(&th, h, N, D, D, BK);
    if (err == cudaSuccess) err = hw::map_2d(&te, e, V, D, D, BK);
    if (err != cudaSuccess) return err;
    return launch<LSE_BN, false, false, true>(th, te, LseEpi{m_part, l_part, N, V}, N, V, D, stream);
}

// dlogits [N, ldv] from h [N, D], E [V, D], lse [N], labels [N] and the scalar g
cudaError_t cross_entropy_dlogits_hopper_bf16(const void* h, const void* e, const float* lse, const int* labels,
                                              const float* g, void* dl, int N, int V, int D, int ldv,
                                              cudaStream_t stream) {
    if (!shapes_ok(N, V, D, ldv) || !aligned16(h) || !aligned16(e) || !aligned16(dl)) return cudaErrorInvalidValue;
    CUtensorMap th, te;
    cudaError_t err = hw::map_2d(&th, h, N, D, D, BK);
    if (err == cudaSuccess) err = hw::map_2d(&te, e, V, D, D, BK);
    if (err != cudaSuccess) return err;
    const DlogitsEpi epi{lse, labels, g, static_cast<bf16*>(dl), N, V, ldv};
    return launch<256, false, false, true>(th, te, epi, N, V, D, stream);
}

// dh [N, D] = dl . E: dl [N, V] with row stride ldv, E [V, D]; D-column tiles
// of 256 where D is a multiple of 256, else of 128 (the tail tile's E boxes
// past D are zero-filled, its stores stop at D)
cudaError_t cross_entropy_dh_hopper_bf16(const void* dl, const void* e, void* dh, int N, int V, int D, int ldv,
                                         cudaStream_t stream) {
    if (!shapes_ok(N, V, D, ldv) || !aligned16(dl) || !aligned16(e)) return cudaErrorInvalidValue;
    CUtensorMap tdl, te;
    cudaError_t err = hw::map_2d(&tdl, dl, N, V, ldv, BK);
    if (err == cudaSuccess) err = hw::map_2d(&te, e, V, D, D, BK);
    if (err != cudaSuccess) return err;
    bf16* out = static_cast<bf16*>(dh);
    if (D % 256 == 0) return launch<256, false, true, false>(tdl, te, StoreEpi<false>{out, N, D}, N, D, V, stream);
    if (D % 128 == 0) return launch<128, false, true, false>(tdl, te, StoreEpi<false>{out, N, D}, N, D, V, stream);
    return launch<128, false, true, false>(tdl, te, StoreEpi<true>{out, N, D}, N, D, V, stream);
}

// dE [V, D] = dl^T . h: dl [N, V] with row stride ldv, h [N, D]; D-column tiles
// as dh's
cudaError_t cross_entropy_de_hopper_bf16(const void* dl, const void* h, void* de, int N, int V, int D, int ldv,
                                         cudaStream_t stream) {
    if (!shapes_ok(N, V, D, ldv) || !aligned16(dl) || !aligned16(h)) return cudaErrorInvalidValue;
    CUtensorMap tdl, th;
    cudaError_t err = hw::map_2d(&tdl, dl, N, V, ldv, BK);
    if (err == cudaSuccess) err = hw::map_2d(&th, h, N, D, D, BK);
    if (err != cudaSuccess) return err;
    bf16* out = static_cast<bf16*>(de);
    if (D % 256 == 0) return launch<256, true, true, false>(tdl, th, StoreEpi<false>{out, V, D}, V, D, N, stream);
    if (D % 128 == 0) return launch<128, true, true, false>(tdl, th, StoreEpi<false>{out, V, D}, V, D, N, stream);
    return launch<128, true, true, false>(tdl, th, StoreEpi<true>{out, V, D}, V, D, N, stream);
}

}  // namespace ssi
