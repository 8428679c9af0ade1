// The cross-entropy backward's dE product in bf16, designed for Hopper:
// dE [V, D] = dlogits^T . h, from dlogits [N, V] (row stride ldv: the dlogits
// pass's scratch, cross_entropy.cu) and h [N, D].
//
// Replaces the TPU kernel ssi_tpu/ops/cross_entropy_pallas.py `_de_kernel`
// (launched from `_bwd_rule`) in bf16, as cross_entropy.cu lays the backward
// out: its dlogits pass writes dlogits once, and dh and this product read it.
// Semantics kept: f32 accumulation over all N tokens, the bf16 output written
// here; token rows past N (zero-filled by the copy) add nothing, and rows of
// dE past V are not written. The f32 parity path stays in cross_entropy.cu.
//
// What bounds it on Hopper: 2 N V D FLOP (2.24 TFLOP at N 4096, D 2048,
// V 133,258) against the 1.09 GB of dlogits read once: operations. Only wgmma
// reaches the card's tensor-core rate, so the design is the usual Hopper GEMM:
// - output tiles of 128 vocab rows x BN model columns (BN 256, or 128 where D
//   is not a multiple of 256), 2 warpgroups of 64 rows each (256 threads, one
//   block an SM: 192 KB of shared memory at BN 256); each warpgroup issues
//   wgmma m64nBNk16 with both operands MN-major in shared memory: A is
//   dlogits^T, whose M (vocab) is the contiguous dimension of dlogits' rows,
//   and B is h, whose N (D) is contiguous, so the instruction's transpose bits
//   do what a transposing copy would;
// - 64-token K slabs ride a 4-stage ring filled by TMA: [64 tokens x 64
//   columns] boxes with the 128-byte swizzle (hopper.cuh), 2 of dlogits and
//   BN / 64 of h a stage, one full mbarrier a stage. A box past V, D or N is
//   zero-filled, so ragged tiles need no masking in the products. No producer
//   warpgroup (as the flash kernels, flash_hopper_fwd.cu): thread 0 issues the
//   first loads, and the warpgroup that releases a stage last refills it
//   (hopper::release_last), so no thread waits for another;
// - one group of products in flight a warpgroup: slab k's products are issued
//   before slab k-1's are awaited and its stage released;
// - persistent: a grid of one block an SM walks the output tiles (tile
//   blockIdx.x, then + gridDim.x, ...), and the ring runs on from one tile
//   into the next, so a tile's first slabs load under the tile before's last
//   products, and its epilogue (bf16 stores from registers, rows past V
//   skipped) runs while they land. Measured against a block a tile (NVIDIA
//   H100 80GB HBM3, 700 W, N 4096, V 133,258; how: PERF.md section 6): 3.715
//   against 4.044 ms at D 2048, 5.592 against 5.896 ms at D 3072;
// - the D tiles of one vocab tile are neighbouring tile indices, so the blocks
//   working at once share each dlogits slab through L2: dlogits comes from
//   device memory about once, and h (16 MB at the main path's shape) stays in
//   L2;
// - each output tile sums the whole K in one block, in a fixed order: no
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

constexpr int BM = 128;  // vocab rows of an output tile: 2 warpgroups of 64
constexpr int BK = 64;   // tokens of a K slab
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr uint32_t BOX_BYTES = BK * 64 * 2;  // one [64 tokens x 64 columns] box: 8 KB

template <int BN>
struct Smem {
    bf16 a[STAGES][2][BK * 64];         // dlogits: each warpgroup's 64 vocab columns
    bf16 b[STAGES][BN / 64][BK * 64];   // h: BN / 64 blocks of 64 model columns
    uint64_t full[STAGES];
    uint32_t done[STAGES];  // releases of each stage (hopper::release_last)
};
template <int BN>
constexpr int smem_bytes() {
    return sizeof(Smem<BN>) + 1024;  // + slack to align the tiles to 1024 bytes
}

// the products of one k16 step, m64n128 or m64n256 by the accumulator's size
__device__ __forceinline__ void product(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_tt_n128(d, a, b, acc);
}
__device__ __forceinline__ void product(float (&d)[128], uint64_t a, uint64_t b, int acc) {
    hw::wgmma_ss_tt_n256(d, a, b, acc);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) de_hopper_kernel(const __grid_constant__ CUtensorMap tdl,
                                                               const __grid_constant__ CUtensorMap th,
                                                               bf16* __restrict__ de, int N, int V, int D) {
    extern __shared__ unsigned char smem_raw[];
    Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(hw::align1024(smem_raw));

    const int d_tiles = D / BN;
    const int n_tiles = (V + BM - 1) / BM * d_tiles;
    const int k_slabs = (N + BK - 1) / BK;
    const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int n_ring = my_tiles * k_slabs;  // K slabs the ring carries, over all of this block's tiles
    auto tile_of = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };

    // ring entry r: slab r % k_slabs of this block's tile r / k_slabs, into stage r % STAGES
    auto load = [&](int r) {
        const int tile = tile_of(r / k_slabs);
        const int k0 = (r % k_slabs) * BK;
        const int m0 = tile / d_tiles * BM;
        const int n0 = tile % d_tiles * BN;
        const int st = r % STAGES;
        hw::mbar_expect_tx(&sm.full[st], (2 + BN / 64) * BOX_BYTES);
        hw::tma_load_2d(sm.a[st][0], &tdl, &sm.full[st], m0, k0);
        hw::tma_load_2d(sm.a[st][1], &tdl, &sm.full[st], m0 + 64, k0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) hw::tma_load_2d(sm.b[st][j], &th, &sm.full[st], n0 + 64 * j, k0);
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

    const int cw = threadIdx.x / 128;  // this warpgroup's vocab rows: m0 + 64 cw ..
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
            for (int kk = 0; kk < BK / 16; ++kk)  // a k16 step is 16 rows (tokens) of 128 bytes
                product(acc, hw::desc_sw128(a_addr + kk * 2048, BOX_BYTES, 1024),
                        hw::desc_sw128(b_addr + kk * 2048, BOX_BYTES, 1024), kt > 0 || kk > 0);
            hw::wgmma_commit();
            if (kt > 0) {
                hw::wgmma_wait<1>();  // slab kt - 1's products are done
                release(r - 1);
            }
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        release(r - 1);

        // the tile's f32 sums in bf16, from registers; rows past V are not written
        const int tile = tile_of(i);
        const int row = tile / d_tiles * BM + cw * 64 + warp * 16 + g;  // row lo; row hi is row + 8
        bf16* out = de + (long long)row * D + tile % d_tiles * BN + 2 * t4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            if (row < V) *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
            if (row + 8 < V)
                *reinterpret_cast<__nv_bfloat162*>(out + 8LL * D + 8 * j) =
                    __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
}

template <int BN>
cudaError_t launch(const void* dl, const void* h, void* de, int N, int V, int D, int ldv, cudaStream_t stream) {
    CUtensorMap tdl, th;
    cudaError_t err = hw::map_2d(&tdl, dl, N, V, ldv, BK);
    if (err == cudaSuccess) err = hw::map_2d(&th, h, N, D, D, BK);
    if (err != cudaSuccess) return err;
    static int allowed = 0;
    err = ssi::allow_dynamic_smem(de_hopper_kernel<BN>, smem_bytes<BN>(), allowed);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int grid = std::min((V + BM - 1) / BM * (D / BN), sms);  // a block an SM, walking the tiles
    de_hopper_kernel<BN><<<grid, THREADS, smem_bytes<BN>(), stream>>>(tdl, th, static_cast<bf16*>(de), N, V, D);
    return cudaGetLastError();
}

}  // namespace

namespace ssi {

// dE [V, D] = dl^T . h in bf16: dl [N, V] with row stride ldv (ldv % 8 == 0,
// 16-byte aligned base), h [N, D] contiguous, D a multiple of 128
cudaError_t cross_entropy_de_hopper_bf16(const void* dl, const void* h, void* de, int N, int V, int D, int ldv,
                                         cudaStream_t stream) {
    if (N <= 0 || V <= 0 || D <= 0 || D % 128 != 0 || ldv % 8 != 0 || ldv < V) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(dl) | reinterpret_cast<uintptr_t>(h)) % 16 != 0) return cudaErrorInvalidValue;
    return D % 256 == 0 ? launch<256>(dl, h, de, N, V, D, ldv, stream) : launch<128>(dl, h, de, N, V, D, ldv, stream);
}

}  // namespace ssi
