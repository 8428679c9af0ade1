// Paged attention, the plain-load kernels at the instances HD 64 and 128,
// and the entry that picks the instance (paged_split.cuh; HD 256:
// paged_split_hd256.cu).

#include "paged_split.cuh"

cudaError_t ssi::paged::launch_plain(int dtype, const Args& a, cudaStream_t st) {
    return a.hd <= 64    ? launch_hd<64>(dtype, a, st)
           : a.hd <= 128 ? launch_hd<128>(dtype, a, st)
                         : launch_plain_hd256(dtype, a, st);
}
