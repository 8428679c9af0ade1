// Paged attention, the plain-load kernels at the instance HD 256
// (paged_split.cuh), called by paged_split.cu's launch_plain.

#include "paged_split.cuh"

cudaError_t ssi::paged::launch_plain_hd256(int dtype, const Args& a, cudaStream_t st) {
    return launch_hd<256>(dtype, a, st);
}
