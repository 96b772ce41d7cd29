// Histogram of quant codes (cuSZ §3.2.1).
//
// Replaces the Pallas TPU kernel `histogram_pallas`
// (src/repro/kernels/histogram/kernel.py:41), which counted with a one-hot
// matrix product; a TPU device for a scatter that has no place here.
//
// Bound on the H100: device memory (4 B read per code) on paper, but in
// practice shared-memory atomic throughput, because error-bounded codes
// pile onto a few bins around the centre.  Design: the paper's own scheme,
// one private nbins-entry histogram per CTA in shared memory, merged into
// global memory with atomicAdd.  Inside a warp, lanes holding the same bin
// are aggregated with __match_any_sync so one lane adds the popcount: a
// warp whose 32 codes are all the centre bin issues one atomic, not 32.
// Integer counts do not depend on order, so the result is exact.  Codes
// outside [0, nbins) (the pad symbol nbins) are not counted.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;     // a multiple of 32: every lane in a warp
constexpr int kMaxBlocks = 1024;  // runs the same number of iterations

__global__ void histogram_kernel(const int* __restrict__ codes,
                                 int* __restrict__ hist, long long n,
                                 int nbins) {
    extern __shared__ int sh[];
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) sh[b] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const long long i = base + threadIdx.x;
        const int c = i < n ? codes[i] : -1;
        const bool counted = c >= 0 && c < nbins;
        const unsigned peers = __match_any_sync(0xffffffffu,
                                                counted ? c : -1);
        if (counted && lane == __ffs(peers) - 1)
            atomicAdd(&sh[c], __popc(peers));
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x)
        if (sh[b] != 0) atomicAdd(&hist[b], sh[b]);
}

}  // namespace

RT_EXPORT int rt_histogram(int device, const int* codes, int* hist,
                           long long n, int nbins, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    err = cudaMemsetAsync(hist, 0, (size_t)nbins * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)nbins * sizeof(int);
    err = rt_allow_smem(histogram_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        long long grid = rt_cdiv(n, kThreads);
        if (grid > kMaxBlocks) grid = kMaxBlocks;
        histogram_kernel<<<(unsigned)grid, kThreads, smem, s>>>(codes, hist,
                                                                n, nbins);
    }
    return (int)cudaGetLastError();
}
