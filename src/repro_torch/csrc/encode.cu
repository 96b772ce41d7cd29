// Huffman encode: per-symbol gather of (canonical codeword, bitwidth).
//
// Replaces the Pallas TPU kernel `encode_pallas`
// (src/repro/kernels/encode/kernel.py:36), which gathered through a
// one-hot matrix product; here it is a plain table lookup.
//
// Bound on the H100: device memory (4 B read, 8 B written per symbol).
// Design: the codebook (nbins x (u32 codeword, i32 width), 8 KB at 1024
// bins) is staged in shared memory once per CTA, then a grid-stride loop
// streams the codes with coalesced loads and stores.  A symbol outside
// [0, nbins) encodes to (0, 0), as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__global__ void encode_kernel(const int* __restrict__ codes,
                              const unsigned* __restrict__ book_codes,
                              const int* __restrict__ book_lens,
                              unsigned* __restrict__ cw, int* __restrict__ bw,
                              long long n, int nbins) {
    extern __shared__ unsigned smem[];
    unsigned* sc = smem;
    int* sl = (int*)(smem + nbins);
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
        sc[b] = book_codes[b];
        sl[b] = book_lens[b];
    }
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const int c = codes[i];
        const bool ok = c >= 0 && c < nbins;
        cw[i] = ok ? sc[c] : 0u;
        bw[i] = ok ? sl[c] : 0;
    }
}

}  // namespace

RT_EXPORT int rt_encode(int device, const int* codes,
                        const unsigned* book_codes, const int* book_lens,
                        unsigned* cw, int* bw, long long n, int nbins,
                        void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = 2 * (size_t)nbins * sizeof(int);
    err = rt_allow_smem(encode_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        long long grid = rt_cdiv(n, kThreads);
        if (grid > kMaxBlocks) grid = kMaxBlocks;
        encode_kernel<<<(unsigned)grid, kThreads, smem,
                        (cudaStream_t)stream>>>(codes, book_codes, book_lens,
                                                cw, bw, n, nbins);
    }
    return (int)cudaGetLastError();
}
