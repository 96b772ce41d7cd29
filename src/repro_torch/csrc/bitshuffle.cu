// Fused zigzag + bit-plane shuffle (FZ-GPU) and its inverse.
//
// Replaces the Pallas TPU kernels `encode_planes_pallas` and
// `decode_planes_pallas` (src/repro/kernels/bitshuffle/kernel.py:46, :63),
// which built each plane word as a lane-weighted sum over a [W, 32] tile.
//
// Layout: codes [nc, chunk] int32 with chunk = 32 W; planes [nc, P, W]
// uint32, bit l of planes[c, p, w] = bit p of zigzag(codes[c, 32 w + l]),
// zigzag(d) = (d << 1) ^ (d >> 31) with d = code - nbins / 2.
//
// Bound on the H100: device memory.  Encode reads 4 B per symbol and
// writes P / 8 B (1.25 B at nbins 1024); decode the reverse.  Design:
// because chunk is a multiple of 32, the flat symbol index i IS the
// position of a lane in the grid, and the 32 symbols of one plane word
// are one warp.  Encode: each lane computes its zigzag value, then one
// __ballot_sync per plane gives exactly planes[c, p, w] (symbol 32 w + l
// at bit l); lane p keeps plane p's word and lanes 0..P-1 store them.
// Decode: one thread per symbol reads the P words of its group (the same
// address across the warp, so each is one broadcast load), rebuilds its
// zigzag value bit by bit, and un-zigzags with (v >> 1) ^ -(v & 1).  P is
// a runtime argument (at most 32).  Offsets are 32-bit when the stream
// holds fewer than 2^31 symbols and 64-bit otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;                  // whole warps only
constexpr long long kMaxBlocks = 132LL * 64;

template <typename Idx>
__global__ void encode_kernel(const int* __restrict__ codes,
                              unsigned* __restrict__ planes, Idx total,
                              Idx words, int p_count, int half) {
    const int lane = threadIdx.x & 31;
    const Idx stride = (Idx)gridDim.x * blockDim.x;
    // total is a multiple of 32 and so is the stride: a warp enters and
    // leaves the loop together, so every ballot has all 32 lanes
    for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int d = __ldg(codes + i) - half;
        const unsigned v = ((unsigned)d << 1) ^ (unsigned)(d >> 31);
        unsigned mine = 0;
        for (int p = 0; p < p_count; ++p) {
            const unsigned word = __ballot_sync(0xffffffffu, (v >> p) & 1u);
            if (lane == p) mine = word;
        }
        if (lane < p_count) {
            const Idx q = i >> 5;                 // plane-word index c*W + w
            const Idx c = q / words;
            const Idx w = q - c * words;
            planes[(c * p_count + lane) * words + w] = mine;
        }
    }
}

template <typename Idx>
__global__ void decode_kernel(const unsigned* __restrict__ planes,
                              int* __restrict__ codes, Idx total, Idx words,
                              int p_count, int half) {
    const Idx stride = (Idx)gridDim.x * blockDim.x;
    for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const int l = (int)(i & 31);
        const Idx q = i >> 5;
        const Idx c = q / words;
        const Idx w = q - c * words;
        const unsigned* base = planes + c * p_count * words + w;
        unsigned v = 0;
        for (int p = 0; p < p_count; ++p)
            v |= ((__ldg(base + (Idx)p * words) >> l) & 1u) << p;
        const int vi = (int)v;
        codes[i] = ((vi >> 1) ^ -(vi & 1)) + half;
    }
}

long long grid_for(long long total) {
    const long long g = rt_cdiv(total, kThreads);
    return g > kMaxBlocks ? kMaxBlocks : g;
}

}  // namespace

RT_EXPORT int rt_bitshuffle_encode(int device, const int* codes,
                                   unsigned* planes, long long nc,
                                   long long words, int p_count, int nbins,
                                   void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = nc * words * 32;
    if (total > 0) {
        const long long grid = grid_for(total);
        cudaStream_t s = (cudaStream_t)stream;
        if (total + grid * kThreads < (1LL << 31))
            encode_kernel<unsigned><<<(unsigned)grid, kThreads, 0, s>>>(
                codes, planes, (unsigned)total, (unsigned)words, p_count,
                nbins / 2);
        else
            encode_kernel<unsigned long long>
                <<<(unsigned)grid, kThreads, 0, s>>>(
                    codes, planes, (unsigned long long)total,
                    (unsigned long long)words, p_count, nbins / 2);
    }
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_bitshuffle_decode(int device, const unsigned* planes,
                                   int* codes, long long nc, long long words,
                                   int p_count, int nbins, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = nc * words * 32;
    if (total > 0) {
        const long long grid = grid_for(total);
        cudaStream_t s = (cudaStream_t)stream;
        if (total + grid * kThreads < (1LL << 31))
            decode_kernel<unsigned><<<(unsigned)grid, kThreads, 0, s>>>(
                planes, codes, (unsigned)total, (unsigned)words, p_count,
                nbins / 2);
        else
            decode_kernel<unsigned long long>
                <<<(unsigned)grid, kThreads, 0, s>>>(
                    planes, codes, (unsigned long long)total,
                    (unsigned long long)words, p_count, nbins / 2);
    }
    return (int)cudaGetLastError();
}
