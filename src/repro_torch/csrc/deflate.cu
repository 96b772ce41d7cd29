// Huffman deflate: bit-pack variable-length codewords into per-chunk u32
// streams and sample the gap arrays (Rivera et al., arXiv 2201.09118).
//
// Replaces the Pallas TPU kernel `deflate_pallas`
// (src/repro/kernels/deflate/kernel.py:69), which placed each fragment
// with two one-hot matrix products; here fragments land with atomicOr.
//
// Bound on the H100: device memory (8 B read per symbol; one u32 word
// written per symbol slot of the dense [nc, chunk] stream buffer).
// Design: one CTA per chunk.  Each thread owns a run of consecutive
// symbols; a block-wide exclusive scan (warp shuffles, then one warp over
// the warp totals) gives every thread the bit offset and valid-symbol
// count at the start of its run.  Each codeword then splits, MSB first,
// into at most two fragments (`hi` at word offs>>5, `lo` at the next)
// OR-ed into the chunk's words held in shared memory (4 B x chunk, 16 KB
// at the default 4096), which a coalesced loop finally stores.  The gap
// arrays are the same exclusive offsets read at every sub-th symbol.  The
// shift clamps mirror the reference exactly; a tail chunk past n sees
// bitwidth 0.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp31(int v) {
    return v < 0 ? 0 : (v > 31 ? 31 : v);
}

__global__ void deflate_kernel(const unsigned* __restrict__ cw,
                               const int* __restrict__ bw, long long n,
                               unsigned* __restrict__ words,
                               int* __restrict__ bits_used,
                               int* __restrict__ gap_bits,
                               int* __restrict__ gap_syms, int chunk, int sub,
                               int per_thread) {
    extern __shared__ unsigned sw[];
    __shared__ int warp_bits[32];
    __shared__ int warp_syms[32];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const long long c0 = (long long)blockIdx.x * chunk;
    const int n_sub = chunk / sub;

    for (int i = t; i < chunk; i += blockDim.x) sw[i] = 0u;

    const int first = t * per_thread;
    const int last = min(first + per_thread, chunk);
    int my_bits = 0, my_syms = 0;
    for (int i = first; i < last; ++i) {
        const long long g = c0 + i;
        const int b = g < n ? bw[g] : 0;
        my_bits += b;
        my_syms += b > 0;
    }

    // block-wide exclusive scan of (bits, valid symbols)
    int inc_bits = my_bits, inc_syms = my_syms;
    for (int o = 1; o < 32; o <<= 1) {
        const int ub = __shfl_up_sync(kFull, inc_bits, o);
        const int us = __shfl_up_sync(kFull, inc_syms, o);
        if (lane >= o) {
            inc_bits += ub;
            inc_syms += us;
        }
    }
    if (lane == 31) {
        warp_bits[warp] = inc_bits;
        warp_syms[warp] = inc_syms;
    }
    __syncthreads();
    if (warp == 0) {
        const int vb = lane < nwarps ? warp_bits[lane] : 0;
        const int vs = lane < nwarps ? warp_syms[lane] : 0;
        int sb = vb, ss = vs;
        for (int o = 1; o < 32; o <<= 1) {
            const int ub = __shfl_up_sync(kFull, sb, o);
            const int us = __shfl_up_sync(kFull, ss, o);
            if (lane >= o) {
                sb += ub;
                ss += us;
            }
        }
        if (lane < nwarps) {
            warp_bits[lane] = sb - vb;
            warp_syms[lane] = ss - vs;
        }
    }
    __syncthreads();
    int offs = warp_bits[warp] + inc_bits - my_bits;
    int nsyms = warp_syms[warp] + inc_syms - my_syms;

    for (int i = first; i < last; ++i) {
        const long long g = c0 + i;
        const int b = g < n ? bw[g] : 0;
        if (i % sub == 0) {
            gap_bits[(long long)blockIdx.x * n_sub + i / sub] = offs;
            gap_syms[(long long)blockIdx.x * n_sub + i / sub] = nsyms;
        }
        if (b > 0) {
            const unsigned w = cw[g];
            const int wi = offs >> 5;
            const int sh = 32 - (offs & 31) - b;
            const unsigned hi = sh >= 0 ? w << clamp31(sh) : w >> clamp31(-sh);
            if (wi < chunk) atomicOr(&sw[wi], hi);
            if (sh < 0 && wi + 1 < chunk)
                atomicOr(&sw[wi + 1], w << clamp31(32 + sh));
        }
        offs += b;
        nsyms += b > 0;
    }
    if (t == blockDim.x - 1) bits_used[blockIdx.x] = offs;
    __syncthreads();
    for (int i = t; i < chunk; i += blockDim.x) words[c0 + i] = sw[i];
}

}  // namespace

RT_EXPORT int rt_deflate(int device, const unsigned* cw, const int* bw,
                         long long n, unsigned* words, int* bits_used,
                         int* gap_bits, int* gap_syms, int nc, int chunk,
                         int sub, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    int threads = chunk < 256 ? (int)rt_cdiv(chunk, 32) * 32 : 256;
    const int per_thread = (int)rt_cdiv(chunk, threads);
    const size_t smem = (size_t)chunk * sizeof(unsigned);
    err = rt_allow_smem(deflate_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (nc > 0)
        deflate_kernel<<<nc, threads, smem, (cudaStream_t)stream>>>(
            cw, bw, n, words, bits_used, gap_bits, gap_syms, chunk, sub,
            per_thread);
    return (int)cudaGetLastError();
}
