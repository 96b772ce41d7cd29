// Gap-array parallel Huffman inflate (phase 2 of Rivera et al., arXiv
// 2201.09118).
//
// Replaces the Pallas TPU kernel `inflate_pallas`
// (src/repro/kernels/inflate/kernel.py:103), which fetched words and table
// entries through one-hot matrix products; here they are plain loads.
//
// Bound on the H100.  The bytes are the used stream words in and 4 B per
// decoded symbol out, so the output write is nearly all of them.  Each
// cursor walks sub_size dependent steps, so what decides the time is the
// instructions and memory operations of one step, multiplied by the
// symbols, and whether the output stores coalesce.  A first design spent
// 66 shared loads and 33 compares per symbol on the codeword length, two
// dependent global loads per symbol for the peek, and a store per symbol
// that touched one 32 B sector per lane.
//
// Design: one thread per gap-array cursor, as before (consecutive threads
// walk consecutive subchunks, so a 4096-symbol chunk with sub_size 128 is
// one warp).
// - Length and symbol: one shared-memory load from a 4096-entry LUT keyed
//   by the next 12 bits of the stream (`DecodeTable.lut`, built on the
//   host), entry = (sym << 6) | len.  An entry of 0 marks a prefix whose
//   codeword is longer than 12 bits; that peek takes the interval compare
//   len = 1 + #{l : lmask[l] and peek >= thresh[l]}, unchanged, so every
//   peek decodes exactly as before (the LUT holds only resolved prefixes).
// - Stream reads: a 64-bit left-aligned bit buffer in registers holding
//   at least 33 valid bits before each step, refilled one u32 at a time
//   from a word loaded one refill ahead, so a step waits on no global
//   load.  A word past the chunk reads as 0.
// - Stores: each warp stages 16 steps of its 32 cursors in a 2 KB shared
//   tile (XOR-swizzled, so both the per-step writes and the per-cursor
//   reads are conflict-free), then writes two cursors' 16-symbol runs per
//   instruction: two 64 B segments instead of 32 scattered 4 B stores.
// - Occupancy: 16 KB of LUT + 16 KB of tiles + the 33-entry tables per
//   256-thread CTA, all static shared memory.
// Positions past n_valid write 0 and do not advance the cursor, as in the
// reference.
#include "common.cuh"

namespace {

constexpr int kTable = 33;              // MAXLEN + 1
constexpr int kLutBits = 12;            // = repro_torch.core.huffman.LUT_BITS
constexpr int kLut = 1 << kLutBits;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 16;              // symbols staged per cursor

struct Tables {
    unsigned thresh[kTable];
    unsigned first_code[kTable];
    int lmask[kTable];
    int start_idx[kTable];
};

// The interval-compare decode of a 32-bit left-aligned peek, exactly as
// the plain version computes it (the index in 64 bits, then clamped).
__device__ __forceinline__ int interval_decode(unsigned peek, const Tables& t,
                                               const int* __restrict__ sym_canon,
                                               int k, int& len) {
    int n = 1;
    #pragma unroll
    for (int l = 0; l < kTable; ++l)
        n += (t.lmask[l] != 0) & (peek >= t.thresh[l]);
    const int lc = n < 1 ? 1 : (n > 32 ? 32 : n);
    const unsigned code = peek >> (32 - lc);
    long long idx = (long long)t.start_idx[lc] + (int)(code - t.first_code[lc]);
    idx = idx < 0 ? 0 : (idx > k - 1 ? k - 1 : idx);
    len = n;
    return __ldg(sym_canon + idx);
}

__device__ __forceinline__ unsigned word_at(const unsigned* __restrict__ row,
                                            int i, int W) {
    return i < W ? __ldg(row + i) : 0u;
}

__global__ void __launch_bounds__(kThreads)
inflate_kernel(const unsigned* __restrict__ words,
               const int* __restrict__ n_valid,
               const int* __restrict__ gap_bits,
               const unsigned* __restrict__ thresh_g,
               const int* __restrict__ lmask_g,
               const unsigned* __restrict__ first_code_g,
               const int* __restrict__ start_idx_g,
               const int* __restrict__ sym_canon, const int* __restrict__ lut_g,
               int k, int* __restrict__ out, int W, int sub,
               long long n_cursors) {
    __shared__ int lut[kLut];
    __shared__ Tables tab;
    __shared__ int tile[kWarps][32 * kSteps];
    for (int i = threadIdx.x; i < kLut; i += kThreads) lut[i] = lut_g[i];
    for (int i = threadIdx.x; i < kTable; i += kThreads) {
        tab.thresh[i] = thresh_g[i];
        tab.first_code[i] = first_code_g[i];
        tab.lmask[i] = lmask_g[i];
        tab.start_idx[i] = start_idx_g[i];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long cursor = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (cursor - lane >= n_cursors) return;          // the whole warp idles
    int* tw = tile[threadIdx.x >> 5];
    const bool active = cursor < n_cursors;
    const int n_sub = W / sub;

    // cursor state: output offset (-1 when idle), valid steps, bit buffer
    long long off = -1;
    int nsteps = 0, nbits = 0, nxt = 0;
    unsigned long long buf = 0;
    unsigned pre = 0;
    const unsigned* row = words;
    if (active) {
        const long long c = cursor / n_sub;
        const int s = (int)(cursor - c * n_sub);
        off = c * W + (long long)s * sub;
        row = words + c * W;
        const int left = n_valid[c] - s * sub;
        nsteps = left < 0 ? 0 : (left > sub ? sub : left);
        const int bitpos = gap_bits[cursor];
        const int wi = bitpos >> 5;
        const unsigned long long w01 =
            ((unsigned long long)word_at(row, wi, W) << 32) |
            word_at(row, wi + 1, W);
        buf = w01 << (bitpos & 31);
        nbits = 64 - (bitpos & 31);                   // in [33, 64]
        nxt = wi + 2;
        pre = word_at(row, nxt, W);
    }

    for (int g0 = 0; g0 < sub; g0 += kSteps) {
        const int cnt = sub - g0 < kSteps ? sub - g0 : kSteps;
        const int swz = (lane >> 1) & (kSteps - 1);
        for (int j = 0; j < cnt; ++j) {
            int sym = 0;
            if (g0 + j < nsteps) {
                const unsigned peek = (unsigned)(buf >> 32);
                const int e = lut[peek >> (32 - kLutBits)];
                int len = e & 63;
                sym = e >> 6;
                if (e == 0) sym = interval_decode(peek, tab, sym_canon, k, len);
                buf <<= len;
                nbits -= len;
                while (nbits <= 32) {                 // keep >= 33 bits
                    buf |= (unsigned long long)pre << (32 - nbits);
                    nbits += 32;
                    pre = word_at(row, ++nxt, W);
                }
            }
            tw[lane * kSteps + (j ^ swz)] = sym;
        }
        __syncwarp();
        // cursor 2t on lanes 0-15, cursor 2t+1 on lanes 16-31
        const int j = lane & (kSteps - 1);
        #pragma unroll 4
        for (int t = 0; t < 16; ++t) {
            const int src = 2 * t + (lane >> 4);
            const long long o = __shfl_sync(0xffffffffu, off, src);
            if (o >= 0 && j < cnt)
                out[o + g0 + j] = tw[src * kSteps + (j ^ t)];
        }
        __syncwarp();
    }
}

}  // namespace

RT_EXPORT int rt_inflate(int device, const unsigned* words,
                         const int* n_valid, const int* gap_bits,
                         const unsigned* thresh,
                         const int* lmask, const unsigned* first_code,
                         const int* start_idx, const int* sym_canon,
                         const int* lut, int k, int* out, int nc, int W,
                         int sub, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long cursors = (long long)nc * (W / sub);
    if (cursors > 0)
        inflate_kernel<<<(unsigned)rt_cdiv(cursors, kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(
            words, n_valid, gap_bits, thresh, lmask, first_code, start_idx,
            sym_canon, lut, k, out, W, sub, cursors);
    return (int)cudaGetLastError();
}
