// Gap-array parallel Huffman inflate (phase 2 of Rivera et al., arXiv
// 2201.09118).
//
// Replaces the Pallas TPU kernel `inflate_pallas`
// (src/repro/kernels/inflate/kernel.py:103), which fetched words and table
// entries through one-hot matrix products; here they are plain loads.
//
// Bound on the H100: the serial walk inside a subchunk.  Each cursor
// decodes sub_size symbols one after another, every step depending on the
// previous codeword's length, so the kernel is latency-bound long before
// it moves its bytes (the used stream words read, 4 B per symbol written).
// Design: one thread per subchunk cursor (consecutive threads walk
// consecutive subchunks, so a 4096-symbol chunk with sub_size 128 is one
// warp), the 33-entry canonical tables and the symbol table in shared
// memory, and a branch-free length search: for a 32-bit left-aligned peek
// built from two words with __funnelshift_l, len = 1 + #{l : lmask[l] and
// peek >= thresh[l]}.  A word past the chunk reads as 0.  Positions past
// n_valid write 0 and do not advance the cursor, as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTable = 33;  // MAXLEN + 1

__global__ void inflate_kernel(const unsigned* __restrict__ words,
                               const int* __restrict__ n_valid,
                               const int* __restrict__ gap_bits,
                               const unsigned* __restrict__ thresh_g,
                               const int* __restrict__ lmask_g,
                               const unsigned* __restrict__ first_code_g,
                               const int* __restrict__ start_idx_g,
                               const int* __restrict__ sym_canon_g, int k,
                               int* __restrict__ out, int nc, int W, int sub) {
    extern __shared__ int sym_canon[];
    __shared__ unsigned thresh[kTable];
    __shared__ unsigned first_code[kTable];
    __shared__ int lmask[kTable];
    __shared__ int start_idx[kTable];
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
        thresh[i] = thresh_g[i];
        first_code[i] = first_code_g[i];
        lmask[i] = lmask_g[i];
        start_idx[i] = start_idx_g[i];
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x)
        sym_canon[i] = sym_canon_g[i];
    __syncthreads();

    const int n_sub = W / sub;
    const long long cursor = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (cursor >= (long long)nc * n_sub) return;
    const int c = (int)(cursor / n_sub);
    const int s = (int)(cursor % n_sub);
    const unsigned* row = words + (long long)c * W;
    int* dst = out + (long long)c * W + (long long)s * sub;
    const int nv = n_valid[c];
    int bitpos = gap_bits[cursor];
    for (int i = 0; i < sub; ++i) {
        int sym = 0;
        if (s * sub + i < nv) {
            const int wi = bitpos >> 5;
            const unsigned w0 = wi < W ? row[wi] : 0u;
            const unsigned w1 = wi + 1 < W ? row[wi + 1] : 0u;
            const unsigned peek = __funnelshift_l(w1, w0, bitpos & 31);
            int len = 1;
            #pragma unroll
            for (int l = 0; l < kTable; ++l)
                len += (lmask[l] != 0) & (peek >= thresh[l]);
            const int lc = len < 1 ? 1 : (len > 32 ? 32 : len);
            const unsigned code = peek >> (32 - lc);
            int idx = start_idx[lc] + (int)(code - first_code[lc]);
            idx = idx < 0 ? 0 : (idx > k - 1 ? k - 1 : idx);
            sym = sym_canon[idx];
            bitpos += len;
        }
        dst[i] = sym;
    }
}

}  // namespace

RT_EXPORT int rt_inflate(int device, const unsigned* words,
                         const int* n_valid, const int* gap_bits,
                         const unsigned* thresh,
                         const int* lmask, const unsigned* first_code,
                         const int* start_idx, const int* sym_canon, int k,
                         int* out, int nc, int W, int sub, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)k * sizeof(int);
    err = rt_allow_smem(inflate_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const long long cursors = (long long)nc * (W / sub);
    if (cursors > 0)
        inflate_kernel<<<(unsigned)rt_cdiv(cursors, kThreads), kThreads, smem,
                         (cudaStream_t)stream>>>(
            words, n_valid, gap_bits, thresh, lmask, first_code, start_idx,
            sym_canon, k, out, nc, W, sub);
    return (int)cudaGetLastError();
}
