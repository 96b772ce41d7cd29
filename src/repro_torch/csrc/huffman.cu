// The Huffman codebook stage (cuSZ §3.2.2-3.2.3) on the card: the tree's
// codeword lengths, the canonical codebook, and the decode table of the
// inflate kernel, each one CTA.
//
// Replaces no Pallas kernel: the reference builds this stage with jitted
// device functions, `codeword_lengths` (src/repro/core/huffman.py:113),
// `canonical_codebook` (:184) and `build_decode_table` (:458), so the
// pipeline never reads the card between the histogram and the encode.
// The paper builds its tree on the GPU for the same reason.
//
// Bound on the H100: latency.  The work is a few thousand values, and the
// tree's two-queue merge and depth pass are serial chains of up to
// 2 (n_active - 1) dependent steps, each a few shared-memory round trips.
// Design: the tree kernel sorts (keyed freq << 32 | symbol) with a bitonic
// sort over the CTA (distinct keys, so the order is the reference's stable
// argsort), then one thread runs the merge and the depth pass exactly as
// the reference's loops do (int32 sums that wrap, the tie rule
// `lf[i] <= intq[j]` takes the leaf), and the CTA scatters the depths back
// through the order.  The codebook kernel sorts (length << 32 | symbol) the
// same way for the canonical order and runs the 33-step u32 first-code
// recurrence on one thread.  The decode-table kernel computes each of the
// 4096 LUT entries from two interval decodes of its 12-bit prefix.  The
// sort keys and the tree's queues live in shared memory where they fit
// (nbins up to 8192); above that the wrapper passes a global scratch of the
// same layout, and the kernels reach both through generic pointers.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBig = INT_MAX / 4;          // keyed freq of an unused bin
constexpr int kMaxLen = 32;
constexpr int kLutBits = 12;
// dynamic shared memory a CTA may take: the H100's opt-in limit of 227 KB
// less room for the kernels' static arrays (`huffman.ops.SMEM_BYTES`)
constexpr size_t kMaxSmem = 226 * 1024;

inline int pow2_at_least(int k) {
    int p = 1;
    while (p < k) p <<= 1;
    return p;
}

// the tree's workspace: sort keys u64[p] | intq, ch1, ch2 i32[k] |
// depth i32[2k]
inline size_t tree_bytes(int k) {
    return 8 * (size_t)pow2_at_least(k) + 20 * (size_t)k;
}

// Ascending bitonic sort of n (a power of two) distinct keys by the CTA.
__device__ void block_sort(unsigned long long* keys, int n) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const unsigned long long a = keys[lo], b = keys[hi];
                if ((a > b) == up) {
                    keys[lo] = b;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ int key_hi(unsigned long long key) {
    return (int)(unsigned)(key >> 32);
}

__device__ __forceinline__ int key_lo(unsigned long long key) {
    return (int)(unsigned)(key & 0xffffffffull);
}

__global__ void __launch_bounds__(kThreads)
tree_kernel(const int* __restrict__ freq, int* __restrict__ lengths,
            unsigned char* scratch, int k, int p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int n_active_s;
    unsigned char* base = scratch != nullptr ? scratch : smem;
    unsigned long long* keys = (unsigned long long*)base;
    int* intq = (int*)(keys + p);          // merged-node freqs
    int* ch1 = intq + k;                   // children: leaf i < k,
    int* ch2 = ch1 + k;                    //   internal node k + t
    int* depth = ch2 + k;                  // [2k]: leaves, then internal
    if (threadIdx.x == 0) n_active_s = 0;
    __syncthreads();
    int active = 0;
    for (int s = threadIdx.x; s < p; s += blockDim.x) {
        unsigned long long key = ~0ull;    // padding sorts last
        if (s < k) {
            const int f = freq[s];
            active += f > 0;
            key = ((unsigned long long)(unsigned)(f > 0 ? f : kBig) << 32) |
                  (unsigned)s;
        }
        keys[s] = key;
    }
    for (int i = threadIdx.x; i < 2 * k; i += blockDim.x) depth[i] = 0;
    active = __reduce_add_sync(0xffffffffu, active);
    if ((threadIdx.x & 31) == 0 && active) atomicAdd(&n_active_s, active);
    __syncthreads();
    const int n_active = n_active_s;
    block_sort(keys, p);

    if (threadIdx.x == 0) {
        // two-queue merge: leaves in sorted order, merged nodes in creation
        // order (non-decreasing freq); t merges create internal node t
        int i = 0, j = 0;
        for (int t = 0; t < n_active - 1; ++t) {
            int f[2], node[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int lf = i < n_active ? key_hi(keys[i]) : 0;
                if (i < n_active && (j >= t || lf <= intq[j])) {
                    f[q] = lf;
                    node[q] = i++;
                } else {
                    f[q] = intq[j];
                    node[q] = k + j++;
                }
            }
            intq[t] = (int)((unsigned)f[0] + (unsigned)f[1]);
            ch1[t] = node[0];
            ch2[t] = node[1];
        }
        // parents are created after their children: from the root down
        for (int t = n_active - 2; t >= 0; --t) {
            const int d = depth[k + t] + 1;
            depth[ch1[t]] = d;
            depth[ch2[t]] = d;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const int s = key_lo(keys[i]);
        lengths[s] = freq[s] > 0 ? (n_active == 1 ? 1 : depth[i]) : 0;
    }
}

__global__ void __launch_bounds__(kThreads)
codebook_kernel(const int* __restrict__ lengths, unsigned* __restrict__ codes,
                unsigned* __restrict__ first_code, int* __restrict__ start_idx,
                int* __restrict__ sym_canon, int* __restrict__ max_len,
                unsigned long long* scratch, int k, int p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int cnt[kMaxLen + 1];
    __shared__ unsigned fc[kMaxLen + 1];
    __shared__ int start[kMaxLen + 1];
    __shared__ int mx;
    unsigned long long* keys =
        scratch != nullptr ? scratch : (unsigned long long*)smem;
    if (threadIdx.x <= kMaxLen) cnt[threadIdx.x] = 0;
    if (threadIdx.x == 0) mx = INT_MIN;
    __syncthreads();
    int my_max = INT_MIN;
    for (int s = threadIdx.x; s < p; s += blockDim.x) {
        unsigned long long key = ~0ull;
        if (s < k) {
            const int len = lengths[s];
            my_max = max(my_max, len);
            const int lc = min(max(len, 0), kMaxLen);
            if (lc > 0) atomicAdd(&cnt[lc], 1);
            // canonical order: (length, symbol), unused symbols last
            const unsigned lk = len > 0 ? (unsigned)len : kMaxLen + 1u;
            key = ((unsigned long long)lk << 32) | (unsigned)s;
        }
        keys[s] = key;
    }
    my_max = __reduce_max_sync(0xffffffffu, my_max);
    if ((threadIdx.x & 31) == 0) atomicMax(&mx, my_max);
    __syncthreads();
    if (threadIdx.x == 0) {
        // first_code[l] = (first_code[l-1] + count[l-1]) << 1, wrapping
        fc[0] = 0u;
        start[0] = 0;
        for (int l = 1; l <= kMaxLen; ++l) {
            fc[l] = (fc[l - 1] + (unsigned)cnt[l - 1]) << 1;
            start[l] = start[l - 1] + cnt[l - 1];
        }
        *max_len = mx;
    }
    __syncthreads();
    if (threadIdx.x <= kMaxLen) {
        first_code[threadIdx.x] = fc[threadIdx.x];
        start_idx[threadIdx.x] = start[threadIdx.x];
    }
    block_sort(keys, p);
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const int s = key_lo(keys[i]);
        sym_canon[i] = s;
        const int len = lengths[s];
        const int lc = min(max(len, 0), kMaxLen);
        codes[s] = len > 0 ? fc[lc] + (unsigned)(i - start[lc]) : 0u;
    }
}

// (symbol, codeword length) of a 32-bit left-aligned peek by the canonical
// length-interval compare (`huffman.peek_decode`)
__device__ __forceinline__ void peek_decode(unsigned peek, const unsigned* th,
                                            const int* lm, const unsigned* fc,
                                            const int* st,
                                            const int* __restrict__ sym_canon,
                                            int k, int* sym, int* ln) {
    int len = 1;
#pragma unroll
    for (int l = 0; l <= kMaxLen; ++l) len += (lm[l] != 0) & (peek >= th[l]);
    const int lc = min(max(len, 1), kMaxLen);
    const unsigned code = peek >> (32 - lc);
    long long idx = (long long)st[lc] + (int)(code - fc[lc]);
    idx = idx < 0 ? 0 : (idx > k - 1 ? k - 1 : idx);
    *sym = sym_canon[idx];
    *ln = len;
}

__global__ void __launch_bounds__(kThreads)
decode_table_kernel(const int* __restrict__ lengths,
                    const unsigned* __restrict__ first_code,
                    const int* __restrict__ start_idx,
                    const int* __restrict__ sym_canon,
                    const int* __restrict__ max_len,
                    unsigned* __restrict__ thresh, int* __restrict__ lmask,
                    int* __restrict__ lut, int k) {
    __shared__ int cnt[kMaxLen + 1];
    __shared__ unsigned th[kMaxLen + 1];
    __shared__ int lm[kMaxLen + 1];
    __shared__ unsigned fc[kMaxLen + 1];
    __shared__ int st[kMaxLen + 1];
    if (threadIdx.x <= kMaxLen) cnt[threadIdx.x] = 0;
    __syncthreads();
    for (int s = threadIdx.x; s < k; s += blockDim.x) {
        const int lc = min(max(lengths[s], 0), kMaxLen);
        if (lc > 0) atomicAdd(&cnt[lc], 1);
    }
    __syncthreads();
    if (threadIdx.x <= kMaxLen) {
        const int l = threadIdx.x;
        // end of length l's left-aligned interval
        const unsigned span = first_code[l] + (unsigned)cnt[l];
        th[l] = span << min(max(32 - l, 0), 31);
        lm[l] = l >= 1 && l < *max_len;
        fc[l] = first_code[l];
        st[l] = start_idx[l];
        thresh[l] = th[l];
        lmask[l] = lm[l];
    }
    __syncthreads();
    constexpr int span_bits = 32 - kLutBits;
    for (int e = threadIdx.x; e < (1 << kLutBits); e += blockDim.x) {
        const unsigned low = (unsigned)e << span_bits;
        const unsigned high = low | ((1u << span_bits) - 1u);
        int sym, ln, sym_high, ln_high;
        peek_decode(low, th, lm, fc, st, sym_canon, k, &sym, &ln);
        peek_decode(high, th, lm, fc, st, sym_canon, k, &sym_high, &ln_high);
        lut[e] = ln == ln_high && ln <= kLutBits ? (sym << 6) | ln : 0;
    }
}

}  // namespace

RT_EXPORT int rt_huffman_tree(int device, const int* freq, int* lengths,
                              void* scratch, int k, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = tree_bytes(k);
    if (scratch == nullptr && bytes > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const size_t smem = scratch != nullptr ? 0 : bytes;
    err = rt_allow_smem(tree_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (k > 0)
        tree_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
            freq, lengths, (unsigned char*)scratch, k, pow2_at_least(k));
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_huffman_codebook(int device, const int* lengths,
                                  unsigned* codes, unsigned* first_code,
                                  int* start_idx, int* sym_canon,
                                  int* max_len, void* scratch, int k,
                                  void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const int p = pow2_at_least(k);
    const size_t bytes = 8 * (size_t)p;
    if (scratch == nullptr && bytes > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const size_t smem = scratch != nullptr ? 0 : bytes;
    err = rt_allow_smem(codebook_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (k > 0)
        codebook_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
            lengths, codes, first_code, start_idx, sym_canon, max_len,
            (unsigned long long*)scratch, k, p);
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_huffman_decode_table(int device, const int* lengths,
                                      const unsigned* first_code,
                                      const int* start_idx,
                                      const int* sym_canon,
                                      const int* max_len, unsigned* thresh,
                                      int* lmask, int* lut, int k,
                                      void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    if (k > 0)
        decode_table_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
            lengths, first_code, start_idx, sym_canon, max_len, thresh,
            lmask, lut, k);
    return (int)cudaGetLastError();
}
