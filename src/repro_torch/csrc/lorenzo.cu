// Fused dual-quant (PREQUANT + blocked Lorenzo delta + POSTQUANT) and its
// inverse (in-block prefix sums + dequant).
//
// Replaces the Pallas TPU kernels `dualquant_blocks_pallas` and
// `reverse_blocks_pallas` (src/repro/kernels/lorenzo/kernel.py:76, :96).
//
// Bound on the H100: device memory.  Dual-quant reads 4 B and writes 8 B
// per value (f32 in; int32 codes and int32 delta out); the reverse reads
// 4 B and writes 4 B.  The arithmetic is a handful of integer operations
// per value.  Design: one CTA per Lorenzo block, the block staged once in
// shared memory, so every global byte moves once and coalesced.
//
// Dual-quant evaluates the N-D first difference directly as the Lorenzo
// stencil: delta[i] = sum over subsets S of the block axes of
// (-1)^|S| q[i - sum_{a in S} stride_a], taking only the terms whose
// coordinates stay inside the block (the zero padding layer).  That is
// exactly the reference's cascade of (1 - shift) along each axis, because
// int32 arithmetic is a ring and the terms commute.
//
// PREQUANT is __float2int_rn(__fmul_rn(x, inv_two_eb)) with inv_two_eb =
// f32(1) / f32(2*eb) computed on the host: the reference writes
// rint(x / (2*eb)) with eb a compile-time constant, and XLA compiles that
// division by a constant into a multiply by the f32 reciprocal, so its
// containers (the golden fixture, BENCH_quality.json) hold rint(x * r).
// An IEEE division differs from that on a few rint ties per field; a
// single rounded multiply (no contraction) and round-half-to-even match
// the reference bit for bit.
//
// The reverse runs a Hillis-Steele inclusive scan along each block axis
// in shared memory (two buffers, log2(size) steps per axis), then
// multiplies __int2float_rn(d) by the f32 2*eb.  Integer sums are exact
// in any order, so the result equals the reference's cumsum bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxAxes = 4;
constexpr int kThreads = 256;

struct BlockDims {
    int size[kMaxAxes];    // block extent per axis (leading 1s are inert)
    int stride[kMaxAxes];  // row-major stride inside the block
    int total;             // values per block
};

BlockDims make_dims(int b0, int b1, int b2, int b3) {
    const int s[kMaxAxes] = {b0, b1, b2, b3};
    BlockDims d;
    int st = 1;
    for (int a = kMaxAxes - 1; a >= 0; --a) {
        d.size[a] = s[a];
        d.stride[a] = st;
        st *= s[a];
    }
    d.total = st;
    return d;
}

__global__ void dualquant_kernel(const float* __restrict__ x,
                                 int* __restrict__ codes,
                                 int* __restrict__ delta,
                                 BlockDims d, float inv_two_eb,
                                 int radius) {
    extern __shared__ int q[];
    const long long base = (long long)blockIdx.x * d.total;
    for (int i = threadIdx.x; i < d.total; i += blockDim.x)
        q[i] = __float2int_rn(__fmul_rn(x[base + i], inv_two_eb));
    __syncthreads();
    for (int i = threadIdx.x; i < d.total; i += blockDim.x) {
        int coord[kMaxAxes];
        for (int a = 0; a < kMaxAxes; ++a)
            coord[a] = (i / d.stride[a]) % d.size[a];
        int acc = 0;
        for (int m = 0; m < (1 << kMaxAxes); ++m) {
            int off = 0;
            bool inside = true;
            int sign = 1;
            for (int a = 0; a < kMaxAxes; ++a) {
                if (m & (1 << a)) {
                    inside = inside && coord[a] > 0;
                    off += d.stride[a];
                    sign = -sign;
                }
            }
            if (inside) acc += sign * q[i - off];
        }
        const bool in_cap = acc > -radius && acc < radius;
        codes[base + i] = in_cap ? acc + radius : 0;
        delta[base + i] = acc;
    }
}

__global__ void reverse_kernel(const int* __restrict__ delta,
                               float* __restrict__ out, BlockDims d,
                               float two_eb) {
    extern __shared__ int buf[];
    int* src = buf;
    int* dst = buf + d.total;
    const long long base = (long long)blockIdx.x * d.total;
    for (int i = threadIdx.x; i < d.total; i += blockDim.x)
        src[i] = delta[base + i];
    __syncthreads();
    for (int a = 0; a < kMaxAxes; ++a) {
        for (int off = 1; off < d.size[a]; off <<= 1) {
            const int step = off * d.stride[a];
            for (int i = threadIdx.x; i < d.total; i += blockDim.x) {
                const int c = (i / d.stride[a]) % d.size[a];
                dst[i] = src[i] + (c >= off ? src[i - step] : 0);
            }
            __syncthreads();
            int* t = src;
            src = dst;
            dst = t;
        }
    }
    for (int i = threadIdx.x; i < d.total; i += blockDim.x)
        out[base + i] = __int2float_rn(src[i]) * two_eb;
}

}  // namespace

RT_EXPORT int rt_dualquant(int device, const float* x, int* codes,
                           int* delta, long long nblocks, int b0, int b1,
                           int b2, int b3, float inv_two_eb, int nbins,
                           void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const BlockDims d = make_dims(b0, b1, b2, b3);
    const size_t smem = (size_t)d.total * sizeof(int);
    err = rt_allow_smem(dualquant_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (nblocks > 0)
        dualquant_kernel<<<(unsigned)nblocks, kThreads, smem,
                           (cudaStream_t)stream>>>(x, codes, delta, d,
                                                   inv_two_eb, nbins / 2);
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_reverse(int device, const int* delta, float* out,
                         long long nblocks, int b0, int b1, int b2, int b3,
                         float two_eb, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const BlockDims d = make_dims(b0, b1, b2, b3);
    const size_t smem = 2 * (size_t)d.total * sizeof(int);
    err = rt_allow_smem(reverse_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (nblocks > 0)
        reverse_kernel<<<(unsigned)nblocks, kThreads, smem,
                         (cudaStream_t)stream>>>(delta, out, d, two_eb);
    return (int)cudaGetLastError();
}
