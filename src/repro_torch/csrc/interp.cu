// One level of the multi-level cubic interpolation predictor (cuSZ-i),
// both directions: residual = odd - p(even) and odd = residual + p(even),
// with p = (9 (b + c) - a - d + 8) >> 4 over four neighbouring even
// samples a..d of the edge-padded even row.
//
// Replaces the Pallas TPU kernels `residual_rows_pallas` and
// `odd_rows_pallas` (src/repro/kernels/interp/kernel.py:62, :67), which
// tiled the row axis eight rows at a time.
//
// Bound on the H100: device memory.  Per output value the kernel reads
// the odd (or residual) value and, once over the level, the padded even
// row, and writes one value: about 12 B for a handful of integer
// operations.  Design: tiling by rows does not fit the shapes this sees.
// A HACC level is ONE row of up to 140 M values, a NYX 512^3 level starts
// at 262,144 rows of 256, and the last levels are a few columns wide.  So
// one thread computes one output value of the flattened [R, mo] output
// (grid-stride), with row = i / mo; a warp reads consecutive columns, so
// the four even neighbours come from one or two cache lines that L1
// shares between neighbouring threads.  Offsets are 32-bit where the
// padded even rows fit below 2^31 values (every shape of the paper's
// fields) and 64-bit otherwise.
//
// Rounding: `>>` on a signed int is an arithmetic shift (floor), as
// `jnp`'s is; 9 (b + c) cannot overflow because the compressor keeps
// |prequant| < 2^23.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;   // 64 CTAs per SM, then stride

template <typename Idx, bool kResidual>
__global__ void interp_rows_kernel(const int* __restrict__ pe,
                                   const int* __restrict__ src,
                                   int* __restrict__ out, Idx total, Idx mo,
                                   Idx mp) {
    const Idx stride = (Idx)gridDim.x * blockDim.x;
    for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
        const Idx r = i / mo;
        const Idx c = i - r * mo;
        const int* p = pe + r * mp + c;
        const int a = __ldg(p), b = __ldg(p + 1), cc = __ldg(p + 2),
                  d = __ldg(p + 3);
        const int pred = (9 * (b + cc) - a - d + 8) >> 4;
        const int v = __ldg(src + i);
        out[i] = kResidual ? v - pred : v + pred;
    }
}

template <bool kResidual>
int launch(int device, const int* pe, const int* src, int* out,
           long long rows, long long mo, long long mp, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = rows * mo;
    if (total > 0) {
        long long grid = rt_cdiv(total, kThreads);
        if (grid > kMaxBlocks) grid = kMaxBlocks;
        cudaStream_t s = (cudaStream_t)stream;
        // 32-bit offsets while every index (and i + stride) stays below 2^31
        if (rows * mp + grid * kThreads < (1LL << 31))
            interp_rows_kernel<unsigned, kResidual>
                <<<(unsigned)grid, kThreads, 0, s>>>(
                    pe, src, out, (unsigned)total, (unsigned)mo,
                    (unsigned)mp);
        else
            interp_rows_kernel<unsigned long long, kResidual>
                <<<(unsigned)grid, kThreads, 0, s>>>(
                    pe, src, out, (unsigned long long)total,
                    (unsigned long long)mo, (unsigned long long)mp);
    }
    return (int)cudaGetLastError();
}

}  // namespace

RT_EXPORT int rt_interp_residual(int device, const int* pe, const int* odd,
                                 int* resid, long long rows, long long mo,
                                 long long mp, void* stream) {
    return launch<true>(device, pe, odd, resid, rows, mo, mp, stream);
}

RT_EXPORT int rt_interp_odd(int device, const int* pe, const int* resid,
                            int* odd, long long rows, long long mo,
                            long long mp, void* stream) {
    return launch<false>(device, pe, resid, odd, rows, mo, mp, stream);
}
