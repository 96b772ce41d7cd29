// Fused dual-quant (PREQUANT + blocked Lorenzo delta + POSTQUANT) and its
// inverse (in-block prefix sums + dequant).
//
// Replaces the Pallas TPU kernels `dualquant_blocks_pallas` and
// `reverse_blocks_pallas` (src/repro/kernels/lorenzo/kernel.py:76, :96).
//
// Bound on the H100: device memory.  Dual-quant reads 4 B and writes 8 B
// per value (f32 in; int32 codes and int32 delta out); the reverse reads
// 4 B and writes 4 B.  The arithmetic is a handful of integer operations
// per value, so a kernel reaches the bound only if it spends few
// instructions and no barriers per value.
//
// Dual-quant reads the caller's field where it lies, in its own strides:
// the edge pad and the block split are folded into its addressing, so no
// copy of the field is made before it.  The kernel is given the padded
// block grid (blocks per axis and the element step from one block to the
// next) and the block's non-unit axes (extent, element stride, and the
// field's extent on that axis).  A block's first element is the sum of
// its grid coordinates times their steps; an in-block coordinate past the
// field's extent reads the last value on its axis, which is the
// reference's edge-replicate pad (`jnp.pad(mode="edge")`).  Its output
// is the blocked layout [nb..., b...] over the padded grid, as before.
// The blocked entry passes a blocked tensor's own strides, with extents
// that never clamp.
//
// For the three default blocks, (256), (16,16) and (8,8,8), one warp
// owns one Lorenzo block (eight per 256-thread CTA, on eight consecutive
// blocks of the grid's last axis, so a CTA's rows of a row-major 8^3 grid
// are 256 B runs), with the layout of the reverse below: each lane loads
// 8 or 16 consecutive values of one row of the block's last axis,
// prequantizes them in registers, takes the first difference along that
// axis in place, and along each other axis against the neighbour row
// fetched by one __shfl_up_sync (or a __shfl_sync where the neighbour row
// is in a fixed lane), then stores int4s of codes and delta where the
// blocked layout has them.  Rows are read with 16 B loads where every
// row start is 16 B aligned and the block lies inside the field; a block
// on the ragged edge, or a field whose rows are not 16 B aligned (a view
// that starts 4 B into its storage, a last axis that is not a multiple of
// 4, a last axis that is not unit-stride), takes one clamped scalar load
// per value.  The choice is per warp, so it never diverges.  A first
// difference needs only the immediate neighbour, so that is at most one
// shuffle per value per cross-lane axis; no shared memory, no barrier, no
// runtime divide past the block's grid coordinates (the block shape is a
// compile-time constant of each kernel).  Differences are taken in
// unsigned 32-bit arithmetic, the reference's int32 ring, so any order
// gives the same bits.  Any other block takes the generic kernel, with
// the same addressing: one CTA per Lorenzo block staged in shared memory,
// evaluating the N-D first difference directly as the Lorenzo stencil,
// delta[i] = sum over subsets S of the block axes of (-1)^|S|
// q[i - sum_{a in S} stride_a], over the terms whose coordinates stay
// inside the block (the zero padding layer).  That is the reference's
// cascade of (1 - shift) along each axis, because int32 arithmetic is a
// ring and the terms commute.
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
// Reverse: an inclusive prefix sum along each block axis, then
// __int2float_rn(d) * f32(2*eb).  The default blocks take the same
// warp-per-block layout, scanning the in-register axis in place and the
// other axes across lanes with __shfl_up_sync (4-5.5 shuffles per value),
// then storing float4s.  Any other block (the TPU block table, up to four
// non-unit axes) or unaligned buffer takes the generic kernel: a
// Hillis-Steele scan per axis in two shared buffers, log2(size) barriers
// per axis.
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

constexpr int kMaxGrid = 8;
// values of a block row the generic dual-quant kernel loads per warp step
constexpr int kChunk = 128;

// The field as dual-quant reads it.  The padded block grid's axes are
// right-aligned in `nb` / `step` (axes first .. kMaxGrid-1): block
// (c_first, ..., c_last), numbered row-major, starts at element
// sum c_g * step[g] of x.  The block's axes are those of `dims`
// (right-aligned, leading 1s inert); axis a runs along grid axis
// `axis[a]` (-1 where dims.size[a] is 1) with element stride `stride[a]`
// in x, and the field holds `extent[a]` values along it: in-block
// coordinate i of block c reads min(i, extent[a] - 1 - c * size[a]).
struct Field {
    BlockDims dims;
    int first;
    unsigned nb[kMaxGrid];
    long long step[kMaxGrid];
    int axis[kMaxAxes];
    long long stride[kMaxAxes];
    long long extent[kMaxAxes];
};

// A block's first element in x and, per block axis, the last in-block
// coordinate inside the field (below size - 1 only on the ragged edge)
struct Origin {
    long long base;
    int last[kMaxAxes];
    bool edge;
};

__device__ __forceinline__ Origin origin(const Field& f, unsigned w) {
    Origin o;
    o.base = 0;
    o.edge = false;
    #pragma unroll
    for (int a = 0; a < kMaxAxes; ++a) o.last[a] = f.dims.size[a] - 1;
    #pragma unroll
    for (int g = kMaxGrid - 1; g >= 0; --g) {
        if (g < f.first) break;
        const unsigned c = w % f.nb[g];
        w /= f.nb[g];
        o.base += (long long)c * f.step[g];
        #pragma unroll
        for (int a = 0; a < kMaxAxes; ++a) {
            if (f.axis[a] != g) continue;
            const long long left =
                f.extent[a] - 1 - (long long)c * f.dims.size[a];
            if (left < o.last[a]) {
                o.last[a] = (int)left;
                o.edge = true;
            }
        }
    }
    return o;
}

__global__ void dualquant_kernel(const float* __restrict__ x,
                                 int* __restrict__ codes,
                                 int* __restrict__ delta,
                                 Field f, float inv_two_eb,
                                 int radius) {
    extern __shared__ int q[];
    const BlockDims& d = f.dims;
    const Origin o = origin(f, blockIdx.x);
    const long long base = (long long)blockIdx.x * d.total;
    // a warp loads up to kChunk values of one row of the innermost axis
    // per step, so the row's address costs its divides once per chunk,
    // not once per value
    const int inner = d.size[kMaxAxes - 1];
    const int chunks = (inner + kChunk - 1) / kChunk;
    const int units = d.total / inner * chunks;
    const int lane = threadIdx.x & 31;
    for (int u = threadIdx.x >> 5; u < units; u += blockDim.x >> 5) {
        const int r = u / chunks;
        long long row = o.base;
        int rest = r;
        #pragma unroll
        for (int a = kMaxAxes - 2; a >= 0; --a) {
            if (d.size[a] == 1) continue;
            row += (long long)min(rest % d.size[a], o.last[a]) * f.stride[a];
            rest /= d.size[a];
        }
        const int end = min((u - r * chunks + 1) * kChunk, inner);
        for (int c = (u - r * chunks) * kChunk + lane; c < end; c += 32)
            q[r * inner + c] = __float2int_rn(__fmul_rn(
                __ldg(x + row + (long long)min(c, o.last[kMaxAxes - 1]) *
                                    f.stride[kMaxAxes - 1]),
                inv_two_eb));
    }
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

// lane's 8 consecutive values at `src`, as unsigned
__device__ __forceinline__ void load8(const int* src, unsigned v[8]) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(src));
    const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const unsigned v[8],
                                       float two_eb) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(__int2float_rn((int)v[0]) * two_eb,
                       __int2float_rn((int)v[1]) * two_eb,
                       __int2float_rn((int)v[2]) * two_eb,
                       __int2float_rn((int)v[3]) * two_eb);
    d[1] = make_float4(__int2float_rn((int)v[4]) * two_eb,
                       __int2float_rn((int)v[5]) * two_eb,
                       __int2float_rn((int)v[6]) * two_eb,
                       __int2float_rn((int)v[7]) * two_eb);
}

__device__ __forceinline__ void scan8(unsigned v[8]) {
    #pragma unroll
    for (int i = 1; i < 8; ++i) v[i] += v[i - 1];
}

// add, to lanes with (lane & (width-1)) >= d, the values of lane - d
__device__ __forceinline__ void shfl_add(unsigned v[8], int d, int width,
                                         int lane) {
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        const unsigned t = __shfl_up_sync(0xffffffffu, v[i], d, width);
        if ((lane & (width - 1)) >= d) v[i] += t;
    }
}

constexpr int kWarpsPerCta = 8;

// the warp's Lorenzo block, or -1 past the end
__device__ __forceinline__ long long warp_block(long long nblocks) {
    const long long w = (long long)blockIdx.x * kWarpsPerCta +
                        (threadIdx.x >> 5);
    return w < nblocks ? w : -1;
}

// (256): lane j holds values 8j..8j+7
__global__ void __launch_bounds__(32 * kWarpsPerCta)
reverse_256_kernel(const int* __restrict__ delta, float* __restrict__ out,
                   long long nblocks, float two_eb) {
    const long long w = warp_block(nblocks);
    if (w < 0) return;
    const int lane = threadIdx.x & 31;
    const long long o = w * 256 + lane * 8;
    unsigned v[8];
    load8(delta + o, v);
    scan8(v);
    unsigned tot = v[7];
    #pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, tot, d);
        if (lane >= d) tot += t;
    }
    const unsigned excl = tot - v[7];
    #pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += excl;
    store8(out + o, v, two_eb);
}

// (16, 16): lane j holds row j/2, columns 8(j%2)..8(j%2)+7
__global__ void __launch_bounds__(32 * kWarpsPerCta)
reverse_16x16_kernel(const int* __restrict__ delta, float* __restrict__ out,
                     long long nblocks, float two_eb) {
    const long long w = warp_block(nblocks);
    if (w < 0) return;
    const int lane = threadIdx.x & 31;
    const long long o = w * 256 + lane * 8;
    unsigned v[8];
    load8(delta + o, v);
    scan8(v);
    const unsigned left = __shfl_up_sync(0xffffffffu, v[7], 1);
    if (lane & 1) {
        #pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += left;
    }
    #pragma unroll
    for (int d = 2; d < 32; d <<= 1) shfl_add(v, d, 32, lane);  // rows
    store8(out + o, v, two_eb);
}

// (8, 8, 8): lane j holds the rows (j/8, j%8) and (4 + j/8, j%8) of the
// last axis
__global__ void __launch_bounds__(32 * kWarpsPerCta)
reverse_8x8x8_kernel(const int* __restrict__ delta, float* __restrict__ out,
                     long long nblocks, float two_eb) {
    const long long w = warp_block(nblocks);
    if (w < 0) return;
    const int lane = threadIdx.x & 31;
    const long long o = w * 512 + lane * 8;
    unsigned a[8], b[8];
    load8(delta + o, a);
    load8(delta + o + 256, b);
    scan8(a);                                        // axis 2
    scan8(b);
    #pragma unroll
    for (int d = 1; d < 8; d <<= 1) {                // axis 1
        shfl_add(a, d, 8, lane);
        shfl_add(b, d, 8, lane);
    }
    #pragma unroll
    for (int d = 8; d < 32; d <<= 1) {               // axis 0, within halves
        shfl_add(a, d, 32, lane);
        shfl_add(b, d, 32, lane);
    }
    #pragma unroll
    for (int i = 0; i < 8; ++i)                      // axis 0, across halves
        b[i] += __shfl_sync(0xffffffffu, a[i], 24 + (lane & 7));
    store8(out + o, a, two_eb);
    store8(out + o + 256, b, two_eb);
}

// lane's 8 consecutive values of x, prequantized, as unsigned
__device__ __forceinline__ void load8q(const float* src, float inv_two_eb,
                                       unsigned v[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    #pragma unroll
    for (int i = 0; i < 8; ++i)
        v[i] = (unsigned)__float2int_rn(__fmul_rn(f[i], inv_two_eb));
}

// first difference along the in-register axis; `before` is the value
// left of v[0] (0 at the block edge)
__device__ __forceinline__ void diff8(unsigned v[8], unsigned before) {
    #pragma unroll
    for (int i = 7; i > 0; --i) v[i] -= v[i - 1];
    v[0] -= before;
}

// subtract, on lanes with (lane & (width-1)) >= d, the values of lane - d
__device__ __forceinline__ void shfl_sub(unsigned v[8], int d, int width,
                                         int lane) {
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        const unsigned t = __shfl_up_sync(0xffffffffu, v[i], d, width);
        if ((lane & (width - 1)) >= d) v[i] -= t;
    }
}

__device__ __forceinline__ int cap(unsigned d, int radius) {
    const int di = (int)d;
    return (di > -radius && di < radius) ? di + radius : 0;
}

__device__ __forceinline__ void store8q(int* codes, int* delta,
                                        const unsigned v[8], int radius) {
    int4* c = reinterpret_cast<int4*>(codes);
    int4* d = reinterpret_cast<int4*>(delta);
    c[0] = make_int4(cap(v[0], radius), cap(v[1], radius),
                     cap(v[2], radius), cap(v[3], radius));
    c[1] = make_int4(cap(v[4], radius), cap(v[5], radius),
                     cap(v[6], radius), cap(v[7], radius));
    d[0] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
    d[1] = make_int4((int)v[4], (int)v[5], (int)v[6], (int)v[7]);
}

// lane's 8 values of the block row at in-block coordinates (i1, i2) of
// block axes 1-2, from i3 on along axis 3, prequantized: two 16 B loads
// when `vec` (row starts 16 B aligned, the block inside the field), else
// one load per value at its clamped coordinates
__device__ __forceinline__ void row8q(const float* __restrict__ x,
                                      const Field& f, const Origin& o,
                                      bool vec, int i1, int i2, int i3,
                                      float inv_two_eb, unsigned v[8]) {
    if (vec) {
        load8q(x + o.base + i1 * f.stride[1] + i2 * f.stride[2] + i3,
               inv_two_eb, v);
        return;
    }
    const long long row = o.base + min(i1, o.last[1]) * f.stride[1] +
                          min(i2, o.last[2]) * f.stride[2];
    #pragma unroll
    for (int k = 0; k < 8; ++k)
        v[k] = (unsigned)__float2int_rn(__fmul_rn(
            __ldg(x + row + min(i3 + k, o.last[3]) * f.stride[3]),
            inv_two_eb));
}

// the warp's Lorenzo block, or nblocks past the end
__device__ __forceinline__ unsigned warp_index(unsigned nblocks) {
    const unsigned w = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
    return w < nblocks ? w : nblocks;
}

// (256): lane j holds values 8j..8j+7
__global__ void __launch_bounds__(32 * kWarpsPerCta)
dualquant_256_kernel(const float* __restrict__ x, int* __restrict__ codes,
                     int* __restrict__ delta, Field f, unsigned nblocks,
                     bool vec, float inv_two_eb, int radius) {
    const unsigned w = warp_index(nblocks);
    if (w == nblocks) return;
    const Origin org = origin(f, w);
    const int lane = threadIdx.x & 31;
    const long long o = (long long)w * 256 + lane * 8;
    unsigned v[8];
    row8q(x, f, org, vec && !org.edge, 0, 0, lane * 8, inv_two_eb, v);
    const unsigned left = __shfl_up_sync(0xffffffffu, v[7], 1);
    diff8(v, lane ? left : 0u);
    store8q(codes + o, delta + o, v, radius);
}

// (16, 16): lane j holds row j/2, columns 8(j%2)..8(j%2)+7
__global__ void __launch_bounds__(32 * kWarpsPerCta)
dualquant_16x16_kernel(const float* __restrict__ x, int* __restrict__ codes,
                       int* __restrict__ delta, Field f, unsigned nblocks,
                       bool vec, float inv_two_eb, int radius) {
    const unsigned w = warp_index(nblocks);
    if (w == nblocks) return;
    const Origin org = origin(f, w);
    const int lane = threadIdx.x & 31;
    const long long o = (long long)w * 256 + lane * 8;
    unsigned v[8];
    row8q(x, f, org, vec && !org.edge, 0, lane >> 1, (lane & 1) * 8,
          inv_two_eb, v);
    const unsigned left = __shfl_up_sync(0xffffffffu, v[7], 1);
    diff8(v, (lane & 1) ? left : 0u);                // columns
    shfl_sub(v, 2, 32, lane);                        // rows
    store8q(codes + o, delta + o, v, radius);
}

// (8, 8, 8): lane j holds the rows (j/8, j%8) and (4 + j/8, j%8) of the
// last axis
__global__ void __launch_bounds__(32 * kWarpsPerCta)
dualquant_8x8x8_kernel(const float* __restrict__ x, int* __restrict__ codes,
                       int* __restrict__ delta, Field f, unsigned nblocks,
                       bool vec, float inv_two_eb, int radius) {
    const unsigned w = warp_index(nblocks);
    if (w == nblocks) return;
    const Origin org = origin(f, w);
    const bool v4 = vec && !org.edge;
    const int lane = threadIdx.x & 31;
    const long long o = (long long)w * 512 + lane * 8;
    unsigned a[8], b[8];
    row8q(x, f, org, v4, lane >> 3, lane & 7, 0, inv_two_eb, a);
    row8q(x, f, org, v4, 4 + (lane >> 3), lane & 7, 0, inv_two_eb, b);
    diff8(a, 0u);                                    // axis 2
    diff8(b, 0u);
    shfl_sub(a, 1, 8, lane);                         // axis 1
    shfl_sub(b, 1, 8, lane);
    // axis 0: row 4 + j/8 of b follows row 3 + j/8, which is b of lane
    // j - 8, or a of lane 24 + j for j < 8; lanes 24..31 are read only
    // by lanes 0..7, so each lane offers one register to one shuffle
    #pragma unroll
    for (int i = 0; i < 8; ++i)
        b[i] -= __shfl_sync(0xffffffffu, lane >= 24 ? a[i] : b[i],
                            (lane + 24) & 31);
    shfl_sub(a, 8, 32, lane);                        // axis 0, within a
    store8q(codes + o, delta + o, a, radius);
    store8q(codes + o + 256, delta + o + 256, b, radius);
}

}  // namespace

// `grid`: ngrid pairs (blocks, element step) of the padded block grid, in
// row-major order; `axes`: kMaxAxes quads (size, grid axis or -1, element
// stride, the field's extent) of the block's axes, right-aligned (leading
// unused axes have size 1).
RT_EXPORT int rt_dualquant(int device, const float* x, int* codes,
                           int* delta, int ngrid, const long long* grid,
                           const long long* axes, float inv_two_eb,
                           int nbins, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    if (ngrid < 1 || ngrid > kMaxGrid) return (int)cudaErrorInvalidValue;
    Field f;
    f.first = kMaxGrid - ngrid;
    long long nblocks = 1;
    for (int g = 0; g < ngrid; ++g) {
        nblocks *= grid[2 * g];
        if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        f.nb[f.first + g] = (unsigned)grid[2 * g];
        f.step[f.first + g] = grid[2 * g + 1];
    }
    if (nblocks <= 0) return (int)cudaGetLastError();
    for (int a = 0; a < kMaxAxes; ++a) {
        const long long* q = axes + 4 * a;
        if (q[1] >= ngrid || (q[1] < 0 && q[0] != 1))
            return (int)cudaErrorInvalidValue;
        f.axis[a] = q[1] < 0 ? -1 : f.first + (int)q[1];
        f.stride[a] = q[2];
        f.extent[a] = q[3];
    }
    f.dims = make_dims((int)axes[0], (int)axes[4], (int)axes[8],
                       (int)axes[12]);
    // 16 B row loads: x aligned, the innermost axis unit-stride, and every
    // other step a multiple of four values, so every row start is aligned
    bool vec = (((uintptr_t)x) & 15) == 0 && axes[14] == 1;
    for (int g = 0; g < ngrid; ++g) vec = vec && grid[2 * g + 1] % 4 == 0;
    for (int a = 0; a < kMaxAxes - 1; ++a)
        vec = vec && axes[4 * a + 2] % 4 == 0;
    const bool out_aligned = (((uintptr_t)codes | (uintptr_t)delta) & 15) == 0;
    const int b0 = f.dims.size[0], b1 = f.dims.size[1];
    const int b2 = f.dims.size[2], b3 = f.dims.size[3];
    const unsigned n = (unsigned)nblocks;
    const unsigned warps = (unsigned)rt_cdiv(nblocks, kWarpsPerCta);
    const int radius = nbins / 2;
    cudaStream_t st = (cudaStream_t)stream;
    if (out_aligned && b0 == 1 && b1 == 1 && b2 == 1 && b3 == 256) {
        dualquant_256_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            x, codes, delta, f, n, vec, inv_two_eb, radius);
    } else if (out_aligned && b0 == 1 && b1 == 1 && b2 == 16 && b3 == 16) {
        dualquant_16x16_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            x, codes, delta, f, n, vec, inv_two_eb, radius);
    } else if (out_aligned && b0 == 1 && b1 == 8 && b2 == 8 && b3 == 8) {
        dualquant_8x8x8_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            x, codes, delta, f, n, vec, inv_two_eb, radius);
    } else {
        const size_t smem = (size_t)f.dims.total * sizeof(int);
        err = rt_allow_smem(dualquant_kernel, smem);
        if (err != cudaSuccess) return (int)err;
        dualquant_kernel<<<n, kThreads, smem, st>>>(
            x, codes, delta, f, inv_two_eb, radius);
    }
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_reverse(int device, const int* delta, float* out,
                         long long nblocks, int b0, int b1, int b2, int b3,
                         float two_eb, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks <= 0) return (int)cudaGetLastError();
    const bool aligned =
        (((uintptr_t)delta | (uintptr_t)out) & 15) == 0;
    const unsigned warps = (unsigned)rt_cdiv(nblocks, kWarpsPerCta);
    cudaStream_t st = (cudaStream_t)stream;
    if (aligned && b0 == 1 && b1 == 1 && b2 == 1 && b3 == 256) {
        reverse_256_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            delta, out, nblocks, two_eb);
    } else if (aligned && b0 == 1 && b1 == 1 && b2 == 16 && b3 == 16) {
        reverse_16x16_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            delta, out, nblocks, two_eb);
    } else if (aligned && b0 == 1 && b1 == 8 && b2 == 8 && b3 == 8) {
        reverse_8x8x8_kernel<<<warps, 32 * kWarpsPerCta, 0, st>>>(
            delta, out, nblocks, two_eb);
    } else {
        const BlockDims d = make_dims(b0, b1, b2, b3);
        const size_t smem = 2 * (size_t)d.total * sizeof(int);
        err = rt_allow_smem(reverse_kernel, smem);
        if (err != cudaSuccess) return (int)err;
        reverse_kernel<<<(unsigned)nblocks, kThreads, smem, st>>>(
            delta, out, d, two_eb);
    }
    return (int)cudaGetLastError();
}
