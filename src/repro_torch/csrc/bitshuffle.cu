// Fused zigzag + bit-plane shuffle (FZ-GPU) and its inverse.
//
// Replaces the Pallas TPU kernels `encode_planes_pallas` and
// `decode_planes_pallas` (src/repro/kernels/bitshuffle/kernel.py:46, :63),
// which built each plane word as a lane-weighted sum over a [W, 32] tile.
//
// Layout: codes [nc, chunk] int32 with chunk = 32 W; planes [nc, P, W]
// uint32, bit l of planes[c, p, w] = bit p of zigzag(codes[c, 32 w + l]),
// zigzag(d) = (d << 1) ^ (d >> 31) with d = code - nbins / 2.  A group is
// the 32 symbols of one plane word (w).
//
// Bound on the H100: device memory.  Encode reads 4 B per symbol and
// writes P / 8 B (1.25 B at nbins 1024); decode the reverse.
//
// Encode: because chunk is a multiple of 32, the flat symbol index i IS
// the position of a lane in the grid, and the 32 symbols of one plane
// word are one warp.  Each lane computes its zigzag value, then one
// __ballot_sync per plane gives exactly planes[c, p, w] (symbol 32 w + l
// at bit l); lane p keeps plane p's word and lanes 0..P-1 store them.
//
// Decode: a 256-thread CTA owns a tile of 128 groups: 128 / S whole
// chunks, where S is W rounded up to a power of two (W <= 128), or 128
// groups of one chunk (W > 128, the grid's y axis walks the chunk).  It
// stages the tile's P plane rows in shared memory as [chunk][plane][S]
// words, with 16 B loads where W is a multiple of 4, then each thread
// rebuilds 4 consecutive symbols of one group from its P words, read as
// shared-memory broadcasts (the 8 threads of a group read the same
// word): the group's 4-bit slice of plane p is spread to bit p of four
// bytes by one multiply ((n * 0x00204081) & 0x01010101, no carries), the
// bytes of planes 0-7, 8-15, ... are transposed into the four values with
// eight __byte_perm, and the values are un-zigzagged with
// (v >> 1) ^ -(v & 1) and stored as one int4.  Because S is a power of
// two, slots and rows come from shifts and masks: there is no divide.  P
// is a runtime argument (at most 32).  Offsets are 32-bit when the stream
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

constexpr int kTileGroups = 128;              // groups per decode tile

// 4 consecutive symbols (bits sh..sh+3 of each plane word) from the
// plane words col[0], col[row], ..., col[(P-1) row]
__device__ __forceinline__ int4 decode4(const unsigned* col, int row,
                                        int p_count, int sh, int half) {
    unsigned y[4] = {0u, 0u, 0u, 0u};       // byte s of y[g]: planes 8g..
    #pragma unroll
    for (int p = 0; p < 32; ++p) {
        if (p >= p_count) break;
        const unsigned n = (col[p * row] >> sh) & 15u;
        y[p >> 3] |= ((n * 0x00204081u) & 0x01010101u) << (p & 7);
    }
    const unsigned t0 = __byte_perm(y[0], y[1], 0x5140);
    const unsigned t1 = __byte_perm(y[0], y[1], 0x7362);
    const unsigned t2 = __byte_perm(y[2], y[3], 0x5140);
    const unsigned t3 = __byte_perm(y[2], y[3], 0x7362);
    const int v[4] = {(int)__byte_perm(t0, t2, 0x5410),
                      (int)__byte_perm(t0, t2, 0x7632),
                      (int)__byte_perm(t1, t3, 0x5410),
                      (int)__byte_perm(t1, t3, 0x7632)};
    int c[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = ((v[i] >> 1) ^ -(v[i] & 1)) + half;
    return make_int4(c[0], c[1], c[2], c[3]);
}

// One tile per CTA: chunks [blockIdx.x * per_tile, ...), groups
// [blockIdx.y * 128, ...) of each; shared memory holds per_tile * P rows
// of S = 1 << s words (per_tile * S = 128)
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const unsigned* __restrict__ planes, int* __restrict__ codes,
              Idx nc, Idx words, int p_count, int half, int s, bool vec) {
    extern __shared__ unsigned rows[];
    const int S = 1 << s;
    const int per_tile = kTileGroups >> s;
    const Idx c0 = (Idx)blockIdx.x * per_tile;
    const int kc = nc - c0 < (Idx)per_tile ? (int)(nc - c0) : per_tile;
    const Idx w0 = (Idx)blockIdx.y * kTileGroups;
    const int wv = words - w0 < (Idx)S ? (int)(words - w0) : S;
    const int nrows = kc * p_count;
    const unsigned* src = planes + c0 * p_count * words + w0;
    if (vec) {                                    // S >= 4, W % 4 == 0
        for (int i = threadIdx.x; i < kTileGroups / 4 * p_count;
             i += kThreads) {
            const int r = i >> (s - 2), j = (i & ((S >> 2) - 1)) << 2;
            if (r < nrows && j < wv)
                reinterpret_cast<uint4*>(rows)[i] = __ldg(
                    reinterpret_cast<const uint4*>(src + (Idx)r * words + j));
        }
    } else {
        for (int i = threadIdx.x; i < kTileGroups * p_count; i += kThreads) {
            const int r = i >> s, j = i & (S - 1);
            if (r < nrows && j < wv) rows[i] = __ldg(src + (Idx)r * words + j);
        }
    }
    __syncthreads();
    const int sh = 4 * (threadIdx.x & 7);
    for (int g = threadIdx.x >> 3; g < kTileGroups; g += kThreads / 8) {
        const int k = g >> s, w = g & (S - 1);
        if (k >= kc || w >= wv) continue;
        const int4 c = decode4(rows + k * p_count * S + w, S, p_count, sh,
                               half);
        const Idx o = ((c0 + k) * words + w0 + w) * 32 + sh;
        *reinterpret_cast<int4*>(codes + o) = c;
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
    if (total <= 0) return (int)cudaGetLastError();
    int s = 0;                                   // S = 1 << s: W rounded up
    while ((1LL << s) < words && (1 << s) < kTileGroups) ++s;
    const long long tiles_x = rt_cdiv(nc, kTileGroups >> s);
    const long long tiles_y = rt_cdiv(words, kTileGroups);
    if (tiles_x > 0x7fffffffLL || tiles_y > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y);
    const size_t smem = (size_t)kTileGroups * p_count * sizeof(unsigned);
    const bool vec = (((uintptr_t)planes & 15) == 0) && words % 4 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (total < (1LL << 31))
        decode_kernel<unsigned><<<grid, kThreads, smem, st>>>(
            planes, codes, (unsigned)nc, (unsigned)words, p_count, nbins / 2,
            s, vec);
    else
        decode_kernel<unsigned long long><<<grid, kThreads, smem, st>>>(
            planes, codes, (unsigned long long)nc, (unsigned long long)words,
            p_count, nbins / 2, s, vec);
    return (int)cudaGetLastError();
}
