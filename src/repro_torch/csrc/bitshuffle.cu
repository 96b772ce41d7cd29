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
// Tiles: a 256-thread CTA owns 128 groups (4096 symbols): 128 / S whole
// chunks, where S is W rounded up to a power of two (W <= 128), or 128
// groups of one chunk (W > 128, the grid's y axis walks the chunk).
// Because S is a power of two, slots, chunks and words come from shifts
// and masks: neither kernel divides.  P is a runtime argument (at most
// 32).  Offsets are 32-bit when the stream holds fewer than 2^31
// symbols and 64-bit otherwise.
//
// Encode: the tile's codes are one contiguous run (whole rows of codes,
// or 4096 symbols of one row), staged in shared memory by one bulk copy
// (cp.async.bulk completing on an mbarrier) of the 16 B-aligned window
// around the run, so a view with a storage offset takes the same path.
// A warp reads one group's 32 symbols and zigzags them; the group is
// then a 32 x 32 bit matrix (lane l, bit p) whose transpose is exactly
// the group's plane words (bit l of lane p's word = bit p of symbol l).
// Five butterfly stages transpose it (one funnel shift, one
// __shfl_xor_sync and one LOP3 each), whatever P is, where P ballots
// take 3-4 instructions per plane.  The chains of dependent shuffles
// bound the kernel, so groups share a transpose:
// three at P <= 10 (10 bit positions each; the default nbins 1024), two
// at P <= 16, and each warp interleaves two transposes.  The lanes with
// a plane word write it to a shared tile laid out as the global
// [k, P, W] rows, XOR-swizzled within each 32-word line so the P lanes
// of a group hit P banks, and the tile leaves as coalesced 4 B stores (a
// warp writes 128 contiguous bytes) instead of P scattered words per
// warp.
//
// Decode: a CTA stages the tile's P plane rows in shared memory as
// [chunk][plane][S] words, with 16 B loads where W is a multiple of 4,
// then each thread rebuilds 4 consecutive symbols of one group from its
// P words, read as shared-memory broadcasts (the 8 threads of a group
// read the same word): the group's 4-bit slice of plane p is spread to
// bit p of four bytes by one multiply ((n * 0x00204081) & 0x01010101, no
// carries), the bytes of planes 0-7, 8-15, ... are transposed into the
// four values with eight __byte_perm, and the values are un-zigzagged
// with (v >> 1) ^ -(v & 1) and stored as one int4.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;                 // whole warps only
constexpr int kTileGroups = 128;              // groups per tile
constexpr int kTileSyms = kTileGroups * 32;   // 4096 codes: 16 KB

// Two 32 x 32 bit transposes across a warp, interleaved (each alone is a
// chain of five dependent shuffles): afterwards bit l of lane p's x[t] is
// bit p of lane l's x[t].  Stage j swaps bit j of the lane with bit j of
// the position: a lane keeps the positions whose bit j equals its own
// and takes the others from lane ^ j, which sends its word rotated by j
// (down from a lane with bit j clear, up from one with it set; the bits
// that wrap land on positions the receiver masks off).
__device__ __forceinline__ void transpose32x2(unsigned (&x)[2], int lane) {
    #pragma unroll
    for (int j = 16; j >= 1; j >>= 1) {
        const unsigned lo = j == 16 ? 0x0000ffffu : j == 8 ? 0x00ff00ffu
                          : j == 4 ? 0x0f0f0f0fu : j == 2 ? 0x33333333u
                          : 0x55555555u;           // positions with bit j clear
        const bool up = lane & j;
        const unsigned keep = up ? ~lo : lo;
        unsigned y[2];
        #pragma unroll
        for (int t = 0; t < 2; ++t)
            y[t] = __shfl_xor_sync(0xffffffffu,
                                   __funnelshift_r(x[t], x[t], up ? 32 - j : j),
                                   j);
        #pragma unroll
        for (int t = 0; t < 2; ++t) x[t] = (x[t] & keep) | (y[t] & ~keep);
    }
}

// Shared-memory slot of word j of an encode output tile: XOR-swizzled
// within its 32-word line and its row (m = 0: not swizzled), so the P
// lanes that store one group's words hit P different banks
__device__ __forceinline__ int swizzle(int j, int sh, int m) {
    return j ^ ((j >> sh) & m);
}

// One tile per CTA: chunks [blockIdx.x * per_tile, ...), groups
// [blockIdx.y * 128, ...) of each; the dynamic shared memory holds the
// output tile, kc * P rows of wv words (at most 128 * P).  Each group
// takes kBits >= P bit positions of a transpose, so 32 / kBits groups
// (a bundle: slots b, b + kSpan, ...) share one.
template <typename Idx, int kBits>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int* __restrict__ codes, unsigned* __restrict__ planes,
              Idx nc, Idx words, int p_count, int half, int s) {
    constexpr int G = 32 / kBits;                     // groups per bundle
    constexpr int kSpan = (kTileGroups + G - 1) / G;  // bundles per tile
    constexpr int kWarps = kThreads / 32;
    __shared__ alignas(128) int sym[kTileSyms + 4];
    __shared__ alignas(8) unsigned long long bar;
    extern __shared__ unsigned out[];
    const int S = 1 << s;
    const int per_tile = kTileGroups >> s;
    const Idx c0 = (Idx)blockIdx.x * per_tile;
    const int kc = nc - c0 < (Idx)per_tile ? (int)(nc - c0) : per_tile;
    const Idx w0 = (Idx)blockIdx.y * kTileGroups;
    const int wv = words - w0 < (Idx)S ? (int)(words - w0) : S;
    // the tile's codes are one contiguous run; the bulk copy moves the
    // 16 B-aligned window around it (a view with a storage offset starts
    // `lead` ints into it; the window never leaves the run's 16 B blocks)
    const int* src = codes + (c0 * words + w0) * 32;
    const int lead = (int)(((uintptr_t)src & 15) >> 2);
    const unsigned bytes = (unsigned)(lead + kc * wv * 32 + 3) / 4 * 16;
    const unsigned b = (unsigned)__cvta_generic_to_shared(&bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                     :: "r"(b), "r"(1) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(b), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];"
            :: "r"((unsigned)__cvta_generic_to_shared(sym)),
               "l"(src - lead), "r"(bytes), "r"(b) : "memory");
    }
    asm volatile(
        "{\n\t.reg .pred done;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n}" :: "r"(b), "r"(0) : "memory");
    const int lane = threadIdx.x & 31;
    const int lw = 31 - __clz(wv);
    const int sh = lw > 5 ? lw : 5;
    const int m = (wv & (wv - 1)) ? 0 : (wv < 32 ? wv : 32) - 1;
    // slot g of bundle bn holds a group of the tile
    auto valid = [&](int bn, int g) {
        return bn < kSpan && g < kTileGroups && (g >> s) < kc &&
               (g & (S - 1)) < wv;
    };
    // two bundles per pass, bn and bn + kWarps
    for (int a = threadIdx.x >> 5; a < kSpan; a += 2 * kWarps) {
        unsigned x[2] = {0u, 0u};
        #pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int bn = a + t * kWarps;
            #pragma unroll
            for (int i = 0; i < G; ++i) {
                const int g = bn + i * kSpan;
                const int d = valid(bn, g)
                    ? sym[lead + ((g >> s) * wv + (g & (S - 1))) * 32 + lane]
                          - half
                    : 0;
                const unsigned v = ((unsigned)d << 1) ^ (unsigned)(d >> 31);
                x[t] |= (v & (~0u >> (32 - kBits))) << (i * kBits);
            }
        }
        transpose32x2(x, lane);
        // lane i * kBits + p holds plane p of slot bn + i * kSpan
        const int p = lane % kBits;
        #pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int bn = a + t * kWarps, g = bn + lane / kBits * kSpan;
            if (lane < G * kBits && p < p_count && valid(bn, g))
                out[swizzle(((g >> s) * p_count + p) * wv + (g & (S - 1)),
                            sh, m)] = x[t];
        }
    }
    __syncthreads();
    const int nrows = kc * p_count;
    if ((Idx)wv == words) {       // whole chunks: the rows are one run
        unsigned* dst = planes + c0 * p_count * words;
        for (int j = threadIdx.x; j < nrows * wv; j += kThreads)
            dst[j] = out[swizzle(j, sh, m)];
    } else {                      // a slice of one chunk: P rows W apart
        for (int i = threadIdx.x; i < nrows * kTileGroups; i += kThreads) {
            const int r = i >> 7, w = i & (kTileGroups - 1);
            if (w < wv)
                planes[(c0 * p_count + r) * words + w0 + w] =
                    out[swizzle(r * wv + w, sh, m)];
        }
    }
}

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

// One tile per CTA, as the encode's; shared memory holds per_tile * P
// rows of S = 1 << s words (per_tile * S = 128)
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

// The tile grid of both kernels for [nc, 32 * words] codes: S = 1 << s
// is W rounded up to a power of two, at most 128.  False if the grid
// does not fit.
bool tile_grid(long long nc, long long words, int* s, dim3* grid) {
    *s = 0;
    while ((1LL << *s) < words && (1 << *s) < kTileGroups) ++*s;
    const long long tiles_x = rt_cdiv(nc, kTileGroups >> *s);
    const long long tiles_y = rt_cdiv(words, kTileGroups);
    if (tiles_x > 0x7fffffffLL || tiles_y > 65535) return false;
    *grid = dim3((unsigned)tiles_x, (unsigned)tiles_y);
    return true;
}

// kBits: the default nbins 1024 (P = 10) takes three groups per
// transpose, P <= 16 two, larger P one
template <typename Idx>
void launch_encode(dim3 grid, size_t smem, cudaStream_t st, const int* codes,
                   unsigned* planes, long long nc, long long words,
                   int p_count, int half, int s) {
    if (p_count <= 10)
        encode_kernel<Idx, 10><<<grid, kThreads, smem, st>>>(
            codes, planes, (Idx)nc, (Idx)words, p_count, half, s);
    else if (p_count <= 16)
        encode_kernel<Idx, 16><<<grid, kThreads, smem, st>>>(
            codes, planes, (Idx)nc, (Idx)words, p_count, half, s);
    else
        encode_kernel<Idx, 32><<<grid, kThreads, smem, st>>>(
            codes, planes, (Idx)nc, (Idx)words, p_count, half, s);
}

}  // namespace

RT_EXPORT int rt_bitshuffle_encode(int device, const int* codes,
                                   unsigned* planes, long long nc,
                                   long long words, int p_count, int nbins,
                                   void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = nc * words * 32;
    if (total <= 0) return (int)cudaGetLastError();
    int s;
    dim3 grid;
    if (!tile_grid(nc, words, &s, &grid)) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kTileGroups * p_count * sizeof(unsigned);
    cudaStream_t st = (cudaStream_t)stream;
    if (total < (1LL << 31))
        launch_encode<unsigned>(grid, smem, st, codes, planes, nc, words,
                                p_count, nbins / 2, s);
    else
        launch_encode<unsigned long long>(grid, smem, st, codes, planes, nc,
                                          words, p_count, nbins / 2, s);
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_bitshuffle_decode(int device, const unsigned* planes,
                                   int* codes, long long nc, long long words,
                                   int p_count, int nbins, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long total = nc * words * 32;
    if (total <= 0) return (int)cudaGetLastError();
    int s;
    dim3 grid;
    if (!tile_grid(nc, words, &s, &grid)) return (int)cudaErrorInvalidValue;
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
