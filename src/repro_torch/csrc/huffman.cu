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
// Bound on the H100: latency.  The work is a few thousand values; the
// tree's two-queue merge is a serial chain of 2 (n_active - 1) dependent
// picks, and every other phase is a few barrier-separated rounds.
//
// Tree (`tree_kernel`), in four phases:
//   sort     the leaves' stable order by keyed frequency (unused bins
//            keyed INT_MAX / 4), which is the reference's stable argsort:
//            an LSD radix sort of the 32-bit keys with the symbols as
//            values, 8-bit digits, a pass skipped where every key has the
//            same digit.  Each pass ranks a tile of 1,024 keys with
//            `__match_any_sync` within a warp and a scan of per-warp digit
//            counts across warps, on top of a running per-digit base, so
//            it is stable.  It measured faster than the bitonic sort of
//            64-bit (key << 32 | symbol) words it replaced at 1,024 bins
//            (PERF.md §6 has both, and at 16,384).
//   merge    one thread, the reference's picks exactly (the tie rule
//            `lf[i] <= intq[j]` takes the leaf, an empty internal queue
//            takes the leaf, int32 sums wrap), with the loop-carried state
//            in registers: the two leading leaves and the two leading
//            merged nodes (j = 2 t - i, so one counter), the new node's
//            sum entering its window from a register, and the next two of
//            each loaded at the top of the merge for the window after it.
//            Merged nodes not made yet read INT_MAX, so `a <= b` takes the
//            leaf as the reference's empty-queue test does, with no test.
//            The picks are selects, not branches, and a merge stores two
//            words: its node's sum and the number of leaves it took.
//   parents  the whole CTA: a scan of the leaves each merge took gives
//            its leaf and merged-node counters, so its two children.
//   depth    the whole CTA: pointer jumping over the merged nodes
//            (depth += depth[parent]; parent = parent[parent]) until
//            every node points at the root, ceil(log2(depth)) + 1 rounds,
//            then a leaf's length is its parent's depth plus one.
//   scatter  the lengths back through the sorted order.
//
// Canonical codebook (`codebook_kernel`), no sort: a symbol's place in the
// reference's order, (length, symbol) with unused symbols keyed 33, is
// the start of its length's bucket plus the number of earlier symbols in
// the same bucket.  The CTA walks the symbols in chunks of 1,024: a
// warp's rank comes from `__match_any_sync` and `__popc`, a scan of
// per-warp bucket counts across warps and a running per-bucket base carry
// it across warps and chunks.  Lengths above 33 (possible after wrapping
// sums, or in a stored lengths vector) sort after bucket 33 by raw value:
// a second pass ranks those symbols against each other.  The first codes
// are the 33-step u32 recurrence on one thread.
//
// Decode table (`decode_table_kernel`), no per-entry interval decode: the
// decoded length of a peek, 1 + #{l : lmask[l] and peek >= thresh[l]}, is
// monotone in the peek whatever order the thresholds are in (a lengths
// vector of no tree leaves them unordered), so it is constant over an
// entry's span of 2^20 peeks unless a masked threshold lies above the
// span's lowest peek, and at the span's highest peek it is one plus the
// number of masked thresholds in this span or an earlier one.  So each
// masked threshold marks the entry whose span holds it (and sets that
// entry's split bit unless it is the span's lowest peek), and the marks
// at or before an entry give its length: no sort, no search.  Every
// input is loaded before the first barrier; the lengths are counted with
// a shared atomic per symbol (one per distinct length per warp by
// `__match_any_sync` measured slower).  Then every warp forms
// the 32 thresholds itself (lane l - 1 holds length l's), marks those
// that fall among its own 128 entries and counts with one ballot those
// before them, so no barrier follows the count.  A thread takes 4
// consecutive entries (a scan of the marks over the warp): only one of
// length <= 12 and no split gathers its symbol, by `peek_decode`'s index
// and clamps exactly, the 4 gathers in flight together (faster than
// staging the symbols in shared memory), and the 4 entries go out as one
// 16-byte store.
//
// The tree's workspace sits in shared memory up to 8,192 bins, the
// codebook's (the long lengths' list) up to 26,880; above that the wrapper
// passes a global scratch of the same layout, whose size it asks of
// `rt_huffman_*_scratch_bytes`.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = INT_MAX / 4;          // keyed freq of an unused bin
constexpr int kMaxLen = 32;
constexpr int kLutBits = 12;
// dynamic shared memory a CTA may take: the H100's opt-in limit of 227 KB
// less room for the kernels' static arrays
constexpr size_t kMaxSmem = 226 * 1024;
// the codebook's static arrays take up to 16 KB of that room
constexpr size_t kCodebookSmem = kMaxSmem - 16 * 1024;
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;

// The tree's workspace, in ints.  P is k rounded up to whole tiles of
// kThreads.  sym[P] and lf[P + 8] (the sorted order and its keyed freqs)
// live throughout; the rest is shared by the sort (its second buffer, the
// per-warp digit counts and offsets, the digit bases) and, once it is
// done, the merge and the depth pass (the leaves' and the merged nodes'
// parents, the merged nodes' sums and each merge's picks, which the depth
// pass's two (depth, parent) buffers then overwrite).
struct TreeLayout {
    int P, sym, lf;
    int sort_k, sort_v, cnt, off, base;
    int par_leaf, par_node, intq, picks, dep, par2, dep2;
    size_t ints;
};

__host__ __device__ inline TreeLayout tree_layout(int k) {
    TreeLayout L;
    L.P = (k + kThreads - 1) / kThreads * kThreads;
    L.sym = 0;
    L.lf = L.P;
    const int u = 2 * L.P + 8;             // a multiple of 4: int4 access
    L.sort_k = u;
    L.sort_v = u + L.P;
    L.cnt = u + 2 * L.P;
    L.off = L.cnt + kDigits * kWarps;
    L.base = L.off + kDigits * kWarps;
    const int sort_ints = 2 * L.P + 2 * kDigits * kWarps + kDigits;
    L.par_leaf = u;
    L.par_node = u + k;
    L.intq = u + 2 * k;
    L.picks = L.intq + k + 8;
    L.dep = L.intq;
    L.par2 = L.intq + k;
    L.dep2 = L.intq + 2 * k;
    const int merge_rest = k + 8 + (k + 3) / 4;
    const int rest = 3 * k > merge_rest ? 3 * k : merge_rest;
    const int merge_ints = 2 * k + rest;
    L.ints = (size_t)u + (sort_ints > merge_ints ? sort_ints : merge_ints);
    return L;
}

inline size_t tree_bytes(int k) { return 4 * tree_layout(k).ints; }

// the codebook's workspace: the (length << 32 | symbol) words of the
// symbols longer than 33 bits, at most k
inline size_t codebook_bytes(int k) { return 8 * (size_t)k; }

// Opt a kernel into `bytes` of dynamic shared memory once per device (the
// launch's own dynamic size decides what it takes).
template <typename K>
cudaError_t allow_max_smem(K kernel, size_t bytes, int device, bool* done) {
    if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
    const cudaError_t err = rt_allow_smem(kernel, bytes);
    if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
    return err;
}

// One stable LSD pass over P keys (P a multiple of kThreads) by `shift`'s
// digit, kin/vin -> kout/vout; cnt holds zeros on entry and on exit.
__device__ void radix_pass(const unsigned* kin, const int* vin,
                           unsigned* kout, int* vout, int P, int shift,
                           int* cnt, int* off, int* base) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    if (tid < kDigits) base[tid] = 0;
    __syncthreads();
    for (int pos = tid; pos < P; pos += kThreads) {
        const unsigned d = (kin[pos] >> shift) & (kDigits - 1);
        const unsigned peers = __match_any_sync(kFull, d);
        if ((peers & lt) == 0) atomicAdd(&base[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {                       // exclusive scan, 8 digits a lane
        int v[8], total = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            v[e] = base[lane * 8 + e];
            total += v[e];
        }
        int incl = total;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
        }
        int run = incl - total;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            base[lane * 8 + e] = run;
            run += v[e];
        }
    }
    __syncthreads();
    // thread tid scans digit tid / 4 over warps 8 (tid % 4) .. + 7
    const int my_digit = tid >> 2, quarter = tid & 3;
    int4* c4 = (int4*)(cnt + tid * 8);
    int4* o4 = (int4*)(off + tid * 8);
    for (int r = 0; r < P; r += kThreads) {
        const unsigned key = kin[r + tid];
        const int val = vin[r + tid];
        const unsigned d = (key >> shift) & (kDigits - 1);
        const unsigned peers = __match_any_sync(kFull, d);
        const int rank = __popc(peers & lt);
        if (rank == 0) cnt[d * kWarps + warp] = __popc(peers);
        __syncthreads();
        {
            const int4 x = c4[0], y = c4[1];
            const int e1 = x.x, e2 = e1 + x.y, e3 = e2 + x.z, e4 = e3 + x.w;
            const int e5 = e4 + y.x, e6 = e5 + y.y, e7 = e6 + y.z;
            const int total = e7 + y.w;
            int incl = total;
            int up = __shfl_up_sync(kFull, incl, 1, 4);
            if (quarter >= 1) incl += up;
            up = __shfl_up_sync(kFull, incl, 2, 4);
            if (quarter >= 2) incl += up;
            int b = quarter == 0 ? base[my_digit] : 0;
            b = __shfl_sync(kFull, b, 0, 4);
            const int s = b + incl - total;
            o4[0] = make_int4(s, s + e1, s + e2, s + e3);
            o4[1] = make_int4(s + e4, s + e5, s + e6, s + e7);
            c4[0] = make_int4(0, 0, 0, 0);
            c4[1] = make_int4(0, 0, 0, 0);
            if (quarter == 3) base[my_digit] = b + incl;
        }
        __syncthreads();
        const int dst = off[d * kWarps + warp] + rank;
        kout[dst] = key;
        vout[dst] = val;
    }
    __syncthreads();
}

// The same pass when P is one tile: each thread holds one key, so the
// per-warp digit counts scanned in (digit, warp) order give every key's
// place with no digit histogram first (4 barriers, not 6).
__device__ void radix_pass_tile(const unsigned* kin, const int* vin,
                                unsigned* kout, int* vout, int shift,
                                int* cnt, int* off, int* warp_sums) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned key = kin[tid];
    const int val = vin[tid];
    const unsigned d = (key >> shift) & (kDigits - 1);
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lt);
    if (rank == 0) cnt[d * kWarps + warp] = __popc(peers);
    __syncthreads();
    // thread tid holds entries 8 tid .. 8 tid + 7 of the (digit, warp)
    // order: digit tid / 4, warps 8 (tid % 4) .. + 7
    int4* c4 = (int4*)(cnt + tid * 8);
    const int4 x = c4[0], y = c4[1];
    c4[0] = make_int4(0, 0, 0, 0);
    c4[1] = make_int4(0, 0, 0, 0);
    const int e1 = x.x, e2 = e1 + x.y, e3 = e2 + x.z, e4 = e3 + x.w;
    const int e5 = e4 + y.x, e6 = e5 + y.y, e7 = e6 + y.z;
    const int total = e7 + y.w;
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const int wsum = warp_sums[lane];
    int wincl = wsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, wincl, o);
        if (lane >= o) wincl += up;
    }
    const int s = __shfl_sync(kFull, wincl - wsum, warp) + incl - total;
    int4* o4 = (int4*)(off + tid * 8);
    o4[0] = make_int4(s, s + e1, s + e2, s + e3);
    o4[1] = make_int4(s + e4, s + e5, s + e6, s + e7);
    __syncthreads();
    const int dst = off[d * kWarps + warp] + rank;
    kout[dst] = key;
    vout[dst] = val;
    __syncthreads();
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
tree_kernel(const int* __restrict__ freq, int* __restrict__ lengths,
            int* scratch, int k) {
    extern __shared__ __align__(16) int smem_ints[];
    __shared__ int n_active_s;
    __shared__ unsigned and_s, or_s;
    __shared__ int warp_sums[kWarps];
    int* ws = kSmem ? smem_ints : scratch;
    const TreeLayout L = tree_layout(k);
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid == 0) {
        n_active_s = 0;
        and_s = kFull;
        or_s = 0u;
    }
    for (int i = tid; i < kDigits * kWarps; i += kThreads) ws[L.cnt + i] = 0;
    __syncthreads();

    // ---- sort: keys (keyed freq) in lf, values (symbols) in sym; the
    // padding past k keys 0xffffffff and stays last
    int active = 0;
    unsigned kand = kFull, kor = 0u;
    for (int pos = tid; pos < L.P; pos += kThreads) {
        unsigned key = kFull;
        if (pos < k) {
            const int f = freq[pos];
            active += f > 0;
            key = (unsigned)(f > 0 ? f : kBig);
            kand &= key;
            kor |= key;
        }
        ws[L.lf + pos] = (int)key;
        ws[L.sym + pos] = pos;
    }
    active = __reduce_add_sync(kFull, active);
    kand = __reduce_and_sync(kFull, kand);
    kor = __reduce_or_sync(kFull, kor);
    if (lane == 0) {
        if (active) atomicAdd(&n_active_s, active);
        atomicAnd(&and_s, kand);
        atomicOr(&or_s, kor);
    }
    __syncthreads();
    const int n = n_active_s;
    const unsigned differ = and_s ^ or_s;
    unsigned* ka = (unsigned*)(ws + L.lf);
    int* va = ws + L.sym;
    unsigned* kb = (unsigned*)(ws + L.sort_k);
    int* vb = ws + L.sort_v;
    for (int shift = 0; shift < 32; shift += kRadixBits) {
        if (((differ >> shift) & (kDigits - 1)) == 0) continue;
        if (L.P == kThreads)
            radix_pass_tile(ka, va, kb, vb, shift, ws + L.cnt, ws + L.off,
                            warp_sums);
        else
            radix_pass(ka, va, kb, vb, L.P, shift, ws + L.cnt, ws + L.off,
                       ws + L.base);
        unsigned* tk = ka; ka = kb; kb = tk;
        int* tv = va; va = vb; vb = tv;
    }
    if (va != ws + L.sym) {                // an odd number of passes
        for (int pos = tid; pos < L.P; pos += kThreads) {
            ws[L.lf + pos] = (int)ka[pos];
            ws[L.sym + pos] = va[pos];
        }
        __syncthreads();
    }
    // merged nodes not made yet read INT_MAX, which the tie rule compares
    // as an empty internal queue: any leaf is taken before it
    for (int t = tid; t < k + 8; t += kThreads) ws[L.intq + t] = INT_MAX;
    __syncthreads();

    // ---- merge: two-queue, the reference's picks; merged node t's sum in
    // intq[t] and the number of leaves it took (0, 1 or 2) in picks[t]:
    // its children are leaves i.. and merged nodes j = 2 t - i..
    if (tid == 0) {
        const int* lf = ws + L.lf;
        int* intq = ws + L.intq;
        unsigned char* picks = (unsigned char*)(ws + L.picks);
        int i = 0;
        // leaves i, i + 1 and merged nodes j, j + 1 (INT_MAX while not
        // made: `a <= b` then takes the leaf, as an empty queue does)
        int a0 = lf[0], a1 = lf[1];
        int b0 = INT_MAX, b1 = INT_MAX;
#pragma unroll 2
        for (int t = 0; t < n - 1; ++t) {
            const int j = 2 * t - i;
            // the next two of each, for the window after this merge
            const int a2 = lf[i + 2], a3 = lf[i + 3];
            const int q2 = intq[j + 2], q3 = intq[j + 3];
            const bool leaf0 = i < n, leaf1 = i + 1 < n;
            const bool p1 = leaf0 && a0 <= b0;
            const bool p2 = p1 ? leaf1 && a1 <= b0 : leaf0 && a0 <= b1;
            const int f1 = p1 ? a0 : b0;
            const int f2 = p1 ? (p2 ? a1 : b0) : (p2 ? a0 : b1);
            const int sum = (int)((unsigned)f1 + (unsigned)f2);
            const bool two = p1 && p2, none = !p1 && !p2;
            const int leaves = two ? 2 : (none ? 0 : 1);
            intq[t] = sum;
            picks[t] = (unsigned char)leaves;
            // slide the windows by the leaves taken; node t enters as
            // `sum` where it is the head or the one after
            const int na0 = two ? a2 : (none ? a0 : a1);
            const int na1 = two ? a3 : (none ? a1 : a2);
            const int o0 = none ? q2 : (two ? b0 : b1);
            const int o1 = none ? q3 : (two ? b1 : q2);
            i += leaves;
            const int jn = 2 * (t + 1) - i;
            b0 = jn == t ? sum : o0;
            b1 = jn + 1 == t ? sum : o1;
            a0 = na0;
            a1 = na1;
        }
    }
    __syncthreads();

    // ---- parents from the picks: a scan of the leaves taken gives each
    // merge's i, and so its two children; a thread takes a run of merges
    const int m = n - 1;
    {
        const unsigned char* picks = (const unsigned char*)(ws + L.picks);
        int* par_leaf = ws + L.par_leaf;
        int* par_node = ws + L.par_node;
        const int per = (m + kThreads - 1) / kThreads;
        const int t0 = min(tid * per, max(m, 0));
        const int t1 = min(t0 + per, max(m, 0));
        int taken = 0;
        for (int t = t0; t < t1; ++t) taken += picks[t];
        int incl = taken;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) warp_sums[tid >> 5] = incl;
        __syncthreads();
        int i = incl - taken;
        for (int w = 0; w < (tid >> 5); ++w) i += warp_sums[w];
        for (int t = t0; t < t1; ++t) {
            const int leaves = picks[t];
            const int j = 2 * t - i;
            if (leaves > 0) par_leaf[i] = t;
            if (leaves == 2) par_leaf[i + 1] = t;
            if (leaves < 2) par_node[j] = t;
            if (leaves == 0) par_node[j + 1] = t;
            i += leaves;
        }
    }
    __syncthreads();

    // ---- depth: pointer jumping over the m merged nodes (root m - 1);
    // dep[t] is the distance from t to par[t]
    int* pa = ws + L.par_node;
    int* da = ws + L.dep;
    int* pb = ws + L.par2;
    int* db = ws + L.dep2;
    for (int t = tid; t < m; t += kThreads) {
        da[t] = t == m - 1 ? 0 : 1;
        if (t == m - 1) pa[t] = t;
    }
    bool more = __syncthreads_or(m > 1);
    while (more) {
        int changed = 0;
        for (int t = tid; t < m; t += kThreads) {
            const int p = pa[t];
            const int pp = pa[p];
            db[t] = da[t] + da[p];
            pb[t] = pp;
            changed |= pp != p;
        }
        int* tp = pa; pa = pb; pb = tp;
        int* td = da; da = db; db = td;
        more = __syncthreads_or(changed);
    }

    // ---- scatter: a leaf's length is its parent's depth plus one
    const int* par_leaf = ws + L.par_leaf;
    for (int pos = tid; pos < k; pos += kThreads) {
        const int s = ws[L.sym + pos];
        const int d = pos < n && n > 1 ? da[par_leaf[pos]] + 1 : 0;
        lengths[s] = freq[s] > 0 ? (n == 1 ? 1 : d) : 0;
    }
}

// bucket row of a length in the canonical order: lengths 1..32 are rows
// 0..31, length 33 and unused symbols row 32; longer lengths have no row
// (kRows) and are ranked by the second pass
constexpr int kRows = kMaxLen + 1;

__device__ __forceinline__ int row_of(int len) {
    return len > 0 ? (len <= kMaxLen ? len - 1 : (len == kMaxLen + 1
                                                  ? kMaxLen : kRows))
                   : kMaxLen;
}

// histogram classes: lengths 1..32 (0..31), 33 (32), unused (33), longer
// (34)
constexpr int kClasses = kMaxLen + 3;

__device__ __forceinline__ int class_of(int len) {
    return len > 0 ? (len <= kMaxLen + 1 ? len - 1 : kMaxLen + 2) : kMaxLen + 1;
}

__global__ void __launch_bounds__(kThreads)
codebook_kernel(const int* __restrict__ lengths, int* __restrict__ out,
                unsigned long long* scratch, int k) {
    // the outputs, one after another in `out`: codes (u32) and sym_canon
    // [k], first_code (u32) and start_idx [kMaxLen + 1], max_len
    unsigned* __restrict__ codes = (unsigned*)out;
    int* __restrict__ sym_canon = out + k;
    unsigned* __restrict__ first_code = (unsigned*)(out + 2 * k);
    int* __restrict__ start_idx = out + 2 * k + kMaxLen + 1;
    int* __restrict__ max_len = out + 2 * k + 2 * (kMaxLen + 1);
    extern __shared__ __align__(16) unsigned long long long_smem[];
    __shared__ int hist[kClasses];
    __shared__ unsigned fc[kMaxLen + 1];
    __shared__ int st[kMaxLen + 1];
    __shared__ int run[kRows];             // next place in each row
    __shared__ int cnt[kRows * kWarps];    // a chunk's per-warp row counts
    __shared__ int off[kRows * kWarps];    //   and their places
    __shared__ int mx, n_long, long_base;
    unsigned long long* longs = scratch != nullptr ? scratch : long_smem;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    if (tid < kClasses) hist[tid] = 0;
    for (int i = tid; i < kRows * kWarps; i += kThreads) cnt[i] = 0;
    if (tid == 0) {
        mx = INT_MIN;
        n_long = 0;
    }
    __syncthreads();
    int my_max = INT_MIN;
    for (int c = 0; c < k; c += kThreads) {
        const int s = c + tid;
        const int len = s < k ? lengths[s] : 0;
        const int cls = s < k ? class_of(len) : kClasses;
        if (s < k) my_max = max(my_max, len);
        const unsigned peers = __match_any_sync(kFull, cls);
        if ((peers & lt) == 0 && cls < kClasses)
            atomicAdd(&hist[cls], __popc(peers));
    }
    my_max = __reduce_max_sync(kFull, my_max);
    if (lane == 0) atomicMax(&mx, my_max);
    __syncthreads();
    if (tid == 0) {
        // counts per clipped length: length > 32 counts as 32
        // first_code[l] = (first_code[l-1] + count[l-1]) << 1, wrapping
        fc[0] = 0u;
        st[0] = 0;
        int prev = 0;
        for (int l = 1; l <= kMaxLen; ++l) {
            fc[l] = (fc[l - 1] + (unsigned)prev) << 1;
            st[l] = st[l - 1] + prev;
            prev = l < kMaxLen ? hist[l - 1]
                               : hist[kMaxLen - 1] + hist[kMaxLen] +
                                     hist[kMaxLen + 2];
        }
        for (int r = 0; r < kMaxLen; ++r) run[r] = st[r + 1];
        run[kMaxLen] = st[kMaxLen] + hist[kMaxLen - 1];
        long_base = run[kMaxLen] + hist[kMaxLen] + hist[kMaxLen + 1];
        *max_len = mx;
    }
    __syncthreads();
    if (tid <= kMaxLen) {
        first_code[tid] = fc[tid];
        start_idx[tid] = st[tid];
    }
    // the canonical place of every symbol of rows 0..32, chunk by chunk
    for (int c = 0; c < k; c += kThreads) {
        const int s = c + tid;
        const int len = s < k ? lengths[s] : 0;
        const int row = s < k ? row_of(len) : kRows;
        const unsigned peers = __match_any_sync(kFull, row);
        const int rank = __popc(peers & lt);
        if (rank == 0 && row < kRows) cnt[row * kWarps + warp] = __popc(peers);
        __syncthreads();
        for (int r = warp; r < kRows; r += kWarps) {
            const int b = run[r];
            const int v = cnt[r * kWarps + lane];
            int incl = v;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += y;
            }
            off[r * kWarps + lane] = b + incl - v;
            cnt[r * kWarps + lane] = 0;
            if (lane == 31) run[r] = b + incl;
        }
        __syncthreads();
        if (row < kRows) {
            const int pos = off[row * kWarps + warp] + rank;
            sym_canon[pos] = s;
            const int lc = min(len, kMaxLen);
            codes[s] = len > 0 ? fc[lc] + (unsigned)(pos - st[lc]) : 0u;
        }
    }
    if (hist[kMaxLen + 2] == 0) return;    // no length above 33
    // lengths above 33 follow row 32 in (length, symbol) order: each one's
    // rank among them
    for (int s = tid; s < k; s += kThreads) {
        const int len = lengths[s];
        if (len > kMaxLen + 1)
            longs[atomicAdd(&n_long, 1)] =
                ((unsigned long long)(unsigned)len << 32) | (unsigned)s;
    }
    __syncthreads();
    const int nl = n_long;
    for (int e = tid; e < nl; e += kThreads) {
        const unsigned long long me = longs[e];
        int rank = 0;
        for (int f = 0; f < nl; ++f) rank += longs[f] < me;
        const int pos = long_base + rank;
        const int s = (int)(unsigned)(me & 0xffffffffull);
        sym_canon[pos] = s;
        codes[s] = fc[kMaxLen] + (unsigned)(pos - st[kMaxLen]);
    }
}

__global__ void __launch_bounds__(kThreads)
decode_table_kernel(const int* __restrict__ lengths,
                    const unsigned* __restrict__ first_code,
                    const int* __restrict__ start_idx,
                    const int* __restrict__ sym_canon,
                    const int* __restrict__ max_len, int* __restrict__ out,
                    int k) {
    // the outputs, one after another in `out`: lut [kLut], thresh (u32)
    // and lmask [kMaxLen + 1]
    constexpr int kLut = 1 << kLutBits;
    static_assert(kLut == 4 * kThreads, "4 LUT entries a thread");
    constexpr int kSpanBits = 32 - kLutBits;
    constexpr unsigned kSpan = (1u << kSpanBits) - 1u;
    unsigned* __restrict__ thresh = (unsigned*)(out + kLut);
    int* __restrict__ lmask = out + kLut + kMaxLen + 1;
    // marks[e]: masked thresholds in entry e's span of peeks; split[e / 32]
    // bit e % 32: one of them lies above its lowest peek
    __shared__ __align__(16) int marks[kLut];
    __shared__ unsigned split[kLut / 32];
    __shared__ int cnt[kMaxLen + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // every input's first load before the first barrier; lane l - 1 of
    // every warp holds length l's first code and start
    const int l = lane + 1;
    const unsigned fc = first_code[l];
    const int st = start_idx[l];
    const int mx = *max_len;
    const unsigned fc0 = tid == 0 ? first_code[0] : 0u;
    int len = tid < k ? lengths[tid] : 0;
    ((int4*)marks)[tid] = make_int4(0, 0, 0, 0);
    if (tid < kLut / 32) split[tid] = 0u;
    if (tid <= kMaxLen) cnt[tid] = 0;
    __syncthreads();

    // ---- count: clipped lengths, one shared atomic per symbol
    for (int c = 0; c < k; c += kThreads) {
        const int s = c + kThreads + tid;
        const int next = s < k ? lengths[s] : 0;
        const int lc = min(max(len, 0), kMaxLen);
        if (lc > 0) atomicAdd(&cnt[lc], 1);
        len = next;
    }
    __syncthreads();

    // ---- bounds, in every warp: lane l - 1 forms the end of length l's
    // left-aligned interval (length 0's is never masked); a masked one
    // whose entry is among the warp's 128 marks that entry (and sets its
    // split bit unless it is the entry's lowest peek): a warp reads only
    // what it wrote, so no barrier follows
    const unsigned th = (fc + (unsigned)cnt[l]) << (31 - lane);
    const bool masked = l < mx;
    const unsigned p = th >> kSpanBits;
    const int owner = (int)p / (kLut / kWarps);    // the warp of entry p
    if (warp == 0) {
        thresh[l] = th;
        lmask[l] = masked;
        if (lane == 0) {
            thresh[0] = fc0 << 31;
            lmask[0] = 0;
        }
    }
    if (masked && owner == warp) {
        atomicAdd(&marks[p], 1);
        if ((th & kSpan) != 0u) atomicOr(&split[p >> 5], 1u << (p & 31));
    }
    const int below = __popc(__ballot_sync(kFull, masked && owner < warp));
    __syncwarp();

    // ---- LUT: entry e's length at its highest peek is 1 + the marks at
    // or before e (the masked thresholds of earlier warps' entries and a
    // scan of the warp's own marks, 4 consecutive entries a thread); its
    // length at the lowest peek differs where its split bit is set
    const int4 m = ((const int4*)marks)[tid];
    const int r0 = m.x, r1 = r0 + m.y, r2 = r1 + m.z, r3 = r2 + m.w;
    int incl = r3;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
    }
    const unsigned bits = split[tid >> 3] >> ((tid & 7) * 4);
    const int base = below + incl - r3;
    const int rank[4] = {base + r0, base + r1, base + r2, base + r3};
    int ent[4], idx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int ln = rank[i] + 1;
        // `peek_decode`'s symbol index at the low peek, clamps included
        const unsigned low = (unsigned)(4 * tid + i) << kSpanBits;
        const unsigned code = low >> (32 - min(ln, kLutBits));
        long long x = (long long)__shfl_sync(kFull, st, rank[i]) +
                      (int)(code - __shfl_sync(kFull, fc, rank[i]));
        x = x < 0 ? 0 : (x > k - 1 ? k - 1 : x);
        idx[i] = ((bits >> i) & 1u) == 0u && ln <= kLutBits ? (int)x : -1;
        ent[i] = ln;
    }
    // the gathers in flight together, then one 16-byte store
#pragma unroll
    for (int i = 0; i < 4; ++i)
        ent[i] = idx[i] >= 0
                     ? (int)(((unsigned)sym_canon[idx[i]] << 6) | ent[i])
                     : 0;
    ((int4*)out)[tid] = make_int4(ent[0], ent[1], ent[2], ent[3]);
}

// The launch floor: one CTA of kThreads that meets one barrier and does
// nothing else (`yardstick:launch` in chip_smoke.py).
__global__ void __launch_bounds__(kThreads) launch_floor_kernel() {
    __syncthreads();
}

bool tree_smem_set[64], codebook_smem_set[64];

}  // namespace

RT_EXPORT int rt_huffman_tree(int device, const int* freq, int* lengths,
                              void* scratch, int k, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = tree_bytes(k);
    if (scratch == nullptr && bytes > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    if (k <= 0) return (int)cudaGetLastError();
    if (scratch == nullptr) {
        err = allow_max_smem(tree_kernel<true>, kMaxSmem, device,
                             tree_smem_set);
        if (err != cudaSuccess) return (int)err;
        tree_kernel<true><<<1, kThreads, bytes, (cudaStream_t)stream>>>(
            freq, lengths, nullptr, k);
    } else {
        tree_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(
            freq, lengths, (int*)scratch, k);
    }
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_huffman_codebook(int device, const int* lengths, int* out,
                                  void* scratch, int k, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    const size_t bytes = codebook_bytes(k);
    if (scratch == nullptr && bytes > kCodebookSmem)
        return (int)cudaErrorInvalidValue;
    const size_t smem = scratch != nullptr ? 0 : bytes;
    err = allow_max_smem(codebook_kernel, kCodebookSmem, device,
                         codebook_smem_set);
    if (err != cudaSuccess) return (int)err;
    if (k > 0)
        codebook_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
            lengths, out, (unsigned long long*)scratch, k);
    return (int)cudaGetLastError();
}

RT_EXPORT int rt_huffman_decode_table(int device, const int* lengths,
                                      const unsigned* first_code,
                                      const int* start_idx,
                                      const int* sym_canon,
                                      const int* max_len, int* out, int k,
                                      void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    if (k > 0)
        decode_table_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
            lengths, first_code, start_idx, sym_canon, max_len, out, k);
    return (int)cudaGetLastError();
}

// Global scratch bytes the tree's and the codebook's workspaces need at k
// bins: 0 where they fit in shared memory (the wrappers size their
// buffers by these).
RT_EXPORT long long rt_huffman_tree_scratch_bytes(int k) {
    const size_t bytes = tree_bytes(k);
    return bytes > kMaxSmem ? (long long)bytes : 0;
}

RT_EXPORT long long rt_huffman_codebook_scratch_bytes(int k) {
    const size_t bytes = codebook_bytes(k);
    return bytes > kCodebookSmem ? (long long)bytes : 0;
}

RT_EXPORT int rt_launch_floor(int device, void* stream) {
    cudaError_t err = rt_use_device(device);
    if (err != cudaSuccess) return (int)err;
    launch_floor_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
