"""Customized canonical Huffman coding (cuSZ §3.2) in PyTorch.

Stages (paper Fig. 1, bottom):
  1. histogram of quant codes                      -> kernels.histogram
  2. Huffman tree + base codebook                  -> `codeword_lengths`
  3. canonization                                  -> `canonical_codebook`
  4. encode (codebook gather) + deflate (bit-pack) -> `encode`, `deflate`
  decode: gap-array parallel inflate               -> `inflate_gap`
          gap-less (format v1) sequential inflate  -> `inflate`

Stages 2-3 and the decode table dispatch to the codebook kernels
(`repro_torch.kernels.huffman`) like the other stages: on a CUDA tensor
the tree, the canonical codebook and the decode table are built on the
card, so the pipeline reads nothing back between the histogram and the
encode, or between the stored bitlengths and the inflate; on a CPU tensor
their plain versions run.

`encode`, `deflate` and `inflate_gap` here are the plain PyTorch versions
of the CUDA kernels (`repro_torch.kernels.{encode,deflate,inflate}`),
which the pipeline dispatches to.  The sequential decoders of gap-less
streams (`inflate_lut`, `inflate_bitscan`) have no kernel: no TPU kernel
computes them either, and they run as torch ops on the words' device.  Canonical codewords and stream words
are u32: they are stored as `torch.uint32` tensors and computed on as
int64 in [0, 2^32), because PyTorch has no uint32 arithmetic.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.perf.trace import span

MAXLEN = 32          # hard cap on codeword bitlength (u32 stream words)
SUBCHUNK = 128       # default gap-array subchunk (symbols per decode unit)
# the reference's static decode-variant buckets: the sequential decoder of
# gap-less streams walks a dense table up to SEQ_LUT_BITS, bit by bit above
LUT_BUCKETS = (8, 12, 16)
SEQ_LUT_BITS = 16
# peek bits that index the inflate kernel's shared-memory decode table
# (`DecodeTable.lut`, 16 KB); longer codewords take the interval compare
LUT_BITS = 12
_M32 = 0xFFFFFFFF


def bucket_max_len(max_len: int) -> int:
    """Round a practical max codeword length up to the bucket set
    {8, 12, 16}; anything longer maps to MAXLEN (the bit-scan regime)."""
    for b in LUT_BUCKETS:
        if max_len <= b:
            return b
    return MAXLEN


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> a uint32 tensor (same bits)."""
    return x.to(torch.int32).view(torch.uint32)


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 values in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# Tree build -> codeword lengths
# ---------------------------------------------------------------------------

def codeword_lengths_host(freq) -> np.ndarray:
    """Heap-based Huffman (the oracle): bitlength per symbol, 0 for unused
    symbols.  Ties pop by insertion id, so equal frequencies merge in
    symbol order and then in merge order, as in the reference."""
    freq = np.asarray(freq)
    k = freq.shape[0]
    active = [int(s) for s in np.nonzero(freq)[0]]
    if not active:
        return np.zeros(k, np.int32)
    if len(active) == 1:
        out = np.zeros(k, np.int32)
        out[active[0]] = 1
        return out
    heap = [(int(freq[s]), i, (s,)) for i, s in enumerate(active)]
    heapq.heapify(heap)
    lengths = np.zeros(k, np.int64)
    uid = len(heap)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, uid, s1 + s2))
        uid += 1
    return lengths.astype(np.int32)


def codeword_lengths(freq: torch.Tensor, impl: Optional[str] = None
                     ) -> torch.Tensor:
    """Huffman codeword lengths of the histogram `freq`: int32 [k] on its
    device, 0 for unused symbols.  The reference's two-queue merge over
    symbols sorted by frequency (ties in symbol order), by the
    `huffman.tree` kernel or its plain version."""
    with span(_ops.TREE.span):
        if dispatch.resolve(_ops.TREE.name, freq, impl) == "cuda":
            return _ops.tree_cuda(freq)
        return _ref.codeword_lengths_ref(freq)


# ---------------------------------------------------------------------------
# Canonical codebook (paper §3.2.3)
# ---------------------------------------------------------------------------

class Codebook(NamedTuple):
    lengths: torch.Tensor     # [k] int32 bitlength per symbol (0 = unused)
    codes: torch.Tensor       # [k] uint32 canonical codeword (right-aligned)
    first_code: torch.Tensor  # [MAXLEN+1] uint32 first code per length
    start_idx: torch.Tensor   # [MAXLEN+1] int32 first symbol of length l
    sym_canon: torch.Tensor   # [k] int32 symbols in canonical order
    max_len: torch.Tensor     # 0-d int32

    def to(self, device) -> "Codebook":
        return Codebook(*(t.to(device) for t in self))


def canonical_codebook(lengths: torch.Tensor, impl: Optional[str] = None
                       ) -> Codebook:
    """Canonical codes from bitlengths alone (Schwartz-Kallick), on the
    device of `lengths`, by the `huffman.codebook` kernel or its plain
    version.

    Bijective, bitlength-preserving and decodable without the tree via
    (first_code, start_idx, sym_canon)."""
    with span(_ops.CODEBOOK.span):
        if dispatch.resolve(_ops.CODEBOOK.name, lengths, impl) == "cuda":
            return _ops.codebook_cuda(lengths)
        return _ref.canonical_codebook_ref(lengths)


def packed_codebook(cb: Codebook, unit_bits: int) -> torch.Tensor:
    """Paper Fig. 4: a fixed-width unit holding the bitwidth (MSB side)
    and the codeword (LSB side).  `unit_bits` 32 gives one uint32 per
    symbol; 64 gives a [k, 2] uint32 pair (bitwidth, codeword)."""
    if unit_bits == 32:
        return as_u32(((cb.lengths.long() << 26) | u32_values(cb.codes))
                      & _M32)
    return torch.stack([cb.lengths.to(torch.int32).view(torch.uint32),
                        cb.codes], dim=-1)


def select_repr(max_len) -> int:
    """Adaptive codeword representation (paper §3.2.2): 32-bit units when
    max_len + 6 <= 32, else 64."""
    return 32 if int(max_len) + 6 <= 32 else 64


# ---------------------------------------------------------------------------
# Encode + deflate (plain versions of the CUDA kernels)
# ---------------------------------------------------------------------------

def encode(codes: torch.Tensor, cb: Codebook
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook gather: per-symbol (codeword uint32, bitwidth int32),
    flat.  A symbol outside [0, k) encodes to (0, 0)."""
    flat = codes.reshape(-1).long()
    k = cb.lengths.numel()
    ok = (flat >= 0) & (flat < k)
    idx = flat.clamp(0, k - 1)
    cw = torch.where(ok, cb.codes.view(torch.int32)[idx], 0)
    bw = torch.where(ok, cb.lengths[idx], 0)
    return cw.to(torch.int32).view(torch.uint32), bw.to(torch.int32)


def norm_sub_size(chunk_size: int, sub_size: int) -> int:
    """Clamp the gap-array subchunk to the chunk and check divisibility."""
    sub = min(int(sub_size), int(chunk_size))
    if chunk_size % sub:
        raise ValueError(f"sub_size {sub} must divide chunk_size "
                         f"{chunk_size}")
    return sub


def deflate(cw: torch.Tensor, bw: torch.Tensor, chunk_size: int,
            sub_size: int = SUBCHUNK
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate variable-length codes into dense per-chunk bitstreams.

    Exclusive prefix sum of bitwidths = bit offset of every codeword; each
    codeword contributes <= 2 disjoint u32 fragments (MSB-first), summed
    into place (add == OR on disjoint bits).  The prefix sums sampled at
    every `sub_size`-th symbol are the gap arrays.

    Returns (words[nc, chunk_size] uint32, bits_used[nc] int32,
    gap_bits[nc, chunk_size//sub_size] int32, gap_syms[...] int32)."""
    sub = norm_sub_size(chunk_size, sub_size)
    dev = cw.device
    n = cw.numel()
    nc = -(-n // chunk_size)
    pad = nc * chunk_size - n
    cw64 = torch.nn.functional.pad(u32_values(cw.reshape(-1)), (0, pad))
    bw32 = torch.nn.functional.pad(bw.reshape(-1).to(torch.int32), (0, pad))
    cw64 = cw64.reshape(nc, chunk_size)
    bw32 = bw32.reshape(nc, chunk_size)

    offs = torch.cumsum(bw32, dim=1, dtype=torch.int32) - bw32  # exclusive
    bits_used = (offs[:, -1] + bw32[:, -1]).to(torch.int32)
    gap_bits = offs[:, ::sub].contiguous()
    valid = bw32 > 0
    v32 = valid.to(torch.int32)
    gap_syms = (torch.cumsum(v32, dim=1, dtype=torch.int32) - v32)[:, ::sub]

    w = (offs >> 5).long()
    sh = (32 - (offs & 31) - bw32).long()
    hi = torch.where(sh >= 0, (cw64 << sh.clamp(0, 31)) & _M32,
                     cw64 >> (-sh).clamp(0, 31))
    lo = torch.where(sh < 0, (cw64 << (32 + sh).clamp(0, 31)) & _M32, 0)
    hi = torch.where(valid, hi, 0)
    lo = torch.where(valid, lo, 0)

    # fragments whose word falls outside the chunk are dropped, via a
    # spill slot past the end
    row = torch.arange(nc, device=dev).unsqueeze(1) * chunk_size
    spill = nc * chunk_size
    out = torch.zeros(spill + 1, dtype=torch.int64, device=dev)
    for word, frag in ((w, hi), (w + 1, lo)):
        slot = torch.where((word >= 0) & (word < chunk_size), row + word,
                           spill)
        out.scatter_add_(0, slot.reshape(-1), frag.reshape(-1))
    words = as_u32(out[:spill] & _M32).reshape(nc, chunk_size)
    return words, bits_used, gap_bits, gap_syms.contiguous()


# ---------------------------------------------------------------------------
# Gap-array two-phase decode (Rivera et al., arXiv 2201.09118)
# ---------------------------------------------------------------------------

class DecodeTable(NamedTuple):
    """What the decode side derives from a codebook, built once per
    codebook (see `decode_table`).

    Left-aligned canonical code intervals tile [0, 2^32) contiguously in
    length order, so for a 32-bit left-aligned peek of a valid stream the
    codeword length is

        len = 1 + sum_l lmask[l] * [peek >= thresh[l]]

    with thresh[l] = (first_code[l] + count[l]) << (32 - l) and lmask
    enabling 1 <= l < max_len.  This one decoder serves every max-length
    regime (the reference's LUT variant gives the same symbols).

    `lut` caches that decode for the first LUT_BITS bits of a peek: entry
    p is (sym << 6) | len whenever every peek starting with p decodes to
    the same (sym, len) with len <= LUT_BITS, else 0 (the peek needs the
    interval compare).  See `kernels.huffman.ref.build_lut_ref`."""
    cb: Codebook
    thresh: torch.Tensor      # [MAXLEN + 1] uint32 end-of-interval bounds
    lmask: torch.Tensor       # [MAXLEN + 1] int32 validity of each bound
    lut: torch.Tensor         # [2^LUT_BITS] int32 packed (sym, len) or 0


def peek_decode(peek: torch.Tensor, cb: Codebook, thresh: torch.Tensor,
                lmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(symbol int32, codeword length int64) of int64 32-bit left-aligned
    peeks, by the canonical length-interval compare.  The length is not
    clamped (the cursor advances by it); the table index uses it clamped
    to [1, MAXLEN] and the symbol index is clamped to [0, k)."""
    k = cb.sym_canon.numel()
    hit = (peek.unsqueeze(-1) >= u32_values(thresh)) & (lmask > 0)
    ln = 1 + hit.sum(-1)
    lnc = ln.clamp(1, MAXLEN)
    code = peek >> (32 - lnc)
    # u32 difference reinterpreted as int32, as the reference does
    diff = (((code - u32_values(cb.first_code)[lnc]) & _M32) ^ (1 << 31)) \
        - (1 << 31)
    idx = (cb.start_idx.long()[lnc] + diff).clamp(0, k - 1)
    return cb.sym_canon[idx], ln


def build_decode_table(lengths: torch.Tensor, impl: Optional[str] = None
                       ) -> DecodeTable:
    """Codebook, decode bounds and LUT from stored bitlengths, on the
    device of `lengths` (the `huffman.codebook` and
    `huffman.decode_table` kernels, or their plain versions)."""
    cb = canonical_codebook(lengths, impl)
    with span(_ops.DECODE_TABLE.span):
        if dispatch.resolve(_ops.DECODE_TABLE.name, lengths, impl) == "cuda":
            return DecodeTable(cb, *_ops.decode_table_cuda(cb))
        return DecodeTable(cb, *_ref.decode_table_ref(cb))


# identity-keyed LRU: repeated decodes of the same stored codebook reuse
# the built tables; entries hold a strong ref to the key tensor so an id()
# can never be reused while its entry is alive.
_DECODE_TABLE_CACHE: "OrderedDict[int, Tuple[torch.Tensor, DecodeTable]]" = \
    OrderedDict()
_DECODE_TABLE_CACHE_SIZE = 64


def decode_table(lengths: torch.Tensor, impl: Optional[str] = None
                 ) -> DecodeTable:
    """Cached `build_decode_table` (one build per codebook tensor)."""
    key = id(lengths)
    hit = _DECODE_TABLE_CACHE.get(key)
    if hit is not None and hit[0] is lengths:
        _DECODE_TABLE_CACHE.move_to_end(key)
        return hit[1]
    tbl = build_decode_table(lengths, impl)
    _DECODE_TABLE_CACHE[key] = (lengths, tbl)
    while len(_DECODE_TABLE_CACHE) > _DECODE_TABLE_CACHE_SIZE:
        _DECODE_TABLE_CACHE.popitem(last=False)
    return tbl


def inflate_gap(words: torch.Tensor, n_valid: torch.Tensor,
                gap_bits: torch.Tensor, table: DecodeTable, sub_size: int
                ) -> torch.Tensor:
    """Phase-2 gap-array decode: every subchunk decodes independently from
    its recorded bit offset, `sub_size` sequential steps with all
    nc·(W/sub_size) cursors in lockstep.

    words: [nc, W] uint32; n_valid: [nc]; gap_bits: [nc, W // sub_size].
    Returns int32 codes [nc, W]; positions past n_valid are 0."""
    nc, W = words.shape
    n_sub = gap_bits.shape[1]
    if n_sub * sub_size != W:
        raise ValueError(f"gap array [{nc}, {n_sub}] does not tile chunks "
                         f"of {W} symbols with sub_size={sub_size}")
    dev = words.device
    # a word past the chunk reads as 0
    wext = torch.cat([u32_values(words),
                      torch.zeros(nc, 1, dtype=torch.int64, device=dev)], 1)
    base = torch.arange(n_sub, device=dev) * sub_size
    nv = n_valid.long().unsqueeze(1)
    bitpos = gap_bits.long()
    out = torch.empty(nc, n_sub, sub_size, dtype=torch.int32, device=dev)
    for i in range(sub_size):
        wi = bitpos >> 5
        bo = bitpos & 31
        cur = (torch.gather(wext, 1, wi.clamp(max=W)) << bo) & _M32
        nxt = torch.gather(wext, 1, (wi + 1).clamp(max=W)) >> (32 - bo)
        peek = cur | torch.where(bo > 0, nxt, 0)
        sym, ln = peek_decode(peek, table.cb, table.thresh, table.lmask)
        ok = (base + i) < nv
        out[:, :, i] = torch.where(ok, sym, 0)
        bitpos = bitpos + torch.where(ok, ln, 0)
    return out.reshape(nc, W)


# ---------------------------------------------------------------------------
# Gap-less (format v1) sequential decode
# ---------------------------------------------------------------------------
#
# Streams written before the gap arrays existed carry no subchunk offsets,
# so each chunk decodes from its first bit to its end.  The walk is
# sequential inside a chunk and runs over all chunks at once: one Python
# step per symbol (table walk) or per bit (bit scan), each step a few
# tensor ops over the chunks.

def _build_lut(cb: Codebook, lut_bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (symbol, length) table keyed by the next `lut_bits` bits
    (the reference's `_build_lut`): left-aligned canonical codes increase
    in canonical order, so marking each code's first slot with its
    canonical rank and filling by a running max builds the table."""
    k = cb.lengths.numel()
    dev = cb.lengths.device
    len_canon = cb.lengths.long()[cb.sym_canon.long()]
    shift = (lut_bits - len_canon).clamp(0, 31)
    starts = (u32_values(cb.codes)[cb.sym_canon.long()] << shift) & _M32
    active = len_canon > 0
    starts = torch.where(active, starts, 1 << lut_bits)
    keep = starts < (1 << lut_bits)                    # out of range: dropped
    mark = torch.zeros(1 << lut_bits, dtype=torch.int64, device=dev)
    rank = torch.where(active, torch.arange(k, device=dev) + 1, 0)
    mark.scatter_reduce_(0, starts[keep], rank[keep], reduce="amax")
    fill = (torch.cummax(mark, 0).values - 1).clamp(min=0)
    return cb.sym_canon[fill], len_canon[fill].to(torch.int32)


def inflate_lut(words: torch.Tensor, n_valid: torch.Tensor, cb: Codebook,
                lut_bits: int = SEQ_LUT_BITS) -> torch.Tensor:
    """Per-chunk sequential decode through the dense table, one step per
    symbol over all chunks.  words: [nc, W] uint32; n_valid: [nc].
    Returns int32 codes [nc, W]; positions past n_valid are 0."""
    lut_sym, lut_len = _build_lut(cb, lut_bits)
    nc, W = words.shape
    dev = words.device
    wext = torch.cat([u32_values(words),
                      torch.zeros(nc, 1, dtype=torch.int64, device=dev)], 1)
    nv = n_valid.long()
    bitpos = torch.zeros(nc, 1, dtype=torch.int64, device=dev)
    out = torch.zeros(nc, W, dtype=torch.int32, device=dev)
    for i in range(int(nv.max()) if nc else 0):
        wi = (bitpos >> 5).clamp(max=W)
        bo = bitpos & 31
        cur = (torch.gather(wext, 1, wi) << bo) & _M32
        nxt = torch.gather(wext, 1, (wi + 1).clamp(max=W)) >> (32 - bo)
        peek = (cur | torch.where(bo > 0, nxt, 0)) >> (32 - lut_bits)
        ok = i < nv
        out[:, i] = torch.where(ok, lut_sym[peek[:, 0]], 0)
        bitpos = bitpos + torch.where(ok, lut_len[peek[:, 0]], 0
                                      ).unsqueeze(1)
    return out


def _len_count(cb: Codebook) -> torch.Tensor:
    """[MAXLEN + 1] int64 number of codewords of each length, from the
    canonical start indices (the last length ends at the used count)."""
    start = cb.start_idx.long()
    nxt = torch.cat([start[1:], (cb.lengths > 0).sum().reshape(1)])
    return nxt - start


def inflate_bitscan(words: torch.Tensor, bits_used: torch.Tensor,
                    n_valid: torch.Tensor, cb: Codebook) -> torch.Tensor:
    """Per-chunk sequential decode one bit at a time (the paper's
    sequential inflate; used when max_len > SEQ_LUT_BITS).  The reference
    scans all 32·W bit positions; positions at or past the longest
    chunk's `bits_used` emit nothing, so the walk stops there."""
    nc, W = words.shape
    dev = words.device
    w64 = u32_values(words)
    nb = bits_used.long()
    nv = n_valid.long()
    first = u32_values(cb.first_code)
    start = cb.start_idx.long()
    count = _len_count(cb)
    k = cb.sym_canon.numel()
    rows = torch.arange(nc, device=dev)
    acc = torch.zeros(nc, dtype=torch.int64, device=dev)
    ln = torch.zeros(nc, dtype=torch.int64, device=dev)
    outpos = torch.zeros(nc, dtype=torch.int64, device=dev)
    out = torch.zeros(nc, W, dtype=torch.int32, device=dev)
    for bitpos in range(min(int(nb.max()) if nc else 0, 32 * W)):
        bit = (w64[:, bitpos >> 5] >> (31 - (bitpos & 31))) & 1
        acc = ((acc << 1) | bit) & _M32
        ln = ln + 1
        lnc = ln.clamp(0, MAXLEN)
        lo = first[lnc]
        # u32 difference reinterpreted as int32, as the reference does
        diff = ((((acc - lo) & _M32) ^ (1 << 31)) - (1 << 31))
        idx = start[lnc] + diff
        emit = ((acc >= lo) & (idx < start[lnc] + count[lnc])
                & (bitpos < nb) & (outpos < nv))
        sym = cb.sym_canon[idx.clamp(0, k - 1)]
        col = outpos.clamp(max=W - 1)
        out[rows, col] = torch.where(emit, sym, out[rows, col])
        acc = torch.where(emit, 0, acc)
        ln = torch.where(emit, 0, ln)
        outpos = outpos + emit.long()
    return out


def inflate(words: torch.Tensor, bits_used: torch.Tensor,
            n_valid: torch.Tensor, cb: Codebook,
            max_len_static: int) -> torch.Tensor:
    """Sequential decode of a gap-less (format v1) stream, dispatched on
    the bucketed max codeword length: the table walk up to SEQ_LUT_BITS,
    the bit scan above.  Runs on the device of `words`; gap-array streams
    use `inflate_gap`."""
    if max_len_static <= SEQ_LUT_BITS:
        return inflate_lut(words, n_valid, cb.to(words.device),
                           lut_bits=max(1, int(max_len_static)))
    return inflate_bitscan(words, bits_used, n_valid, cb.to(words.device))


# the codebook kernels' wrappers and plain versions take the types above;
# imported last, as they import this module
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.huffman import ops as _ops  # noqa: E402
from repro_torch.kernels.huffman import ref as _ref  # noqa: E402

_length_bounds = _ref.length_bounds_ref
