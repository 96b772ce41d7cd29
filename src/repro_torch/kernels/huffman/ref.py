"""Plain PyTorch versions of the Huffman codebook kernels.

`codeword_lengths_ref` walks the two-queue merge in Python lists over a
host copy of the histogram; the canonical codebook and the decode table
are tensor ops on the device of their input, with no read.  Canonical
codewords are u32: they are computed on as int64 in [0, 2^32), because
PyTorch has no uint32 arithmetic, and stored as `torch.uint32`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import huffman as hf

_M32 = 0xFFFFFFFF
_BIG = (2 ** 31 - 1) // 4        # keyed freq of an unused bin


def _wrap32(v: int) -> int:
    """The int32 with the low 32 bits of `v` (the reference's int32 sum)."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


# repro-lint: allow[host-sync] plain version: the merge walks host lists
# over one copy of the nbins-count histogram
def codeword_lengths_ref(freq: torch.Tensor) -> torch.Tensor:
    """Two-queue Huffman: int32 bitlengths (0 = unused) on the device of
    `freq`.

    With symbols sorted by frequency (stable: ties keep symbol order),
    merged internal nodes come out in non-decreasing frequency order, so
    two pointer-queues replace the heap.  Same picks, tie-breaks and int32
    sums as the reference's device loop."""
    f = freq.detach().to("cpu", torch.int64)
    k = f.numel()
    active = f > 0
    n_active = int(active.sum())
    keyed = torch.where(active, f, _BIG)
    order = torch.argsort(keyed, stable=True)           # active symbols first
    lf = keyed[order].tolist()                          # leaf freqs, sorted

    n_int = k - 1                                       # max internal nodes
    intq = [_BIG] * n_int                               # merged-node freqs
    ch1 = [0] * n_int                                   # children (node ids:
    ch2 = [0] * n_int                                   #  leaf i<k, int. k+j)
    i = j = 0
    for t in range(max(n_active - 1, 0)):
        picked = []
        for _ in range(2):
            if i < n_active and (j >= t or lf[i] <= intq[j]):
                picked.append((lf[i], i))
                i += 1
            else:
                picked.append((intq[j], k + j))
                j += 1
        (f1, n1), (f2, n2) = picked
        intq[t] = _wrap32(f1 + f2)
        ch1[t] = n1
        ch2[t] = n2

    # parents are created after their children: walk internal nodes from
    # the root (last created) down, propagating depth
    depth = [0] * (k + n_int)
    for t in range(n_active - 2, -1, -1):
        d = depth[k + t] + 1
        depth[ch1[t]] = d
        depth[ch2[t]] = d

    lengths = torch.zeros(k, dtype=torch.int32)
    lengths[order] = torch.tensor(depth[:k], dtype=torch.int32)
    if n_active == 1:                   # single symbol: a 1-bit code
        lengths = torch.where(active, 1, lengths).to(torch.int32)
    return torch.where(active, lengths, 0).to(torch.int32).to(freq.device)


def length_counts(lengths: torch.Tensor) -> torch.Tensor:
    """[MAXLEN+1] int64 number of symbols per bitlength (length 0 not
    counted)."""
    lc = lengths.long().clamp(0, hf.MAXLEN)
    cnt = torch.zeros(hf.MAXLEN + 1, dtype=torch.int64, device=lengths.device)
    cnt.scatter_add_(0, lc, torch.ones_like(lc))
    cnt[0] = 0
    return cnt


def canonical_codebook_ref(lengths: torch.Tensor) -> "hf.Codebook":
    """Canonical codes from bitlengths alone (Schwartz-Kallick), on the
    device of `lengths`.

    Bijective, bitlength-preserving and decodable without the tree via
    (first_code, start_idx, sym_canon)."""
    dev = lengths.device
    lengths = lengths.to(torch.int32)
    k = lengths.numel()
    cnt = length_counts(lengths)
    # the u32 recurrence first_code[l] = (first_code[l-1] + cnt[l-1]) << 1
    # unrolled: sum over m < l of cnt[m] << (l - m), modulo 2^32
    ell = torch.arange(hf.MAXLEN + 1, device=dev)
    shift = ell[:, None] - ell[None, :]
    terms = (cnt[None, :] << shift.clamp(0, hf.MAXLEN)) & _M32
    first_code = torch.where(shift > 0, terms, 0).sum(1) & _M32
    start_idx = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(cnt, 0)[:-1]])
    # canonical order: (length, symbol) ascending, unused symbols last
    key = (torch.where(lengths > 0, lengths, hf.MAXLEN + 1).long() * (2 * k)
           + torch.arange(k, device=dev))
    sym_canon = torch.argsort(key, stable=True)
    pos = torch.empty(k, dtype=torch.int64, device=dev)
    pos[sym_canon] = torch.arange(k, device=dev)     # canonical rank of sym
    lc = lengths.long().clamp(0, hf.MAXLEN)
    rank = pos - start_idx[lc]
    codes = (first_code[lc] + rank) & _M32
    codes = torch.where(lengths > 0, codes, 0)
    max_len = lengths.max() if k else torch.tensor(0, device=dev)
    return hf.Codebook(lengths, hf.as_u32(codes), hf.as_u32(first_code),
                       start_idx.to(torch.int32), sym_canon.to(torch.int32),
                       max_len.to(torch.int32))


def length_bounds_ref(cb: "hf.Codebook"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`DecodeTable.thresh` and `.lmask` of a codebook."""
    cnt = length_counts(cb.lengths)
    ell = torch.arange(hf.MAXLEN + 1, device=cnt.device)
    span = (hf.u32_values(cb.first_code) + cnt) & _M32
    thresh = (span << (32 - ell).clamp(0, 31)) & _M32
    lmask = ((ell >= 1) & (ell < cb.max_len)).to(torch.int32)
    return hf.as_u32(thresh), lmask


def build_lut_ref(cb: "hf.Codebook", thresh: torch.Tensor,
                  lmask: torch.Tensor) -> torch.Tensor:
    """The [2^LUT_BITS] decode table of `DecodeTable.lut`.

    The decoded length is monotone in the peek, so it is constant over
    the peeks that start with prefix p exactly when it agrees at the
    lowest and the highest of them; a length <= LUT_BITS then fixes the
    codeword, hence the symbol, from p alone.  Every other prefix maps to
    0 and takes the interval compare, so the table gives exactly what
    `peek_decode` gives for every 32-bit peek, clamps included.  For a
    complete code with max_len <= LUT_BITS it is the reference's dense
    (symbol, length) LUT (`repro.core.huffman._build_lut`)."""
    check_lut_symbols(cb.sym_canon.numel())
    low = torch.arange(1 << hf.LUT_BITS, dtype=torch.int64,
                       device=thresh.device) << (32 - hf.LUT_BITS)
    high = low | ((1 << (32 - hf.LUT_BITS)) - 1)
    sym, ln = hf.peek_decode(low, cb, thresh, lmask)
    _, ln_high = hf.peek_decode(high, cb, thresh, lmask)
    ok = (ln == ln_high) & (ln <= hf.LUT_BITS)
    return torch.where(ok, (sym.long() << 6) | ln, 0).to(torch.int32)


def check_lut_symbols(k: int) -> None:
    """A LUT entry packs the symbol above 6 length bits in an int32."""
    if k >= 1 << 25:
        raise ValueError(f"{k} symbols do not fit a LUT entry (the symbol "
                         "must stay below 2^25)")


def decode_table_ref(cb: "hf.Codebook"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(thresh, lmask, lut) of `DecodeTable`, on the codebook's device."""
    thresh, lmask = length_bounds_ref(cb)
    return thresh, lmask, build_lut_ref(cb, thresh, lmask)
