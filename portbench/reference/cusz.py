"""Plain reference of the cusz codec, frozen for the benchmark.

The paper's pipeline (cuSZ, arXiv:2007.09625, §3) written out in plain
PyTorch, on whatever device its input is on:

  1. the value-relative error bound, eb = eb_rel * (max - min);
  2. PREQUANT q = rint(x * f32(1 / f32(2 eb))), in `dtype` (float32;
     the control computes it in bfloat16);
  3. the Lorenzo first difference inside independent blocks with a zero
     padding layer (8^3 in 3D, 256 in 1D; edges padded by replication),
     deltas mapped to codes around nbins / 2, code 0 marking an outlier
     whose exact delta goes to a sparse side channel;
  4. a histogram of the codes, a Huffman tree by the two-queue merge
     (symbols sorted by frequency, ties in symbol order, int32 sums),
     canonical codes from the bitlengths alone;
  5. the codes concatenated MSB-first into per-chunk bitstreams of
     `chunk_size` symbols, with the bit and symbol offsets sampled every
     `sub_size` symbols (the gap arrays of the parallel decode).

`compress` gives the container's header fields and payload arrays, the
device form that the program's `encode` returns; `stored_nbytes` counts
the bytes of its storage form (`pack`); `reconstruct` gives what a
decode must return, q * f32(2 eb).  Nothing here imports the program:
every table is worked out again from the input field.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
MAXLEN = 32
BLOCKS = {1: (256,), 2: (16, 16), 3: (8, 8, 8)}
#: keyed frequency of an unused bin in the two-queue merge
_BIG = (2 ** 31 - 1) // 4
#: chunks deflated per step, which bounds the int64 temporaries
_CHUNKS_PER_STEP = 4096


# ---------------------------------------------------------------------------
# Error bound and quantization
# ---------------------------------------------------------------------------

def resolve_eb(x: torch.Tensor, params: dict) -> float:
    """The absolute error bound of `x` under `params`."""
    lo, hi = torch.aminmax(x)
    lo, hi = float(lo), float(hi)
    if params["eb_mode"] == "abs":
        return float(params["eb"])
    rng = hi - lo
    return float(params["eb"]) * (rng if rng > 0 else 1.0)


def prequant(x: torch.Tensor, eb: float, dtype=torch.float32
             ) -> torch.Tensor:
    """int32 q = rint(x * f32(1 / f32(2 eb))), the multiply in `dtype`."""
    r = float(np.float32(1.0) / np.float32(2.0 * eb))
    rt = torch.tensor(r, dtype=torch.float32, device=x.device).to(dtype)
    return torch.round(x.to(dtype) * rt).to(torch.int32)


def reconstruct(x: torch.Tensor, params: dict, dtype=torch.float32
                ) -> torch.Tensor:
    """What decode(encode(x)) returns: q * f32(2 eb), the multiply in
    `dtype`, as float32."""
    eb = resolve_eb(x, params)
    two = torch.tensor(2.0 * eb, dtype=torch.float32, device=x.device)
    q = prequant(x, eb, dtype)
    return (q.to(dtype) * two.to(dtype)).to(torch.float32)


def tolerance(x: torch.Tensor, eb: float) -> float:
    """The bound |x - decode(encode(x))| <= eb up to float32
    representability: the PREQUANT multiply and the dequant multiply
    each round once, so eb widens by O(|x| eps32)."""
    amax = float(x.abs().max())
    eps = float(np.finfo(np.float32).eps)
    return eb * (1.0 + 1e-5) + 4.0 * eps * amax \
        + float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# Blocking and the Lorenzo delta
# ---------------------------------------------------------------------------

def _pad_to_blocks(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    for ax, (s, b) in enumerate(zip(x.shape, block)):
        t = -(-s // b) * b
        if t != s:
            idx = torch.arange(t, device=x.device).clamp_(max=s - 1)
            x = x.index_select(ax, idx)
    return x


def _block_split(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """[D1..Dn] -> [nb1..nbn, b1..bn], block axes last."""
    n = x.ndim
    shp = []
    for s, b in zip(x.shape, block):
        shp += [s // b, b]
    perm = list(range(0, 2 * n, 2)) + list(range(1, 2 * n, 2))
    return x.reshape(shp).permute(perm).contiguous()


def _shift1(x: torch.Tensor, axis: int) -> torch.Tensor:
    zshape = list(x.shape)
    zshape[axis] = 1
    z = torch.zeros(zshape, dtype=x.dtype, device=x.device)
    return torch.cat([z, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)


def lorenzo_codes(x: torch.Tensor, eb: float, block: Sequence[int],
                  nbins: int, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, delta), int32, flat in block-major order."""
    q = prequant(_block_split(_pad_to_blocks(x, block), block), eb, dtype)
    nd = len(block)
    delta = q
    for ax in range(nd, 2 * nd):
        delta = delta - _shift1(delta, ax)
    radius = nbins // 2
    in_cap = (delta > -radius) & (delta < radius)
    codes = torch.where(in_cap, delta + radius, 0).to(torch.int32)
    return codes.reshape(-1), delta.reshape(-1)


def outliers(codes: torch.Tensor, delta: torch.Tensor, capacity: int):
    """(idx[capacity] filled with n past the outliers, val[capacity],
    count) of the positions whose code is 0."""
    n = codes.numel()
    hits = torch.nonzero(codes == 0).flatten()
    take = min(hits.numel(), capacity)
    idx = torch.full((capacity,), n, dtype=torch.int32, device=codes.device)
    val = torch.zeros((capacity,), dtype=torch.int32, device=codes.device)
    idx[:take] = hits[:take].to(torch.int32)
    val[:take] = delta[hits[:take]]
    return idx, val, torch.tensor(hits.numel(), dtype=torch.int32,
                                  device=codes.device)


# ---------------------------------------------------------------------------
# Huffman codebook
# ---------------------------------------------------------------------------

def _wrap32(v: int) -> int:
    return ((v + (1 << 31)) & M32) - (1 << 31)


def codeword_lengths(freq: torch.Tensor) -> torch.Tensor:
    """Huffman bitlengths (0 for unused symbols) by the two-queue merge:
    with symbols sorted by frequency, ties in symbol order, merged nodes
    come out in non-decreasing order; a leaf is picked over a merged node
    of equal frequency; sums wrap as int32."""
    f = freq.detach().to("cpu", torch.int64)
    k = f.numel()
    active = f > 0
    n_active = int(active.sum())
    keyed = torch.where(active, f, _BIG)
    order = torch.argsort(keyed, stable=True)
    lf = keyed[order].tolist()
    n_int = k - 1
    intq = [_BIG] * n_int
    ch1 = [0] * n_int
    ch2 = [0] * n_int
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
        ch1[t], ch2[t] = n1, n2
    depth = [0] * (k + n_int)
    for t in range(n_active - 2, -1, -1):
        d = depth[k + t] + 1
        depth[ch1[t]] = d
        depth[ch2[t]] = d
    lengths = torch.zeros(k, dtype=torch.int32)
    lengths[order] = torch.tensor(depth[:k], dtype=torch.int32)
    if n_active == 1:
        lengths = torch.where(active, 1, lengths).to(torch.int32)
    return torch.where(active, lengths, 0).to(torch.int32).to(freq.device)


def canonical_codes(lengths: torch.Tensor) -> torch.Tensor:
    """int64 canonical codeword (right-aligned, in [0, 2^32)) per symbol:
    codes of each length are consecutive in symbol order, and the first
    code of length l is (first[l-1] + count[l-1]) << 1."""
    dev = lengths.device
    k = lengths.numel()
    lc = lengths.long().clamp(0, MAXLEN)
    cnt = torch.zeros(MAXLEN + 1, dtype=torch.int64, device=dev)
    cnt.scatter_add_(0, lc, torch.ones_like(lc))
    cnt[0] = 0
    first = [0] * (MAXLEN + 1)
    c = cnt.tolist()
    for ell in range(1, MAXLEN + 1):
        first[ell] = ((first[ell - 1] + c[ell - 1]) << 1) & M32
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       torch.cumsum(cnt, 0)[:-1]])
    key = (torch.where(lengths > 0, lengths, MAXLEN + 1).long() * (2 * k)
           + torch.arange(k, device=dev))
    canon = torch.argsort(key, stable=True)
    pos = torch.empty(k, dtype=torch.int64, device=dev)
    pos[canon] = torch.arange(k, device=dev)
    first_t = torch.tensor(first, dtype=torch.int64, device=dev)
    codes = (first_t[lc] + pos - start[lc]) & M32
    return torch.where(lengths > 0, codes, 0)


# ---------------------------------------------------------------------------
# Encode + deflate
# ---------------------------------------------------------------------------

def _deflate_rows(cw: torch.Tensor, bw: torch.Tensor, sub: int):
    """cw int64 / bw int32 [rows, chunk] -> (words int64 [rows, chunk],
    bits [rows], gap_bits, gap_syms [rows, chunk // sub])."""
    rows, chunk = cw.shape
    offs = torch.cumsum(bw, dim=1, dtype=torch.int32) - bw
    bits = (offs[:, -1] + bw[:, -1]).to(torch.int32)
    valid = bw > 0
    v32 = valid.to(torch.int32)
    gap_bits = offs[:, ::sub].contiguous()
    gap_syms = (torch.cumsum(v32, dim=1, dtype=torch.int32) - v32
                )[:, ::sub].contiguous()
    w = (offs >> 5).long()
    sh = (32 - (offs & 31) - bw).long()
    hi = torch.where(sh >= 0, (cw << sh.clamp(0, 31)) & M32,
                     cw >> (-sh).clamp(0, 31))
    lo = torch.where(sh < 0, (cw << (32 + sh).clamp(0, 31)) & M32, 0)
    hi = torch.where(valid, hi, 0)
    lo = torch.where(valid, lo, 0)
    base = torch.arange(rows, device=cw.device).unsqueeze(1) * chunk
    spill = rows * chunk
    out = torch.zeros(spill + 1, dtype=torch.int64, device=cw.device)
    for word, frag in ((w, hi), (w + 1, lo)):
        slot = torch.where(word < chunk, base + word, spill)
        out.scatter_add_(0, slot.reshape(-1), frag.reshape(-1))
    return out[:spill].reshape(rows, chunk), bits, gap_bits, gap_syms


def huffman_payload(codes: torch.Tensor, nbins: int, chunk: int, sub: int
                    ) -> Dict[str, torch.Tensor]:
    dev = codes.device
    hist = torch.bincount(codes.long(), minlength=nbins)[:nbins]
    lengths = codeword_lengths(hist.to(torch.int32))
    cwords = canonical_codes(lengths)
    n = codes.numel()
    nc = -(-n // chunk)
    words = torch.empty((nc, chunk), dtype=torch.int32, device=dev)
    bits = torch.empty(nc, dtype=torch.int32, device=dev)
    gap_bits = torch.empty((nc, chunk // sub), dtype=torch.int32, device=dev)
    gap_syms = torch.empty_like(gap_bits)
    for r0 in range(0, nc, _CHUNKS_PER_STEP):
        r1 = min(nc, r0 + _CHUNKS_PER_STEP)
        sym = codes[r0 * chunk:r1 * chunk].long()
        pad = (r1 - r0) * chunk - sym.numel()
        cw = torch.nn.functional.pad(cwords[sym], (0, pad))
        bw = torch.nn.functional.pad(lengths[sym], (0, pad))
        wd, b, gb, gs = _deflate_rows(cw.reshape(r1 - r0, chunk),
                                      bw.reshape(r1 - r0, chunk), sub)
        # u32 values in [0, 2^32) as the int32 of the same bits
        words[r0:r1] = ((wd ^ (1 << 31)) - (1 << 31)).to(torch.int32)
        bits[r0:r1], gap_bits[r0:r1], gap_syms[r0:r1] = b, gb, gs
    starts = torch.arange(nc, dtype=torch.int64, device=dev) * chunk
    return {"words": words.view(torch.uint32), "bits_used": bits,
            "n_valid": (n - starts).clamp(0, chunk).to(torch.int32),
            "lengths": lengths,
            "max_len": lengths.max().to(torch.int32),
            "gap_bits": gap_bits, "gap_syms": gap_syms}


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

def compress(x: torch.Tensor, params: dict, dtype=torch.float32
             ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(header fields, payload arrays) of the cusz container of `x`."""
    x = x.to(torch.float32).contiguous()
    eb = resolve_eb(x, params)
    block = tuple(BLOCKS[x.ndim])
    nbins = int(params["nbins"])
    codes, delta = lorenzo_codes(x, eb, block, nbins, dtype)
    cap = max(16, int(codes.numel() * float(params["outlier_frac"])))
    idx, val, n_out = outliers(codes, delta, cap)
    del delta
    payload = huffman_payload(codes, nbins, int(params["chunk_size"]),
                              int(params["sub_size"]))
    payload.update(out_idx=idx, out_val=val, n_outliers=n_out)
    header = {"shape": list(x.shape), "dtype": "float32", "eb": eb,
              "nbins": nbins, "chunk_size": int(params["chunk_size"]),
              "sub_size": int(params["sub_size"]), "block": list(block),
              "outlier_frac": float(params["outlier_frac"])}
    return header, payload


def stored_nbytes(payload: Dict[str, torch.Tensor]) -> int:
    """Bytes of the storage form: the used words of each chunk, the
    per-chunk bit and symbol counts, one byte per bitlength, the gap
    arrays (symbol offsets as u16 while chunks fit), the used prefix of
    the outlier store, and three int32 scalars (max_len, the chunk's
    words and the outlier capacity)."""
    bits = payload["bits_used"].long()
    nc = bits.numel()
    words = int(((bits + 31) // 32).sum()) * 4
    chunk = int(payload["words"].shape[1])
    gaps = int(payload["gap_bits"].numel())
    sym_bytes = 2 if chunk <= (1 << 16) else 4
    n_out = int(payload["n_outliers"])
    return (words + 8 * nc + int(payload["lengths"].numel())
            + gaps * (4 + sym_bytes) + 8 * n_out + 12)


#: the limit of each number the check compares: containers and
#: reconstructions are exact (byte for byte, bit for bit); the error
#: bound is the one the configuration states, |x - x'| <= `tolerance`
LIMITS = {"container_mismatch": 0, "stored_bytes_gap": 0,
          "recon_mismatch": 0, "bound_excess": 1.0}
