"""DUAL-QUANTIZATION (cuSZ §3.1) in PyTorch.

The paper's scheme:
  PREQUANT   d° = round(d / (2·eb))           (the ONLY lossy step)
  PREDICT    p° = ℓ(d°_neighbors)             (Lorenzo predictor)
  POSTQUANT  δ° = d° − p°                     (exact integer arithmetic)

On pre-quantized integers the first-order Lorenzo predictor is the
d-dimensional first-difference operator, and its inverse is an inclusive
prefix sum along each axis.  Data is split into independent blocks with
an implicit zero padding layer (§3.1.1), so every block is handled alone
in both directions.  The fused blocked kernels live in
`repro_torch.kernels.lorenzo`; this module holds the blocking, the
code <-> delta mapping and the sparse outlier side channel, plus the
unfused PREQUANT / dequant / POSTQUANT steps that the interpolation
predictor calls on their own.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.lorenzo.ref import _shift1, inv_two_eb

# Paper defaults (§3.1.1).
DEFAULT_BLOCKS = {1: (256,), 2: (16, 16), 3: (8, 8, 8)}
# The larger lane-aligned blocks of the reference (`use_tpu_blocks`); they
# change container bytes, so the port keeps them.
TPU_BLOCKS = {1: (4096,), 2: (64, 128), 3: (8, 16, 128)}


def prequant(data: torch.Tensor, eb: float) -> torch.Tensor:
    """PREQUANT: d° = round(d / (2·eb)) as int32, the only lossy step.

    Computed as the reference's compiled pipeline computes it: one rounded
    f32 multiply by f32(1) / f32(2·eb) (XLA's form of the division by a
    compile-time constant), then round-half-to-even.  An IEEE division
    differs on a few rint ties per field."""
    # a host scalar, not a 0-d tensor on the device: a tensor made from a
    # host float is a pageable copy, which waits for the stream to drain;
    # the f32 multiply is the same either way
    return torch.round(data.to(torch.float32) * inv_two_eb(eb)
                       ).to(torch.int32)


def dequant(q: torch.Tensor, eb: float,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of PREQUANT: d• = d° · f32(2·eb).  The factor is a host
    scalar holding f32(2·eb), as in `prequant`."""
    return (q.to(torch.float32) * float(np.float32(2.0 * eb))).to(dtype)


def lorenzo_delta(q: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """POSTQUANT deltas: (1 - S) along each axis with a zero-filled shift,
    i.e. δ = d° - ℓ(d°) with the paper's zero padding layer.  Exact in
    int32."""
    delta = q
    for ax in axes:
        delta = delta - _shift1(delta, ax)
    return delta


def lorenzo_reconstruct(delta: torch.Tensor, axes: Sequence[int]
                        ) -> torch.Tensor:
    """Inverse of `lorenzo_delta`: an inclusive prefix sum along each
    axis, in the dtype of `delta`."""
    q = delta
    for ax in axes:
        q = torch.cumsum(q, dim=ax, dtype=delta.dtype)
    return q


def padded_shape(shape: Sequence[int], block: Sequence[int]
                 ) -> Tuple[int, ...]:
    return tuple(-(-s // b) * b for s, b in zip(shape, block))


def pad_to_blocks(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """Edge-replicate pad to a multiple of the block shape (cropped on
    decompress; replicate keeps the pad region cheap to encode)."""
    tgt = padded_shape(x.shape, block)
    for ax, (s, t) in enumerate(zip(x.shape, tgt)):
        if t != s:
            idx = torch.arange(t, device=x.device).clamp_(max=s - 1)
            x = x.index_select(ax, idx)
    return x


def block_split(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """[D1,..,Dn] -> [nb1,..,nbn, b1,..,bn] (block axes last), contiguous."""
    n = x.ndim
    if len(block) != n:
        raise ValueError(f"block {tuple(block)} does not match a {n}-D input")
    shp = []
    for s, b in zip(x.shape, block):
        if s % b:
            raise ValueError(f"shape {tuple(x.shape)} is not a multiple of "
                             f"block {tuple(block)}")
        shp += [s // b, b]
    perm = list(range(0, 2 * n, 2)) + list(range(1, 2 * n, 2))
    return x.reshape(shp).permute(perm).contiguous()


def block_merge(x: torch.Tensor, block: Sequence[int]) -> torch.Tensor:
    """Inverse of block_split."""
    n = x.ndim // 2
    perm = []
    for i in range(n):
        perm += [i, n + i]
    x = x.permute(perm)
    shp = [x.shape[2 * i] * x.shape[2 * i + 1] for i in range(n)]
    return x.reshape(shp)


def blocked_delta(x: torch.Tensor, eb: float, block: Sequence[int]
                  ) -> torch.Tensor:
    """pad -> PREQUANT -> block -> Lorenzo delta on the in-block axes:
    int32 deltas shaped [nb..., b...].  The unfused form of the
    `lorenzo.dualquant` kernel's delta (the pipeline calls the kernel)."""
    n = x.ndim
    q = prequant(block_split(pad_to_blocks(x, block), block), eb)
    return lorenzo_delta(q, range(n, 2 * n))


def blocked_reconstruct(delta: torch.Tensor, eb: float,
                        block: Sequence[int], orig_shape: Sequence[int],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Prefix-sum inverse per block -> merge -> crop -> dequant."""
    n = len(block)
    q = block_merge(lorenzo_reconstruct(delta, range(n, 2 * n)), block)
    return dequant(q[tuple(slice(0, s) for s in orig_shape)], eb, dtype)


# ---------------------------------------------------------------------------
# POSTQUANT code mapping + outliers (paper Algorithm 2).  Code 0 is reserved
# for OUTLIER; in-cap deltas map to 1..cap-1 around the radius.  Outliers
# keep their exact integer delta in a sparse side channel.
# ---------------------------------------------------------------------------

def postquant_codes(delta: torch.Tensor, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map int32 deltas to quant codes in [0, cap).  Returns (codes,
    in_cap)."""
    radius = cap // 2
    in_cap = (delta > -radius) & (delta < radius)
    codes = torch.where(in_cap, delta + radius, 0).to(torch.int32)
    return codes, in_cap


def codes_to_delta(codes: torch.Tensor, cap: int) -> torch.Tensor:
    """In-cap codes back to deltas; outlier positions (code 0) become 0 and
    are overwritten by the sparse outlier scatter."""
    radius = cap // 2
    return torch.where(codes == 0, 0, codes - radius).to(torch.int32)


# repro-lint: allow[host-sync] torch.nonzero sizes the outlier
# compaction: the count is read once per encode and goes back as a 0-d
# tensor
def extract_outliers(delta_flat: torch.Tensor, in_cap_flat: torch.Tensor,
                     capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather up to `capacity` outlier (index, delta) pairs.

    Returns (idx[int32, capacity] filled with n past the outliers,
    val[int32, capacity], n_outliers).  n_outliers > capacity means
    overflow (the caller surfaces it)."""
    n = delta_flat.shape[0]
    hits = torch.nonzero(~in_cap_flat).flatten()
    n_out = hits.numel()
    idx = torch.full((capacity,), n, dtype=torch.int64,
                     device=delta_flat.device)
    take = min(n_out, capacity)
    idx[:take] = hits[:take]
    val = torch.zeros((capacity,), dtype=torch.int32, device=delta_flat.device)
    val[:take] = delta_flat[hits[:take]]
    return (idx.to(torch.int32), val,
            torch.tensor(n_out, dtype=torch.int32, device=delta_flat.device))


def scatter_outliers(delta_flat: torch.Tensor, idx: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """Write exact outlier deltas back, in place (the caller owns the fresh
    delta from `codes_to_delta`; a copy would cost 4 B per value).
    Indices outside [0, n) (the fill) are dropped."""
    n = delta_flat.shape[0]
    keep = (idx >= 0) & (idx < n)
    # repro-lint: allow[host-sync] the boolean mask compacts the filled
    # capacity: one count read per decode
    delta_flat[idx[keep].long()] = val[keep].to(delta_flat.dtype)
    return delta_flat


def outlier_deltas(codes: torch.Tensor, cap: int, idx: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """`scatter_outliers(codes_to_delta(codes, cap), idx, val)` with no
    read on the host, so the host can run ahead of the card.  The deltas
    fill the head of a buffer with one spare slot per capacity entry;
    each index outside [0, n) (the fill) writes its own spare slot, and
    the result is the head, a view of n values."""
    n, c = codes.shape[0], idx.shape[0]
    buf = torch.empty(n + c, dtype=torch.int32, device=codes.device)
    delta = buf[:n]
    c32 = codes.to(torch.int32)
    torch.sub(c32, cap // 2, out=delta).masked_fill_(c32 == 0, 0)
    spare = torch.arange(n, n + c, device=idx.device)
    buf[torch.where((idx >= 0) & (idx < n), idx.long(), spare)] = \
        val.to(torch.int32)
    return delta
