"""cuZFP-like fixed-rate block-transform compressor (comparison baseline),
in PyTorch.

The paper's quality evaluation compares cuSZ against cuZFP in
*fixed-rate* mode.  This module is the reference's re-implementation of
ZFP's pipeline:

  4^d blocks -> block exponent alignment -> fixed-point int32 ->
  near-orthogonal lifting transform (per axis; inv∘fwd = identity up to
  low-bit truncation, exactly as in ZFP) -> negabinary ->
  keep top `planes` bit-planes per coefficient (fixed rate) -> inverse.

Every coefficient keeps the same number of planes (real ZFP codes bit
planes by group testing); the reference documents this simplification.

torch on the CPU has no uint32 `+`, `^` or `<<`, and int32 overflow is
not a defined wrap there, so the integer transform carries its values as
int64 wrapped to 32 bits after every step; the stored coefficients are
`torch.uint32` at the container boundary.  The float steps follow the
reference's compiled forms: the block exponent is
`ceil(log(amax) * f32(1/log(2)))` and 2^e is `exp(e * f32(log 2))`, with
results below float32's normal range flushed to zero.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .dualquant import block_merge, block_split, pad_to_blocks

_Q = 30                      # fixed-point fraction bits
_M32 = 0xFFFFFFFF
_NEGA = 0xAAAAAAAA
_EXP_LO, _EXP_HI = -160, 160


def _w(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's
    complement wrap)."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def _fwd_lift(v: torch.Tensor, axis: int) -> torch.Tensor:
    """ZFP forward lifting on a length-4 axis (int32 arithmetic; matches
    zfp's fwd_lift incl. its low-bit truncation)."""
    x, y, z, w = v.unbind(axis)
    x = _w(x + w); x = x >> 1; w = _w(w - x)
    z = _w(z + y); z = z >> 1; y = _w(y - z)
    x = _w(x + z); x = x >> 1; z = _w(z - x)
    w = _w(w + y); w = w >> 1; y = _w(y - w)
    w = _w(w + (y >> 1)); y = _w(y - (w >> 1))
    return torch.stack([x, y, z, w], dim=axis)


def _inv_lift(v: torch.Tensor, axis: int) -> torch.Tensor:
    x, y, z, w = v.unbind(axis)
    y = _w(y + (w >> 1)); w = _w(w - (y >> 1))
    y = _w(y + w); w = _w(w << 1); w = _w(w - y)
    z = _w(z + x); x = _w(x << 1); x = _w(x - z)
    y = _w(y + z); z = _w(z << 1); z = _w(z - y)
    w = _w(w + x); x = _w(x << 1); x = _w(x - w)
    return torch.stack([x, y, z, w], dim=axis)


def _negabinary(i: torch.Tensor) -> torch.Tensor:
    """int32 values (as int64) -> negabinary u32 values in [0, 2^32)."""
    return (((i & _M32) + _NEGA) & _M32) ^ _NEGA


def _inv_negabinary(u: torch.Tensor) -> torch.Tensor:
    return _w((u ^ _NEGA) - _NEGA)


def _exp2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integer-valued float32 `e`, the reference's compiled form
    (`exp(e * f32(log 2))`, subnormal results flushed to zero), read
    from a table built once on the CPU so every device gives the same
    bits."""
    global _EXP2_TABLE
    if _EXP2_TABLE is None:
        k = torch.arange(_EXP_LO, _EXP_HI + 1, dtype=torch.float32)
        t = torch.exp(k * torch.log(torch.tensor(2.0)))
        _EXP2_TABLE = torch.where(t < torch.finfo(torch.float32).tiny,
                                  0.0, t)
    idx = (e.to(torch.int64) - _EXP_LO).clamp(0, _EXP_HI - _EXP_LO)
    return _EXP2_TABLE.to(e.device)[idx]


_EXP2_TABLE = None


def encode_blocks(xb: torch.Tensor, planes: int, nblock: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb: [..., 4,..,4] float32 blocks (block axes = the LAST `nblock`
    axes).  Returns (u, e): the plane-truncated negabinary coefficients
    (uint32, xb.shape) and the per-block exponents (f32, block dims 1).
    This is the storable half; `decode_blocks` is its inverse."""
    baxes = tuple(range(xb.ndim - nblock, xb.ndim))
    amax = xb.abs().amax(dim=baxes, keepdim=True)
    inv_ln2 = (1 / torch.log(torch.tensor(2.0))).to(xb.device)
    lg = torch.log(amax.clamp(min=1e-38)) * inv_ln2
    e = torch.where(amax > 0, torch.ceil(lg), 0.0)
    q = torch.round(xb * _exp2(-e) * float(1 << _Q))
    q = q.clamp(-(2 ** 31 - 1), 2 ** 31 - 1).to(torch.int64)
    for ax in baxes:
        q = _fwd_lift(q, ax)
    u = _negabinary(q)
    # fixed rate: keep the top `planes` bit planes of each coefficient
    keep = (_M32 << (32 - min(planes, 32))) & _M32
    return (u & keep).to(torch.int32).view(torch.uint32), e


def decode_blocks(u: torch.Tensor, e: torch.Tensor, nblock: int
                  ) -> torch.Tensor:
    baxes = tuple(range(u.ndim - nblock, u.ndim))
    q = _inv_negabinary(u.view(torch.int32).to(torch.int64) & _M32)
    for ax in reversed(baxes):
        q = _inv_lift(q, ax)
    return q.to(torch.float32) / float(1 << _Q) * _exp2(e)


def compress_decompress(x: torch.Tensor, rate_bits: float
                        ) -> Tuple[torch.Tensor, float]:
    """Fixed-rate roundtrip: (reconstruction, achieved bits per value).

    The rate is the planes kept per coefficient plus the 16-bit block
    header amortized over a 4^d block, as in ZFP.  Inputs of more than 3
    dims are a batch of 3-D fields (the paper's QMCPACK)."""
    planes = max(1, int(round(rate_bits)))
    nd = min(x.ndim, 3)
    xf = x.to(torch.float32)
    if x.ndim > 3:
        lead = math.prod(x.shape[:-3])
        xf = xf.reshape((lead,) + tuple(x.shape[-3:]))
        block = (1, 4, 4, 4)
        xb = block_split(pad_to_blocks(xf, block), block).squeeze(-4)
        rec = decode_blocks(*encode_blocks(xb, planes, nd), nd)
        rec = block_merge(rec.unsqueeze(-4), block)
    else:
        block = (4,) * nd
        xb = block_split(pad_to_blocks(xf, block), block)
        rec = block_merge(decode_blocks(*encode_blocks(xb, planes, nd), nd),
                          block)
    rec = rec[tuple(slice(0, s) for s in xf.shape)].reshape(x.shape)
    return rec, planes + 16.0 / 4 ** nd
