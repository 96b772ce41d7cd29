"""Plain PyTorch versions of the fused dual-quant kernel and its inverse.

Same arithmetic as the reference's compiled pipeline.  PREQUANT there is
`rint(x / (2*eb))` with eb a compile-time constant, which XLA compiles to
a multiply by the f32 reciprocal `f32(1) / f32(2*eb)`; the stored
containers (golden fixture, BENCH_quality.json) hold that rounding, which
differs from an IEEE division on a few rint ties per field.  So PREQUANT
here is one rounded f32 multiply by that reciprocal, then
round-half-to-even, exactly as the CUDA kernel does it.  Dequant is the
f32 product d · f32(2*eb).
"""
from __future__ import annotations

import numpy as np
import torch


def two_eb(eb: float, device) -> torch.Tensor:
    """f32(2·eb) as a 0-d tensor on `device`."""
    return torch.tensor(2.0 * eb, dtype=torch.float32, device=device)


def inv_two_eb(eb: float) -> float:
    """The PREQUANT multiplier f32(1) / f32(2·eb), rounded to f32."""
    return float(np.float32(1.0) / np.float32(2.0 * eb))


def _shift1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Shift by +1 along `axis`, filling with 0 (the padding layer)."""
    zshape = list(x.shape)
    zshape[axis] = 1
    z = torch.zeros(zshape, dtype=x.dtype, device=x.device)
    return torch.cat([z, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)


def dualquant_blocks_ref(xb: torch.Tensor, eb: float, nbins: int):
    """xb: [nb..., b...] float32 blocks (block axes last nd).
    Returns (codes int32, delta int32); code 0 marks an outlier."""
    nd = xb.ndim // 2
    r = torch.tensor(inv_two_eb(eb), dtype=torch.float32, device=xb.device)
    q = torch.round(xb.to(torch.float32) * r)
    delta = q.to(torch.int32)
    for ax in range(xb.ndim - nd, xb.ndim):
        delta = delta - _shift1(delta, ax)
    radius = nbins // 2
    in_cap = (delta > -radius) & (delta < radius)
    codes = torch.where(in_cap, delta + radius, 0).to(torch.int32)
    return codes, delta


def reverse_blocks_ref(delta: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse: inclusive int32 cumsum along each block axis, then dequant."""
    nd = delta.ndim // 2
    d = delta
    for ax in range(delta.ndim - nd, delta.ndim):
        d = torch.cumsum(d, dim=ax, dtype=torch.int32)
    return d.to(torch.float32) * two_eb(eb, delta.device)
