"""Dispatching wrappers for the Lorenzo dual-quant kernels.

Source: `csrc/lorenzo.cu`, replacing `dualquant_blocks_pallas` and
`reverse_blocks_pallas` (src/repro/kernels/lorenzo/kernel.py:76, :96).
Both are bound by device memory on the H100 (12 B and 8 B per value).
In both directions one warp owns one block of the default shapes (256),
(16,16) and (8,8,8): 16 B loads and stores, the in-register axis
differenced (dual-quant) or scanned (reverse) in place and the other
axes through warp shuffles, no shared memory, no barrier and no runtime
divide.  Other blocks, and buffers not 16 B aligned, take a generic
kernel that stages one block per CTA in shared memory.  See the source
for the design.

The kernels see blocked data as [nblocks, prod(block)]: `block_split`
stays in Python.  Block axes of extent 1 are inert (a shift along them
is zero), so up to four non-unit block axes are supported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
DUALQUANT = dispatch.register("lorenzo.dualquant")
# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
REVERSE = dispatch.register("lorenzo.reverse")

_MAX_SMEM = 227 * 1024


def _block_dims(shape: Tuple[int, ...], smem_per_value: int
                ) -> Tuple[int, Tuple[int, int, int, int]]:
    """(nblocks, four block extents) for a blocked [nb..., b...] shape."""
    nd = len(shape) // 2
    block = [int(b) for b in shape[nd:] if b != 1]
    if len(block) > 4:
        raise ValueError(f"block {tuple(shape[nd:])} has more than four "
                         "non-unit axes")
    total = math.prod(block)
    if total * smem_per_value > _MAX_SMEM:
        raise ValueError(f"block of {total} values does not fit in shared "
                         f"memory ({smem_per_value} B per value)")
    dims = (1,) * (4 - len(block)) + tuple(block)
    return math.prod(shape[:nd]), dims


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.ndim % 2:
        raise ValueError(f"{what} must be blocked [nb..., b...], got shape "
                         f"{tuple(t.shape)}")


def dualquant_blocks_cuda(xb: torch.Tensor, eb: float, nbins: int):
    _check(xb, torch.float32, "xb")
    nblocks, dims = _block_dims(tuple(xb.shape), 4)
    codes = torch.empty(xb.shape, dtype=torch.int32, device=xb.device)
    delta = torch.empty(xb.shape, dtype=torch.int32, device=xb.device)
    err = _build.lib().rt_dualquant(
        xb.device.index, xb.data_ptr(), codes.data_ptr(), delta.data_ptr(),
        nblocks, *dims, ref.inv_two_eb(eb), int(nbins),
        _build.stream(xb.device))
    _build.check("lorenzo.dualquant", err)
    DUALQUANT.launches += 1
    return codes, delta


def reverse_blocks_cuda(delta: torch.Tensor, eb: float) -> torch.Tensor:
    _check(delta, torch.int32, "delta")
    nblocks, dims = _block_dims(tuple(delta.shape), 8)
    out = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    err = _build.lib().rt_reverse(
        delta.device.index, delta.data_ptr(), out.data_ptr(), nblocks, *dims,
        float(2.0 * eb), _build.stream(delta.device))
    _build.check("lorenzo.reverse", err)
    REVERSE.launches += 1
    return out


def dualquant_blocks(xb: torch.Tensor, eb: float, nbins: int,
                     impl: Optional[str] = None):
    """Fused PREQUANT + ℓ-delta + POSTQUANT on blocked input.
    Returns (codes, delta), both int32 shaped like xb."""
    impl = dispatch.resolve(DUALQUANT.name, xb, impl)
    if impl == "cuda":
        return dualquant_blocks_cuda(xb, eb, nbins)
    return ref.dualquant_blocks_ref(xb, eb, nbins)


def reverse_blocks(delta: torch.Tensor, eb: float,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Per-block cumsum inverse + dequant.  Returns blocked float32."""
    impl = dispatch.resolve(REVERSE.name, delta, impl)
    if impl == "cuda":
        return reverse_blocks_cuda(delta, eb)
    return ref.reverse_blocks_ref(delta, eb)
