"""Dispatching wrappers for the bit-plane shuffle kernels.

Source: `csrc/bitshuffle.cu`, replacing `encode_planes_pallas` and
`decode_planes_pallas` (src/repro/kernels/bitshuffle/kernel.py:46, :63).
Both are bound by device memory on the H100 (4 B of codes against P/8 B
of planes per symbol), and both work on tiles of 128 groups (4096
symbols).  Encode: a CTA stages the tile's contiguous run of codes in
shared memory with one bulk copy of the 16 B-aligned window around it
(so a view with a storage offset takes the same path); a warp zigzags
groups of 32 symbols and transposes them as 32x32 bit matrices in five
shuffle stages, up to three groups per matrix, so lane p holds plane p's
word; the tile's plane rows leave as coalesced stores.  Decode: a CTA
stages the tile's plane words with 16 B loads, and each thread rebuilds
4 symbols from them with a multiply and byte permutes, storing one int4.
See the source for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build, dispatch
from . import ref
from .ref import nplanes

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
ENCODE = dispatch.register("bitshuffle.encode")
# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
DECODE = dispatch.register("bitshuffle.decode")

_MAX_PLANES = 32


def _check(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def encode_planes_cuda(codes2: torch.Tensor, nbins: int) -> torch.Tensor:
    _check(codes2, torch.int32, 2, "codes2")
    nc, chunk = codes2.shape
    if chunk % 32:
        raise ValueError(f"chunk {chunk} is not a multiple of 32")
    p_count = nplanes(nbins)
    if p_count > _MAX_PLANES:
        raise ValueError(f"nbins {nbins} needs {p_count} planes (> 32)")
    planes = torch.empty((nc, p_count, chunk // 32), dtype=torch.uint32,
                         device=codes2.device)
    err = _build.lib().rt_bitshuffle_encode(
        codes2.device.index, codes2.data_ptr(), planes.data_ptr(), nc,
        chunk // 32, p_count, int(nbins), _build.stream(codes2.device))
    _build.check(ENCODE.name, err)
    ENCODE.launches += 1
    return planes


def decode_planes_cuda(planes: torch.Tensor, nbins: int) -> torch.Tensor:
    _check(planes, torch.uint32, 3, "planes")
    nc, p_count, w = planes.shape
    if p_count > _MAX_PLANES:
        raise ValueError(f"{p_count} planes (> 32)")
    codes2 = torch.empty((nc, 32 * w), dtype=torch.int32,
                         device=planes.device)
    err = _build.lib().rt_bitshuffle_decode(
        planes.device.index, planes.data_ptr(), codes2.data_ptr(), nc, w,
        p_count, int(nbins), _build.stream(planes.device))
    _build.check(DECODE.name, err)
    DECODE.launches += 1
    return codes2


def encode_planes(codes2: torch.Tensor, nbins: int,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Fused zigzag + bitshuffle: [nc, chunk] codes -> [nc, P, W] planes."""
    impl = dispatch.resolve(ENCODE.name, codes2, impl)
    if impl == "cuda":
        return encode_planes_cuda(codes2, nbins)
    return ref.encode_planes_ref(codes2, nbins)


def decode_planes(planes: torch.Tensor, nbins: int,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Inverse bitshuffle: [nc, P, W] planes -> [nc, 32·W] codes."""
    impl = dispatch.resolve(DECODE.name, planes, impl)
    if impl == "cuda":
        return decode_planes_cuda(planes, nbins)
    return ref.decode_planes_ref(planes, nbins)
