"""Dispatching wrapper for the deflate kernel.

Source: `csrc/deflate.cu`, replacing `deflate_pallas`
(src/repro/kernels/deflate/kernel.py:69).  Bound on the H100: device
memory (8 B read per symbol, one u32 word written per symbol slot); one
CTA per chunk scans the bitwidths and ORs codeword fragments into the
chunk's words in shared memory.  See the source.

Returns `(words, bits_used, gap_bits, gap_syms)`: beside the packed
stream, deflate samples its exclusive prefix sums at every
`sub_size`-symbol boundary (the gap array) for the parallel inflate.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import huffman as hf
from repro_torch.perf.trace import spanned

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
KERNEL = dispatch.register("deflate")

_MAX_SMEM = 227 * 1024


def deflate_cuda(cw: torch.Tensor, bw: torch.Tensor, chunk_size: int,
                 sub_size: int):
    sub = hf.norm_sub_size(chunk_size, sub_size)
    for name, t, dt in (("cw", cw, torch.uint32), ("bw", bw, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
    if cw.numel() != bw.numel() or cw.device != bw.device:
        raise ValueError("cw and bw must have the same size and device")
    if chunk_size * 4 > _MAX_SMEM:
        raise ValueError(f"chunk_size {chunk_size} does not fit the chunk's "
                         "words in shared memory")
    n = cw.numel()
    nc = -(-n // chunk_size)
    dev = cw.device
    words = torch.empty((nc, chunk_size), dtype=torch.uint32, device=dev)
    bits = torch.empty(nc, dtype=torch.int32, device=dev)
    gap_bits = torch.empty((nc, chunk_size // sub), dtype=torch.int32,
                           device=dev)
    gap_syms = torch.empty_like(gap_bits)
    err = _build.lib().rt_deflate(
        dev.index, cw.data_ptr(), bw.data_ptr(), n, words.data_ptr(),
        bits.data_ptr(), gap_bits.data_ptr(), gap_syms.data_ptr(), nc,
        int(chunk_size), sub, _build.stream(dev))
    _build.check("deflate", err)
    KERNEL.launches += 1
    return words, bits, gap_bits, gap_syms


@spanned(KERNEL.span)
def deflate(cw: torch.Tensor, bw: torch.Tensor, chunk_size: int = 512,
            sub_size: int = hf.SUBCHUNK, impl: Optional[str] = None):
    impl = dispatch.resolve(KERNEL.name, cw, impl)
    if impl == "cuda":
        return deflate_cuda(cw, bw, chunk_size, sub_size)
    return ref.deflate_ref(cw, bw, chunk_size, sub_size)
