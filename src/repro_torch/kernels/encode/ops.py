"""Dispatching wrapper for the encode kernel.

Source: `csrc/encode.cu`, replacing `encode_pallas`
(src/repro/kernels/encode/kernel.py:36).  Bound on the H100: device
memory (4 B read, 8 B written per symbol); the codebook sits in shared
memory and a grid-stride loop streams the codes.  See the source.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import huffman as hf
from repro_torch.perf.trace import spanned

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
KERNEL = dispatch.register("encode")


def encode_cuda(codes: torch.Tensor, cb: hf.Codebook
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if codes.device.type != "cuda":
        raise ValueError(f"codes must be on a CUDA device, got {codes.device}")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise TypeError(f"codes must be contiguous int32, got {codes.dtype}")
    nbins = cb.lengths.numel()
    book_codes, book_lens = cb.codes, cb.lengths
    for name, t, dt in (("codebook codes", book_codes, torch.uint32),
                        ("codebook lengths", book_lens, torch.int32)):
        if t.device != codes.device or t.dtype != dt or t.shape != (nbins,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{nbins}] {dt} "
                             f"tensor on {codes.device}")
    n = codes.numel()
    cw = torch.empty(n, dtype=torch.uint32, device=codes.device)
    bw = torch.empty(n, dtype=torch.int32, device=codes.device)
    err = _build.lib().rt_encode(codes.device.index, codes.data_ptr(),
                                 book_codes.data_ptr(), book_lens.data_ptr(),
                                 cw.data_ptr(), bw.data_ptr(), n, nbins,
                                 _build.stream(codes.device))
    _build.check("encode", err)
    KERNEL.launches += 1
    return cw, bw


@spanned(KERNEL.span)
def encode(codes: torch.Tensor, cb: hf.Codebook, impl: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (codewords uint32 [n], bitwidths int32 [n])."""
    impl = dispatch.resolve(KERNEL.name, codes, impl)
    if impl == "cuda":
        return encode_cuda(codes, cb)
    return ref.encode_ref(codes, cb)
