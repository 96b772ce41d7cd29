"""Dispatching wrapper for the histogram kernel.

Source: `csrc/histogram.cu`, replacing `histogram_pallas`
(src/repro/kernels/histogram/kernel.py:41).  Bound on the H100: device
memory on paper (4 B per code), shared-memory atomics in practice, since
error-bounded codes crowd a few bins; the kernel keeps one private
histogram per CTA and aggregates equal bins inside a warp before its
atomicAdd.  See the source for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.perf.trace import spanned

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
KERNEL = dispatch.register("histogram")


def histogram_cuda(codes: torch.Tensor, nbins: int) -> torch.Tensor:
    if codes.device.type != "cuda":
        raise ValueError(f"codes must be on a CUDA device, got {codes.device}")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    hist = torch.empty(nbins, dtype=torch.int32, device=codes.device)
    err = _build.lib().rt_histogram(codes.device.index, codes.data_ptr(),
                                    hist.data_ptr(), codes.numel(),
                                    int(nbins), _build.stream(codes.device))
    _build.check("histogram", err)
    KERNEL.launches += 1
    return hist


@spanned(KERNEL.span)
def histogram(codes: torch.Tensor, nbins: int,
              impl: Optional[str] = None) -> torch.Tensor:
    impl = dispatch.resolve(KERNEL.name, codes, impl)
    if impl == "cuda":
        return histogram_cuda(codes, nbins)
    return ref.histogram_ref(codes, nbins)
