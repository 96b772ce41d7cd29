"""Dispatching wrappers for the interpolation-level kernels.

Source: `csrc/interp.cu`, replacing `residual_rows_pallas` and
`odd_rows_pallas` (src/repro/kernels/interp/kernel.py:62, :67).  Both are
bound by device memory on the H100 (about 12 B per output value: the
padded even row, the odd row in, the result out); every output value is
independent, so the kernel runs one thread per value over the flattened
[R, mo] output, and a level of one long row (HACC) fills the card as
well as one of many short rows (NYX).  See the source for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
PREDICT = dispatch.register("interp.predict")
# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
RECONSTRUCT = dispatch.register("interp.reconstruct")


def _launch(entry: str, kernel: dispatch.Kernel, pe: torch.Tensor,
            other: torch.Tensor) -> torch.Tensor:
    for what, t in (("pe", pe), (kernel.name + " input", other)):
        if t.device.type != "cuda":
            raise ValueError(f"{what} must be on a CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what} must be int32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")
    if pe.device != other.device:
        raise ValueError(f"pe on {pe.device}, input on {other.device}")
    rows, mo = other.shape
    if pe.shape[0] != rows or pe.shape[1] < mo + 3:
        raise ValueError(f"pe {tuple(pe.shape)} does not pad rows of "
                         f"{tuple(other.shape)} (need [{rows}, >= {mo + 3}])")
    out = torch.empty_like(other)
    err = getattr(_build.lib(), entry)(
        pe.device.index, pe.data_ptr(), other.data_ptr(), out.data_ptr(),
        rows, mo, pe.shape[1], _build.stream(pe.device))
    _build.check(kernel.name, err)
    kernel.launches += 1
    return out


def residual_rows_cuda(pe: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    return _launch("rt_interp_residual", PREDICT, pe, odd)


def odd_rows_cuda(pe: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    return _launch("rt_interp_odd", RECONSTRUCT, pe, resid)


def residual_rows(pe: torch.Tensor, odd: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Encode direction of one interpolation level: residual = odd −
    p(even).  `pe` is the padded even rows [R, me+3], `odd` the odd rows
    [R, mo]."""
    impl = dispatch.resolve(PREDICT.name, pe, impl)
    if impl == "cuda":
        return residual_rows_cuda(pe, odd)
    return ref.residual_rows_ref(pe, odd)


def odd_rows(pe: torch.Tensor, resid: torch.Tensor,
             impl: Optional[str] = None) -> torch.Tensor:
    """Decode direction: odd = residual + p(even)."""
    impl = dispatch.resolve(RECONSTRUCT.name, pe, impl)
    if impl == "cuda":
        return odd_rows_cuda(pe, resid)
    return ref.odd_rows_ref(pe, resid)
