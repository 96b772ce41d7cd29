"""Dispatching wrappers for the Lorenzo dual-quant kernels.

Source: `csrc/lorenzo.cu`, replacing `dualquant_blocks_pallas` and
`reverse_blocks_pallas` (src/repro/kernels/lorenzo/kernel.py:76, :96).
Both are bound by device memory on the H100 (12 B and 8 B per value).
In both directions one warp owns one block of the default shapes (256),
(16,16) and (8,8,8): 16 B loads and stores, the in-register axis
differenced (dual-quant) or scanned (reverse) in place and the other
axes through warp shuffles, no shared memory, no barrier and no runtime
divide.  Other blocks, and a reverse on buffers not 16 B aligned, take
a generic kernel that stages one block per CTA in shared memory.  See
the source for the design.

Dual-quant reads its input where it lies, in its own strides.
`dualquant_field` takes the field itself: the kernel folds the
edge-replicate pad to whole blocks and the block split into its
addressing, so no copy of the field is made first; its plain version
pads and splits in torch (`DUALQUANT.host_copies` counts those calls).
`dualquant_blocks` takes blocked input [nb..., b...], as the
reference's `dualquant_blocks_pallas` does.  Both return codes and
delta in the blocked layout over the padded grid.  Rows that are not
16 B aligned, and blocks on the field's ragged edge, take scalar loads
inside the same kernels.

The reverse sees blocked data as [nblocks, prod(block)]: `block_merge`
stays in Python.  Block axes of extent 1 are inert (a shift along them
is zero), so up to four non-unit block axes are supported.
"""
from __future__ import annotations

import ctypes
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import dualquant as dq
from repro_torch.perf.trace import spanned

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
DUALQUANT = dispatch.register("lorenzo.dualquant")
# repro-lint: allow[kernel-dispatch] a CUDA kernel (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
REVERSE = dispatch.register("lorenzo.reverse")

_MAX_SMEM = 227 * 1024
_MAX_AXES = 4           # non-unit block axes (csrc kMaxAxes)
_MAX_GRID = 8           # block grid axes after folding (csrc kMaxGrid)
_MAX_BLOCKS = 2 ** 31 - 1

# one axis of the input as dual-quant reads it: (blocks, element step
# from one block to the next, block extent, element stride, the field's
# extent, past which a coordinate reads the last value)
Axis = Tuple[int, int, int, int, int]


def _block_dims(shape: Tuple[int, ...], smem_per_value: int
                ) -> Tuple[int, Tuple[int, int, int, int]]:
    """(nblocks, four block extents) for a blocked [nb..., b...] shape."""
    nd = len(shape) // 2
    block = [int(b) for b in shape[nd:] if b != 1]
    _check_block(tuple(shape[nd:]), block, smem_per_value)
    dims = (1,) * (4 - len(block)) + tuple(block)
    return math.prod(shape[:nd]), dims


def _check_block(block: Tuple[int, ...], nonunit: List[int],
                 smem_per_value: int) -> None:
    if len(nonunit) > _MAX_AXES:
        raise ValueError(f"block {block} has more than four non-unit axes")
    total = math.prod(nonunit)
    if total * smem_per_value > _MAX_SMEM:
        raise ValueError(f"block of {total} values does not fit in shared "
                         f"memory ({smem_per_value} B per value)")


def field_axes(shape: Sequence[int], strides: Sequence[int],
               block: Sequence[int]) -> List[Axis]:
    """The axes of a field of `shape` and element `strides` cut into
    `block`s, over the grid padded to whole blocks."""
    return [(-(-d // b), b * s, b, s, d)
            for d, s, b in zip(shape, strides, block)]


def blocked_axes(shape: Sequence[int], strides: Sequence[int]
                 ) -> List[Axis]:
    """The axes of a blocked [nb..., b...] tensor: its own strides, with
    extents that never clamp."""
    nd = len(shape) // 2
    return [(shape[a], strides[a], shape[nd + a], strides[nd + a],
             shape[a] * shape[nd + a]) for a in range(nd)]


def kernel_layout(axes: Sequence[Axis], block: Tuple[int, ...]
                  ) -> Tuple[List[Tuple[int, int]],
                             List[Tuple[int, int, int, int]]]:
    """The kernel's view of `axes`: the block grid's (blocks, step) pairs
    in row-major order, and four (extent, grid axis or -1, stride, field
    extent) block axes, right-aligned.  Axes of one block of extent 1 are
    dropped, and neighbouring axes of block extent 1 that step evenly
    (the leading axes of a >3-D field) are merged into one grid axis."""
    grid: List[Tuple[int, int]] = []
    merge = False            # the last grid axis has block extent 1
    inner: List[Tuple[int, int, int, int]] = []
    for nb, step, size, stride, extent in axes:
        if size == 1:
            if nb == 1:
                continue
            if merge and grid[-1][1] == nb * step:
                grid[-1] = (grid[-1][0] * nb, step)
                continue
        else:
            inner.append((size, len(grid), stride, extent))
        grid.append((nb, step))
        merge = size == 1
    _check_block(block, [a[0] for a in inner], 4)
    if len(grid) > _MAX_GRID:
        raise ValueError(f"a block grid of {len(grid)} axes (after merging) "
                         f"has more than {_MAX_GRID}")
    if math.prod(nb for nb, _ in grid) > _MAX_BLOCKS:
        raise ValueError(f"more than {_MAX_BLOCKS} Lorenzo blocks")
    inner = [(1, -1, 0, 1)] * (_MAX_AXES - len(inner)) + inner
    return grid or [(1, 0)], inner


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")


def _check_blocked(t: torch.Tensor, what: str) -> None:
    if t.ndim % 2:
        raise ValueError(f"{what} must be blocked [nb..., b...], got shape "
                         f"{tuple(t.shape)}")


def _dualquant_cuda(x: torch.Tensor, axes: Sequence[Axis],
                    block: Tuple[int, ...], eb: float, nbins: int):
    grid, inner = kernel_layout(axes, block)
    shape = tuple(a[0] for a in axes) + block
    codes = torch.empty(shape, dtype=torch.int32, device=x.device)
    delta = torch.empty(shape, dtype=torch.int32, device=x.device)
    g = list(itertools.chain(*grid))
    b = list(itertools.chain(*inner))
    err = _build.lib().rt_dualquant(
        x.device.index, x.data_ptr(), codes.data_ptr(), delta.data_ptr(),
        len(grid), (ctypes.c_longlong * len(g))(*g),
        (ctypes.c_longlong * len(b))(*b), ref.inv_two_eb(eb), int(nbins),
        _build.stream(x.device))
    _build.check("lorenzo.dualquant", err)
    DUALQUANT.launches += 1
    return codes, delta


def dualquant_blocks_cuda(xb: torch.Tensor, eb: float, nbins: int):
    _check(xb, torch.float32, "xb")
    _check_blocked(xb, "xb")
    nd = xb.ndim // 2
    return _dualquant_cuda(xb, blocked_axes(xb.shape, xb.stride()),
                           tuple(xb.shape[nd:]), eb, nbins)


def dualquant_field_cuda(x: torch.Tensor, block: Tuple[int, ...],
                         eb: float, nbins: int):
    _check(x, torch.float32, "x")
    if len(block) != x.ndim:
        raise ValueError(f"block {block} does not match a {x.ndim}-D input")
    return _dualquant_cuda(x, field_axes(x.shape, x.stride(), block), block,
                           eb, nbins)


def reverse_blocks_cuda(delta: torch.Tensor, eb: float) -> torch.Tensor:
    _check(delta, torch.int32, "delta")
    _check_blocked(delta, "delta")
    if not delta.is_contiguous():
        raise ValueError("delta must be contiguous")
    nblocks, dims = _block_dims(tuple(delta.shape), 8)
    out = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    err = _build.lib().rt_reverse(
        delta.device.index, delta.data_ptr(), out.data_ptr(), nblocks, *dims,
        float(2.0 * eb), _build.stream(delta.device))
    _build.check("lorenzo.reverse", err)
    REVERSE.launches += 1
    return out


@spanned(DUALQUANT.span)
def dualquant_field(x: torch.Tensor, block: Sequence[int], eb: float,
                    nbins: int, impl: Optional[str] = None):
    """Edge pad + block split + PREQUANT + ℓ-delta + POSTQUANT on the
    field `x` (any strides), one Lorenzo block extent per axis of x.
    Returns (codes, delta), both int32 shaped [nb..., b...] over x padded
    to whole blocks: the bits of `dualquant_blocks` on
    `block_split(pad_to_blocks(x, block), block)`.  The kernel reads x in
    place; the plain version makes that blocked copy."""
    impl = dispatch.resolve(DUALQUANT.name, x, impl)
    block = tuple(int(b) for b in block)
    if impl == "cuda":
        return dualquant_field_cuda(x, block, eb, nbins)
    DUALQUANT.host_copies += 1
    xb = dq.block_split(dq.pad_to_blocks(x, block), block)
    return ref.dualquant_blocks_ref(xb, eb, nbins)


@spanned(DUALQUANT.span)
def dualquant_blocks(xb: torch.Tensor, eb: float, nbins: int,
                     impl: Optional[str] = None):
    """Fused PREQUANT + ℓ-delta + POSTQUANT on blocked input [nb..., b...]
    (any strides).  Returns (codes, delta), both int32 shaped like xb."""
    impl = dispatch.resolve(DUALQUANT.name, xb, impl)
    if impl == "cuda":
        return dualquant_blocks_cuda(xb, eb, nbins)
    return ref.dualquant_blocks_ref(xb, eb, nbins)


@spanned(REVERSE.span)
def reverse_blocks(delta: torch.Tensor, eb: float,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Per-block cumsum inverse + dequant.  Returns blocked float32."""
    impl = dispatch.resolve(REVERSE.name, delta, impl)
    if impl == "cuda":
        return reverse_blocks_cuda(delta, eb)
    return ref.reverse_blocks_ref(delta, eb)
