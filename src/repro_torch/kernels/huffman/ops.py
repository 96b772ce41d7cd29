"""Dispatching wrappers for the Huffman codebook kernels.

Source: `csrc/huffman.cu`.  No Pallas kernel computes this stage: the
reference runs it as jitted device functions, `codeword_lengths`
(src/repro/core/huffman.py:113), `canonical_codebook` (:184) and
`build_decode_table` (:458).  Each kernel is one CTA, bound by latency,
not by bytes or operations: the tree by its merge's serial chain of
picks, the codebook and the decode table by a launch and a few barriers;
see the source for the design.  The source also sizes the workspaces:
`rt_huffman_*_scratch_bytes` says how much global scratch a width needs
(none where the workspace fits in shared memory).

`core.huffman.codeword_lengths`, `canonical_codebook` and
`build_decode_table` dispatch here for CUDA tensors: the stage then runs
from the histogram to the encode, and from the stored bitlengths to the
inflate, with no read of the card.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import huffman as hf

from .. import _build, dispatch
from . import ref

# repro-lint: allow[kernel-dispatch] CUDA kernels (csrc/), not Pallas;
# the kernel.py contract of R4 is the JAX package's
TREE, CODEBOOK, DECODE_TABLE = (dispatch.register("huffman.tree"),
                                dispatch.register("huffman.codebook"),
                                dispatch.register("huffman.decode_table"))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.numel() or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty 1-D "
                         f"tensor, got shape {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _scratch_bytes(kernel: str, k: int) -> int:
    """Bytes of global scratch the kernel's workspace needs at `k` bins:
    0 where it fits in shared memory.  The source sizes its layouts
    (`rt_huffman_<kernel>_scratch_bytes`)."""
    return int(getattr(_build.lib(), f"rt_huffman_{kernel}_scratch_bytes")(k))


def _scratch(kernel: str, k: int, device: torch.device
             ) -> Tuple[Optional[torch.Tensor], int]:
    """(buffer, pointer) of a workspace too large for shared memory, else
    (None, 0): the kernel then takes it from shared memory.  The caller
    holds the buffer until the launch is queued; the allocator reuses it
    only behind the kernel, on the same stream."""
    nbytes = _scratch_bytes(kernel, k)
    if not nbytes:
        return None, 0
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf, buf.data_ptr()


def tree_cuda(freq: torch.Tensor) -> torch.Tensor:
    """Codeword lengths of the histogram `freq` by the tree kernel."""
    _check("freq", freq, torch.int32)
    k = freq.numel()
    lengths = torch.empty_like(freq)
    scratch, ptr = _scratch("tree", k, freq.device)
    err = _build.lib().rt_huffman_tree(
        freq.device.index, freq.data_ptr(), lengths.data_ptr(), ptr, k,
        _build.stream(freq.device))
    _build.check("huffman.tree", err)
    TREE.launches += 1
    return lengths


def codebook_cuda(lengths: torch.Tensor) -> hf.Codebook:
    """The canonical codebook of `lengths` by the codebook kernel.  The
    kernel writes its five outputs one after another into one int32
    buffer; the Codebook's fields are views of it, which cost the host
    less than five allocations (the kernel takes a few microseconds, the
    wrapper more)."""
    _check("lengths", lengths, torch.int32)
    k, dev = lengths.numel(), lengths.device
    n = hf.MAXLEN + 1
    out = lengths.new_empty(2 * k + 2 * n + 1)
    scratch, ptr = _scratch("codebook", k, dev)
    err = _build.lib().rt_huffman_codebook(
        dev.index, lengths.data_ptr(), out.data_ptr(), ptr, k,
        _build.stream(dev))
    _build.check("huffman.codebook", err)
    CODEBOOK.launches += 1
    codes, sym_canon, first_code, start_idx, max_len = out.split_with_sizes(
        (k, k, n, n, 1))
    return hf.Codebook(lengths, codes.view(torch.uint32),
                       first_code.view(torch.uint32), start_idx, sym_canon,
                       max_len.view(()))


def decode_table_cuda(cb: hf.Codebook
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(thresh, lmask, lut) of `DecodeTable` for the codebook `cb` by the
    decode-table kernel.  The kernel writes the three one after another
    into one int32 buffer, the LUT first so that its view keeps the
    allocation's alignment for the inflate kernel's loads; they are views
    of it."""
    lengths = cb.lengths
    k, dev = lengths.numel(), lengths.device
    ref.check_lut_symbols(k)
    if dev.type != "cuda" or lengths.dim() != 1 or not k:
        raise ValueError("lengths must be a non-empty 1-D tensor on a CUDA "
                         f"device, got shape {tuple(lengths.shape)} on {dev}")
    n = hf.MAXLEN + 1
    args = [("lengths", lengths, torch.int32, k),
            ("first_code", cb.first_code, torch.uint32, n),
            ("start_idx", cb.start_idx, torch.int32, n),
            ("sym_canon", cb.sym_canon, torch.int32, k),
            ("max_len", cb.max_len, torch.int32, 1)]
    for name, t, dtype, size in args:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev or t.numel() != size or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of {size} "
                             f"entries on {dev}, got {tuple(t.shape)} on "
                             f"{t.device}")
    out = lengths.new_empty((1 << hf.LUT_BITS) + 2 * n)
    err = _build.lib().rt_huffman_decode_table(
        dev.index, lengths.data_ptr(), cb.first_code.data_ptr(),
        cb.start_idx.data_ptr(), cb.sym_canon.data_ptr(),
        cb.max_len.data_ptr(), out.data_ptr(), k, _build.stream(dev))
    _build.check("huffman.decode_table", err)
    DECODE_TABLE.launches += 1
    lut, thresh, lmask = out.split_with_sizes((1 << hf.LUT_BITS, n, n))
    return thresh.view(torch.uint32), lmask, lut
