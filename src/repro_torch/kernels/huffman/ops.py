"""Dispatching wrappers for the Huffman codebook kernels.

Source: `csrc/huffman.cu`.  No Pallas kernel computes this stage: the
reference runs it as jitted device functions, `codeword_lengths`
(src/repro/core/huffman.py:113), `canonical_codebook` (:184) and
`build_decode_table` (:458).  Each kernel is one CTA, bound by the
latency of its serial chain (the tree's merge and depth pass), not by
bytes or operations; see the source for the design.

`core.huffman.codeword_lengths`, `canonical_codebook` and
`build_decode_table` dispatch here for CUDA tensors: the stage then runs
from the histogram to the encode, and from the stored bitlengths to the
inflate, with no read of the card.
"""
from __future__ import annotations

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

#: dynamic shared memory a kernel's workspace may take (`kMaxSmem` in the
#: source); a larger one goes to a global scratch
SMEM_BYTES = 226 * 1024


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.numel() or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty 1-D "
                         f"tensor, got shape {tuple(t.shape)}")


def _scratch(nbytes: int, device: torch.device
             ) -> Tuple[Optional[torch.Tensor], int]:
    """(buffer, pointer) of a workspace too large for shared memory, else
    (None, 0): the kernel then takes it from shared memory.  The caller
    holds the buffer until the launch is queued; the allocator reuses it
    only behind the kernel, on the same stream."""
    if nbytes <= SMEM_BYTES:
        return None, 0
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf, buf.data_ptr()


def tree_cuda(freq: torch.Tensor) -> torch.Tensor:
    _check("freq", freq, torch.int32)
    k = freq.numel()
    lengths = torch.empty(k, dtype=torch.int32, device=freq.device)
    scratch, ptr = _scratch(8 * _pow2(k) + 20 * k, freq.device)
    err = _build.lib().rt_huffman_tree(freq.device.index, freq.data_ptr(),
                                       lengths.data_ptr(), ptr, k,
                                       _build.stream(freq.device))
    _build.check("huffman.tree", err)
    TREE.launches += 1
    return lengths


def codebook_cuda(lengths: torch.Tensor) -> hf.Codebook:
    _check("lengths", lengths, torch.int32)
    k, dev = lengths.numel(), lengths.device
    codes = torch.empty(k, dtype=torch.uint32, device=dev)
    first_code = torch.empty(hf.MAXLEN + 1, dtype=torch.uint32, device=dev)
    start_idx = torch.empty(hf.MAXLEN + 1, dtype=torch.int32, device=dev)
    sym_canon = torch.empty(k, dtype=torch.int32, device=dev)
    max_len = torch.empty((), dtype=torch.int32, device=dev)
    scratch, ptr = _scratch(8 * _pow2(k), dev)
    err = _build.lib().rt_huffman_codebook(
        dev.index, lengths.data_ptr(), codes.data_ptr(),
        first_code.data_ptr(), start_idx.data_ptr(), sym_canon.data_ptr(),
        max_len.data_ptr(), ptr, k, _build.stream(dev))
    _build.check("huffman.codebook", err)
    CODEBOOK.launches += 1
    return hf.Codebook(lengths, codes, first_code, start_idx, sym_canon,
                       max_len)


def decode_table_cuda(cb: hf.Codebook
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    k = cb.lengths.numel()
    ref.check_lut_symbols(k)
    for name, t, dt in (("lengths", cb.lengths, torch.int32),
                        ("first_code", cb.first_code, torch.uint32),
                        ("start_idx", cb.start_idx, torch.int32),
                        ("sym_canon", cb.sym_canon, torch.int32),
                        ("max_len", cb.max_len.reshape(1), torch.int32)):
        _check(name, t, dt)
        if t.device != cb.lengths.device:
            raise ValueError(f"{name} is on {t.device}, the lengths on "
                             f"{cb.lengths.device}")
    dev = cb.lengths.device
    thresh = torch.empty(hf.MAXLEN + 1, dtype=torch.uint32, device=dev)
    lmask = torch.empty(hf.MAXLEN + 1, dtype=torch.int32, device=dev)
    lut = torch.empty(1 << hf.LUT_BITS, dtype=torch.int32, device=dev)
    err = _build.lib().rt_huffman_decode_table(
        dev.index, cb.lengths.data_ptr(), cb.first_code.data_ptr(),
        cb.start_idx.data_ptr(), cb.sym_canon.data_ptr(),
        cb.max_len.data_ptr(), thresh.data_ptr(), lmask.data_ptr(),
        lut.data_ptr(), k, _build.stream(dev))
    _build.check("huffman.decode_table", err)
    DECODE_TABLE.launches += 1
    return thresh, lmask, lut
