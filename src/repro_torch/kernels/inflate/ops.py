"""Dispatching wrapper for the gap-array inflate kernel.

Source: `csrc/inflate.cu`, replacing `inflate_pallas`
(src/repro/kernels/inflate/kernel.py:103).  Its bytes are almost all the
4 B written per symbol; what decides its time on the H100 is the work of
each of the `sub_size` dependent steps per cursor and whether the stores
coalesce.  One thread per subchunk cursor decodes a step with one
shared-memory load from the 12-bit LUT of the `DecodeTable` (the interval
compare only for longer codewords), reads the stream through a register
bit buffer, and writes through a per-warp shared tile in 64 B runs.  See
the source.

Gap-less (format v1) streams decode through the sequential decoder
(`huffman.inflate`), as torch ops on the words' device: no TPU kernel
computes it, so it has no CUDA kernel.  An explicit kernel request on
such a stream raises, as in the reference, since the kernel is the gap
decoder.
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
KERNEL = dispatch.register("inflate")


def inflate_cuda(words: torch.Tensor, n_valid: torch.Tensor,
                 gap_bits: torch.Tensor, table: hf.DecodeTable,
                 sub_size: int) -> torch.Tensor:
    nc, W = words.shape
    n_sub = gap_bits.shape[1]
    if n_sub * sub_size != W:
        raise ValueError(f"gap array [{nc}, {n_sub}] does not tile chunks "
                         f"of {W} symbols with sub_size={sub_size}")
    cb = table.cb
    k = cb.sym_canon.numel()
    dev = words.device
    args = (("words", words, torch.uint32, (nc, W)),
            ("n_valid", n_valid, torch.int32, (nc,)),
            ("gap_bits", gap_bits, torch.int32, (nc, n_sub)),
            ("thresh", table.thresh, torch.uint32, (hf.MAXLEN + 1,)),
            ("lmask", table.lmask, torch.int32, (hf.MAXLEN + 1,)),
            ("first_code", cb.first_code, torch.uint32, (hf.MAXLEN + 1,)),
            ("start_idx", cb.start_idx, torch.int32, (hf.MAXLEN + 1,)),
            ("sym_canon", cb.sym_canon, torch.int32, (k,)),
            ("lut", table.lut, torch.int32, (1 << hf.LUT_BITS,)))
    for name, t, dt, shape in args:
        if t.device != dev or dev.type != "cuda" or t.dtype != dt \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} on a CUDA device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((nc, W), dtype=torch.int32, device=dev)
    err = _build.lib().rt_inflate(
        dev.index, words.data_ptr(), n_valid.data_ptr(), gap_bits.data_ptr(),
        table.thresh.data_ptr(), table.lmask.data_ptr(),
        cb.first_code.data_ptr(), cb.start_idx.data_ptr(),
        cb.sym_canon.data_ptr(), table.lut.data_ptr(), k, out.data_ptr(),
        nc, W, int(sub_size),
        _build.stream(dev))
    _build.check("inflate", err)
    KERNEL.launches += 1
    return out


@spanned(KERNEL.span)
def inflate(words: torch.Tensor, n_valid: torch.Tensor,
            table: hf.DecodeTable, gaps: Optional[torch.Tensor] = None,
            sub_size: Optional[int] = None,
            impl: Optional[str] = None,
            bits_used: Optional[torch.Tensor] = None,
            max_len_static: Optional[int] = None) -> torch.Tensor:
    """Decode [nc, W] stream words to int32 codes [nc, W] (chunk order).
    A gap-less stream (`gaps` None) needs `bits_used` and the bucketed
    max codeword length `max_len_static` for the sequential decoder."""
    if gaps is None:
        if impl == "cuda":
            raise NotImplementedError(
                "inflate impl='cuda' needs the gap array: the CUDA kernel is "
                "the gap-array subchunk decoder")
        if bits_used is None or max_len_static is None:
            raise ValueError(
                "the sequential decoder of a gap-less (format v1) stream "
                "needs bits_used and max_len_static")
        return hf.inflate(words, bits_used, n_valid, table.cb,
                          max_len_static)
    if sub_size is None:
        sub_size = words.shape[1] // gaps.shape[1]
    impl = dispatch.resolve(KERNEL.name, words, impl)
    if impl == "cuda":
        return inflate_cuda(words, n_valid, gaps, table, sub_size)
    return ref.inflate_gap_ref(words, n_valid, gaps, table, sub_size)
