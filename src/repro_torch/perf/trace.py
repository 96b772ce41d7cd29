"""Named spans at the port's host layer boundaries, kept in
`torch.profiler`'s trace.

A span is `torch.profiler.record_function(name)` while a profiler is
recording, and one shared no-op context otherwise, so a call that runs
under no profiler pays a flag test and an empty `with`.  Under a profiler
the span lands in the exported Chrome trace (category
``user_annotation``) beside the operators, the runtime calls and the
card's kernels, on the same clock: each stretch of device idle time can be
put down to the span that was open.  There is no other store: run any
call of the port under ``torch.profiler.profile`` and export its trace.

Spans are named ``<layer>.<what>``:

  codec.encode         codec + container: a staged codec's encode
                       (`CuszCodec.encode`, which cusz-i inherits, and
                       `FzCodec.encode`)
  codec.decode         codec + container: the registry's `codecs.decode`
                       (lookup, optional checksum, version check, the
                       codec's unpack and decode)
  stage.resolve_eb     compressor + stages, `core.compressor`: the error
                       bound's min/max read
  stage.predict        the dispatch policy and the predictor
  stage.encode         the encoder
  stage.decode_meta    the encoder's host metadata: the `max_len` read
                       and the decode table (cached, or built)
  stage.decode         the dispatch policy and the decoder
  stage.reconstruct    the predictor's inverse
  stage.interp.levels  inside `stage.predict` / `stage.reconstruct` of
                       the interpolation predictor (cusz-i): its level
                       loop, one span per field
  dispatch.<kernel>    kernel dispatch + ops: the function that resolves
                       a registered kernel (`dispatch.PIPELINE_STAGES`;
                       one per kernel, two entries for dual-quant) and
                       runs the CUDA kernel's wrapper or the plain
                       version: its checks, allocations and launch

So the number of `dispatch.huffman.decode_table` spans in a trace is the
number of decode tables built; launches stay counted in
`kernels.dispatch`.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, TypeVar

import torch
import torch.autograd.profiler as _profiler

F = TypeVar("F", bound=Callable)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in the profiler's trace while one is
    recording; the shared no-op otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str) -> Callable[[F], F]:
    """`span(name)` around every call of the decorated function."""
    def wrap(fn: F) -> F:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
