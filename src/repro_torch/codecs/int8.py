"""Narrow-integer PREQUANT codecs (the paper's d° = round(d/(2·eb)) with
scale-derived bounds) — the int8/int16 quantization math every integer
surface of the port shares:

  * `Int8Codec` ("int8" / "int16"): one scale per tensor.
  * `BlockInt8Codec` ("int8-block"): blockwise scales along one axis.
    The KV cache (seq axis) is an instance of this codec.

The effective absolute error bound of either codec is scale/2 per
element, recorded by construction (scale lives in the payload because it
is data-dependent; axis/block/bits are static header params).  Payloads
and packed containers are the reference's, byte for byte: the scale is
computed in the source dtype before the cast to float32 (blockwise) and
every divide is an IEEE divide by a tensor, never a multiply by a
reciprocal (except `block_quantize(reciprocal=True)`, the reference's
compiled form, which the KV cache's decode-side requantize needs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import even_shard_axis

from .base import Codec, as_tensor, register, slice_axis
from .container import Container

_QDTYPES = {8: torch.int8, 16: torch.int16}
_SCALE_FLOOR = 1e-30


def qmax_of(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """`a / b` as an IEEE divide in a's dtype (a 0-d tensor divisor: on
    CUDA a Python-scalar divisor becomes a multiply by its reciprocal)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def recip(b: float, like: torch.Tensor) -> torch.Tensor:
    """`1/b` rounded to like's dtype (the constant XLA multiplies by where
    compiled code divides by the constant `b`)."""
    return torch.tensor(1.0 / b, dtype=torch.float32).to(like.dtype).to(
        like.device)


def _floor(a: torch.Tensor) -> torch.Tensor:
    """max(a, 1e-30) with the floor rounded to a's dtype."""
    return torch.maximum(a, torch.tensor(_SCALE_FLOOR, dtype=a.dtype,
                                         device=a.device))


# ---------------------------------------------------------------------------
# Shared quantization math
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, qmax: float, qdtype,
             scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization.  `scale` overrides the derived
    amax/qmax scale (a pinned, shared scale)."""
    xf = x.to(torch.float32)
    if scale is None:
        scale = _floor(true_div(xf.abs().amax(), qmax))
    q = torch.round(xf / scale).clamp(-qmax, qmax).to(qdtype)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _split(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    s = x.shape[axis]
    assert s % block == 0, (tuple(x.shape), axis, block)
    return x.reshape(x.shape[:axis] + (s // block, block)
                     + x.shape[axis + 1:])


def _merge(xb: torch.Tensor, axis: int) -> torch.Tensor:
    return xb.reshape(xb.shape[:axis]
                      + (xb.shape[axis] * xb.shape[axis + 1],)
                      + xb.shape[axis + 2:])


def block_quantize(x: torch.Tensor, axis: int, block: int,
                   qmax: float = 127.0, reciprocal: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantization along `axis` (length must divide into
    `block`-sized groups).  Returns (q int8 of x.shape, scale f32 of
    x.shape with the `axis` dim shrunk to n_blocks).  `reciprocal=True`
    derives the scale as the reference's compiled (jitted) code does:
    XLA rewrites the divide by the constant `qmax` into a multiply by its
    reciprocal in x's dtype."""
    axis = axis % x.ndim
    xb = _split(x, axis, block)
    amax = xb.abs().amax(dim=axis + 1, keepdim=True)
    scale = (amax * recip(qmax, amax) if reciprocal
             else true_div(amax, qmax))
    scale = _floor(scale).to(torch.float32)
    q = torch.round(xb.to(torch.float32) / scale).clamp(-qmax, qmax
                                                        ).to(torch.int8)
    return _merge(q, axis), scale.squeeze(axis + 1)


def block_dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int,
                     block: int, dtype=torch.float32) -> torch.Tensor:
    axis = axis % q.ndim
    qb = _split(q, axis, block)
    x = qb.to(torch.float32) * scale.unsqueeze(axis + 1)
    return _merge(x.to(dtype), axis)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int8Codec(Codec):
    """Per-tensor narrow-int codec ("int8" / "int16" by `bits`)."""
    bits: int = 8
    version = 1

    @property
    def name(self) -> str:
        return f"int{self.bits}"

    @property
    def qmax(self) -> int:
        return qmax_of(self.bits)

    @property
    def qdtype(self):
        return _QDTYPES[self.bits]

    def encode(self, x, *, cfg=None, device=None) -> Container:
        q, scale = quantize(as_tensor(x, device), float(self.qmax),
                            self.qdtype)
        return Container(self._header(x, bits=self.bits),
                         {"q": q, "scale": scale})

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        p = self._device_payload(c, device)
        return self._finish(dequantize(p["q"], p["scale"]), c.header, like)

    # -- sharded encode: split-stable because the scale is pinned globally
    def shard_axis(self, shape, nshards: int):
        return even_shard_axis(shape, nshards)

    def encode_parts(self, x, axis: int, nshards: int):
        """Per-slice containers that decode bit-identically to a whole-
        tensor encode: the per-tensor scale is derived once from the full
        tensor and pinned for every slice (each part stores a copy)."""
        t = as_tensor(x)
        scale = _floor(true_div(t.to(torch.float32).abs().amax(),
                            float(self.qmax)))
        step = t.shape[axis] // nshards
        parts = []
        for h in range(nshards):
            sl = slice_axis(t, axis, h * step, (h + 1) * step)
            q, _ = quantize(sl, float(self.qmax), self.qdtype, scale=scale)
            parts.append(Container(self._header(sl, bits=self.bits),
                                   {"q": q, "scale": scale}))
        return parts

    def payload_axes(self, axis: int):
        return {"q": axis, "scale": None}       # scale is the shared pin


@dataclasses.dataclass(frozen=True)
class BlockInt8Codec(Codec):
    """Blockwise int8 codec: one f32 scale per `block` elements along
    `axis`.  KV caches use (axis=seq, block=128)."""
    axis: int = -1
    block: int = 128
    name = "int8-block"
    version = 1

    def encode(self, x, *, cfg=None, device=None) -> Container:
        t = as_tensor(x, device)
        axis = self.axis % t.ndim
        q, scale = block_quantize(t, axis, self.block)
        return Container(self._header(x, axis=axis, block=self.block),
                         {"q": q, "scale": scale})

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        p = self._device_payload(c, device)
        y = block_dequantize(p["q"], p["scale"], int(c.header.param("axis")),
                             int(c.header.param("block")))
        return self._finish(y, c.header, like)

    # -- sharded encode: split-stable as long as no scale block straddles
    # a slice boundary (block amaxes are local to each slice then)
    def shard_axis(self, shape, nshards: int):
        qaxis = self.axis % len(shape) if shape else None
        if qaxis is None or int(shape[qaxis]) % self.block != 0:
            return None                  # whole-tensor encode would assert
        best = None
        for i, s in enumerate(shape):
            aligned = self.block if i == qaxis else 1
            if even_shard_axis((s,), nshards, multiple_of=aligned) == 0:
                if best is None or int(s) > int(shape[best]):
                    best = i
        return best

    def payload_axes(self, axis: int):
        # scale mirrors the source rank (quantized axis shrunk /block),
        # so the concat axis index is the same for both fields
        return {"q": axis, "scale": axis}


register("int8", lambda **kw: Int8Codec(bits=8, **kw))
register("int16", lambda **kw: Int8Codec(bits=16, **kw))
register("int8-block", lambda **kw: BlockInt8Codec(**kw))
