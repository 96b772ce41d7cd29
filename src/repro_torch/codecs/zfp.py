"""cuZFP-like fixed-rate codec behind the `Codec` protocol.

Wraps `core.zfp_like`'s split transform halves: encode stores the
plane-truncated negabinary coefficients + per-block exponents; decode
inverts.  >3D inputs are treated as a batch of 3D fields, as in the
reference.

The payload arrays are kept at 32-bit lane width (the fixed-rate
truncation is a bitmask, not a bit-packer), so `stored_nbytes` reports
the *logical* fixed-rate size: `planes` bits per coefficient + 16 bits
per block of header, the achieved-bitrate accounting of the reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import zfp_like as Z
from repro_torch.core.dualquant import block_merge, block_split, pad_to_blocks

from .base import Codec, as_tensor, register
from .container import Container


@dataclasses.dataclass(frozen=True)
class ZfpCodec(Codec):
    rate_bits: float = 12.0
    name = "zfp"
    version = 1
    # 4^d transform blocks span slice boundaries after padding; splitting
    # changes block alignment and thus the decode, so no sharded encode.
    shardable = False

    @property
    def planes(self) -> int:
        return max(1, int(round(self.rate_bits)))

    def encode(self, x, *, cfg=None, device=None) -> Container:
        xf = as_tensor(x, device).to(torch.float32)
        nd = min(xf.ndim, 3)
        if xf.ndim > 3:
            lead = math.prod(xf.shape[:-3])
            xr = xf.reshape((lead,) + tuple(xf.shape[-3:]))
            xb = block_split(pad_to_blocks(xr, (1, 4, 4, 4)), (1, 4, 4, 4))
            xb = xb.squeeze(-4)                    # drop the size-1 block dim
        else:
            xb = block_split(pad_to_blocks(xf, (4,) * nd), (4,) * nd)
        u, e = Z.encode_blocks(xb, self.planes, nd)
        return Container(self._header(x, planes=self.planes, nd=nd),
                         {"u": u, "e": e})

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        p = self._device_payload(c, device)
        h = c.header
        nd = int(h.param("nd"))
        rec = Z.decode_blocks(p["u"], p["e"], nd)
        shape = h.shape
        if len(shape) > 3:
            lead = math.prod(shape[:-3])
            full = block_merge(rec.unsqueeze(-4), (1, 4, 4, 4))
            y = full[tuple(slice(0, s) for s in (lead,) + shape[-3:])
                     ].reshape(shape)
        else:
            full = block_merge(rec, (4,) * nd)
            y = full[tuple(slice(0, s) for s in shape)]
        return self._finish(y, h, like)

    def stored_nbytes(self, c: Container) -> int:
        u = c.payload["u"]
        planes = int(c.header.param("planes"))
        nd = int(c.header.param("nd"))
        nblocks = int(np.prod(u.shape[:-nd]))
        bits = planes * int(np.prod(u.shape)) + 16 * nblocks
        return -(-bits // 8)

    def achieved_bitrate(self, c: Container) -> float:
        """Bits per source value at the stored fixed rate."""
        nd = int(c.header.param("nd"))
        return int(c.header.param("planes")) + 16.0 / (4 ** nd)


register("zfp", lambda **kw: ZfpCodec(**kw))
