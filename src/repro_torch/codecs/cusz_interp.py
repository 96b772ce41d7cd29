"""cuSZ-i ("cusz-i"): the interpolation predictor composed with the
canonical-Huffman encoder, behind the same `Codec` protocol.

It is `CuszCodec` with `CompressorConfig.predictor` set to "interp": the
container, pack and validity paths are inherited, because the blob
surface carries the interp anchor grid in its optional `anchor` field.
On smooth fields the multi-level cubic interpolation leaves far smaller
residuals than blocked Lorenzo, which concentrates the quant-code
histogram and buys ratio at the same error bound (arXiv 2312.05492).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import compressor as CZ

from .base import register
from .cusz import CuszCodec


@dataclasses.dataclass(frozen=True)
class CuszInterpCodec(CuszCodec):
    cfg: CZ.CompressorConfig = CZ.CompressorConfig(predictor="interp")
    name = "cusz-i"
    version = 1
    # interpolation levels span the whole tensor, so slices encoded on
    # their own would decode differently (the reference's declaration)
    shardable = False

    @staticmethod
    def make(cfg: Optional[CZ.CompressorConfig] = None,
             **kw) -> "CuszInterpCodec":
        if cfg is None:
            kw.setdefault("predictor", "interp")
            cfg = CZ.CompressorConfig(**kw)
        elif kw:
            cfg = dataclasses.replace(cfg, **kw)
        if cfg.predictor != "interp":
            cfg = dataclasses.replace(cfg, predictor="interp")
        return CuszInterpCodec(cfg=cfg)


register("cusz-i", CuszInterpCodec.make)
