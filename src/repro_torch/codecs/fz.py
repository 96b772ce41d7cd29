"""FZ ("fz"): Lorenzo prediction + fused bit-plane shuffle with zero-plane
elision (FZ-GPU, arXiv 2304.12557), behind the `Codec` protocol.

Where "cusz" pays for a histogram, a host codebook build and a Huffman
deflate, fz's lossless stage is one fused kernel pass (zigzag map +
per-chunk bitshuffle) plus a nonzero reduction, and its decode needs no
host preparation at all.

The codec composes the staged pipeline's dict surface directly
(`staged_compress` / `staged_decompress` / `StagedPipeline` pack and
unpack), with no blob named tuple.  Headers and packed payloads are the
reference's, byte for byte.

Defaults are the reference's KV-wire operating point: a valrel 1e-2
bound, outlier_frac=1.0 (no capacity overflow on activation-scale data)
and 512-symbol chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import compressor as CZ
from repro_torch.perf.trace import spanned

from .base import Codec, as_tensor, input_device, register
from .container import Container, stamp_checksum


@dataclasses.dataclass(frozen=True)
class FzCodec(Codec):
    cfg: CZ.CompressorConfig = CZ.CompressorConfig(
        eb=1e-2, eb_mode="valrel", chunk_size=512, outlier_frac=1.0,
        encoder="bitshuffle")
    name = "fz"
    version = 1
    # Lorenzo prediction crosses slice boundaries (as for cusz)
    shardable = False

    @staticmethod
    def make(cfg: Optional[CZ.CompressorConfig] = None, **kw) -> "FzCodec":
        if cfg is None:
            kw.setdefault("eb", 1e-2)
            kw.setdefault("eb_mode", "valrel")
            kw.setdefault("chunk_size", 512)
            kw.setdefault("outlier_frac", 1.0)
            kw.setdefault("encoder", "bitshuffle")
            cfg = CZ.CompressorConfig(**kw)
        elif kw:
            cfg = dataclasses.replace(cfg, **kw)
        if cfg.encoder != "bitshuffle":
            cfg = dataclasses.replace(cfg, encoder="bitshuffle")
        return FzCodec(cfg=cfg)

    def _pipe(self, cfg: CZ.CompressorConfig) -> CZ.StagedPipeline:
        return CZ.StagedPipeline.from_cfg(cfg)

    # -- protocol -----------------------------------------------------------
    @spanned("codec.encode")
    def encode(self, x, *, cfg: Optional[CZ.CompressorConfig] = None,
               device=None) -> Container:
        c = cfg if cfg is not None else self.cfg
        x32 = as_tensor(x, device).to(torch.float32).contiguous()
        payload, eb = CZ.staged_compress(x32, c)
        extra = {} if c.predictor == "lorenzo" else {"predictor": c.predictor}
        header = self._header(
            x, eb=float(eb), nbins=int(c.nbins), chunk_size=int(c.chunk_size),
            block=tuple(c.block_for(x32.ndim)),
            outlier_frac=float(c.outlier_frac), **extra)
        return Container(header, payload)

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        c = self.unpack(c, device)
        h = c.header
        payload = dict(c.payload)
        if device is not None:
            payload = {k: v.to(device) for k, v in payload.items()}
        y = CZ.staged_decompress(payload, self._decode_cfg(h),
                                 float(h.param("eb")), h.shape)
        return self._finish(y, h, like)

    # -- storage form: zero-plane elision happens here ----------------------
    def pack(self, c: Container) -> Container:
        if c.header.param("packed"):
            return c
        packed = self._pipe(self._decode_cfg(c.header)).pack(dict(c.payload))
        return stamp_checksum(Container(c.header.with_params(packed=True),
                                        packed))

    def unpack(self, c: Container, device=None) -> Container:
        if not c.header.param("packed"):
            return c
        h = c.header
        cfg = self._decode_cfg(h)
        payload = self._pipe(cfg).unpack(dict(c.payload), cfg, h.shape,
                                         input_device(None, device))
        return Container(
            h.with_params(packed=False).without_params("checksum"), payload)

    def valid(self, c: Container) -> bool:
        """False when the sparse outlier store overflowed its capacity."""
        if c.header.param("packed"):
            return True                       # pack() is post-validation
        return self._pipe(self._decode_cfg(c.header)).valid(dict(c.payload))

    # -- helpers ------------------------------------------------------------
    def _decode_cfg(self, h) -> CZ.CompressorConfig:
        return CZ.CompressorConfig(
            eb=float(h.param("eb")), eb_mode="abs",
            nbins=int(h.param("nbins")),
            chunk_size=int(h.param("chunk_size")),
            block=tuple(h.param("block")),
            outlier_frac=float(h.param("outlier_frac")),
            predictor=str(h.param("predictor", "lorenzo")),
            encoder="bitshuffle",
            kernel_impl=self.cfg.kernel_impl)


register("fz", FzCodec.make)
