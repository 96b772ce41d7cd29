"""The cuSZ pipeline (dual-quant + canonical Huffman) behind the `Codec`
protocol.

`encode` resolves the error bound (valrel -> abs) with one device
readback, runs the pipeline on the input's device (kernel dispatch via
`CompressorConfig.kernel_impl` / the ambient `kernels.dispatch` policy),
and records every decode-side parameter in the header: the resolved abs
eb, nbins, chunk and subchunk size, the resolved Lorenzo block, the
outlier capacity fraction and, when it is not "lorenzo", the predictor.
Headers and packed payloads are the reference's, byte for byte.

`pack` switches the payload to the per-chunk word-packed host form
(`compressor.pack_blob`); `decode` accepts either form.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import compressor as CZ
from repro_torch.core import stages
from repro_torch.perf.trace import spanned

from .base import Codec, as_tensor, input_device, register
from .container import Container, stamp_checksum


@dataclasses.dataclass(frozen=True)
class CuszCodec(Codec):
    cfg: CZ.CompressorConfig = CZ.CompressorConfig()
    name = "cusz"
    # v2: payload carries the per-subchunk gap arrays (gap_bits/gap_syms)
    # + sub_size in the header, for the parallel two-phase inflate
    version = 2
    # Lorenzo prediction crosses slice boundaries, so a cusz field cannot
    # be encoded as independent slices (the reference's declaration)
    shardable = False

    @staticmethod
    def make(cfg: Optional[CZ.CompressorConfig] = None, **kw) -> "CuszCodec":
        if cfg is None:
            cfg = CZ.CompressorConfig(**kw)
        elif kw:
            cfg = dataclasses.replace(cfg, **kw)
        return CuszCodec(cfg=cfg)

    # -- protocol -----------------------------------------------------------
    @spanned("codec.encode")
    def encode(self, x, *, cfg: Optional[CZ.CompressorConfig] = None,
               device=None) -> Container:
        c = cfg if cfg is not None else self.cfg
        x32 = as_tensor(x, device).to(torch.float32).contiguous()
        blob, eb = CZ.compress(x32, c)
        # "predictor" is recorded only when it is not the default, so
        # lorenzo headers stay those of every container written before
        # the stages existed
        extra = {} if c.predictor == "lorenzo" else {"predictor": c.predictor}
        header = self._header(
            x, eb=float(eb), nbins=int(c.nbins), chunk_size=int(c.chunk_size),
            sub_size=int(c.sub_size), block=tuple(c.block_for(x32.ndim)),
            outlier_frac=float(c.outlier_frac), **extra)
        return Container(header, _blob_payload(blob))

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        c = self.unpack(c, device)
        h = c.header
        blob = _payload_blob(c.payload)
        if device is not None:
            blob = CZ.CompressedBlob(*(None if v is None else v.to(device)
                                       for v in blob))
        y = CZ.decompress(blob, self._decode_cfg(h), float(h.param("eb")),
                          h.shape)
        return self._finish(y, h, like)

    # -- storage form: per-chunk word packing -------------------------------
    def pack(self, c: Container) -> Container:
        if c.header.param("packed"):
            return c
        blob = _payload_blob(c.payload)
        return stamp_checksum(Container(c.header.with_params(packed=True),
                                        CZ.pack_blob(blob)))

    def unpack(self, c: Container, device=None) -> Container:
        if not c.header.param("packed"):
            return c
        blob = CZ.unpack_blob(dict(c.payload), input_device(None, device))
        return Container(
            c.header.with_params(packed=False).without_params("checksum"),
            _blob_payload(blob))

    def valid(self, c: Container) -> bool:
        """False when the sparse outlier store overflowed its capacity
        (the blob would decode lossily beyond the bound)."""
        if c.header.param("packed"):
            return True                       # pack() is post-validation
        return stages.get_predictor(self.cfg.predictor).valid(c.payload)

    # -- helpers ------------------------------------------------------------
    def _decode_cfg(self, h) -> CZ.CompressorConfig:
        return CZ.CompressorConfig(
            eb=float(h.param("eb")), eb_mode="abs",
            nbins=int(h.param("nbins")),
            chunk_size=int(h.param("chunk_size")),
            sub_size=int(h.param("sub_size", 128)),
            block=tuple(h.param("block")),
            outlier_frac=float(h.param("outlier_frac")),
            predictor=str(h.param("predictor", "lorenzo")),
            kernel_impl=self.cfg.kernel_impl)


def _blob_payload(blob: CZ.CompressedBlob) -> dict:
    """Blob -> payload dict; None fields (gap-less v1 blobs) are omitted."""
    return {f: v for f, v in zip(CZ.CompressedBlob._fields, blob)
            if v is not None}


def _payload_blob(payload) -> CZ.CompressedBlob:
    """Payload dict -> blob; fields absent from the payload stay None."""
    return CZ.CompressedBlob(**{f: payload.get(f)
                                for f in CZ.CompressedBlob._fields})


register("cusz", CuszCodec.make)
