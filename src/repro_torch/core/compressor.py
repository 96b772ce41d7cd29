"""End-to-end compression pipeline: one `Predictor` + one `Encoder` (see
`repro_torch.core.stages`), behind the `CompressedBlob` surface of the
cusz container format.

`CompressorConfig.predictor` / `.encoder` pick the stages by registry id
("lorenzo" + "huffman" is the paper's cuSZ pipeline).  Every hot stage
routes through the `repro_torch.kernels` ops layer, so the same pipeline
runs the CUDA kernels (CUDA tensors) or their plain PyTorch versions
(CPU tensors, or any tensor under the "torch" policy), selected by
`CompressorConfig.kernel_impl` or a `kernels.dispatch.kernel_policy`
context.  The pipeline runs eagerly on the device of its input.

Compressed-size accounting matches the paper's: Huffman bitstream (word
aligned per chunk) + sparse outliers + codebook (bitlengths suffice to
rebuild the canonical book) + the per-subchunk gap arrays + O(1) header.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch

from . import dualquant as dq
from . import stages


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    eb: float = 1e-4                 # absolute error bound (see eb_mode)
    eb_mode: str = "abs"             # "abs" | "valrel" (relative to range)
    nbins: int = 1024                # quantization bins (paper default)
    chunk_size: int = 4096           # encoder chunk (symbols)
    sub_size: int = 128              # gap-array subchunk (symbols); the
    #   parallel decode unit — must divide chunk_size
    block: Optional[Tuple[int, ...]] = None   # Lorenzo block; None =
    #   the paper's default table
    outlier_frac: float = 0.10       # sparse outlier capacity fraction
    use_tpu_blocks: bool = False     # the reference's larger blocks
    kernel_impl: Optional[str] = None  # dispatch default: "auto" | "torch" |
    #   "cuda"; None defers to the ambient policy
    predictor: str = "lorenzo"       # stage registry id (core.stages)
    encoder: str = "huffman"         # stage registry id (core.stages)

    def block_for(self, ndim: int) -> Tuple[int, ...]:
        if self.block is not None:
            return self.block
        table = dq.TPU_BLOCKS if self.use_tpu_blocks else dq.DEFAULT_BLOCKS
        if ndim <= 3:
            return table[ndim]
        # >3D (e.g. QMCPACK 4D): block the trailing 3 dims (the leading
        # dims are a batch of 3D fields)
        return (1,) * (ndim - 3) + table[3]


class CompressedBlob(NamedTuple):
    words: torch.Tensor         # [nc, chunk] uint32 deflated bitstream
    bits_used: torch.Tensor     # [nc] int32
    n_valid: torch.Tensor       # [nc] int32 symbols per chunk
    lengths: torch.Tensor       # [k] int32 codeword bitlengths (rebuilds book)
    out_idx: torch.Tensor       # [cap] int32 outlier flat indices
    out_val: torch.Tensor       # [cap] int32 outlier deltas
    n_outliers: torch.Tensor    # 0-d int32
    max_len: torch.Tensor       # 0-d int32 practical max codeword length
    gap_bits: Optional[torch.Tensor] = None   # [nc, n_sub] int32 bit offset
    #   at every sub_size-symbol boundary
    gap_syms: Optional[torch.Tensor] = None   # [nc, n_sub] int32 valid
    #   symbols before each boundary


def resolve_eb(cfg: CompressorConfig, data: torch.Tensor) -> float:
    """The absolute error bound for `data` (one device readback)."""
    dmin, dmax = torch.aminmax(data.to(torch.float32))
    dmin, dmax = float(dmin), float(dmax)
    amax = max(abs(dmin), abs(dmax))
    if cfg.eb_mode == "abs":
        eb = float(cfg.eb)
    else:
        rng = dmax - dmin
        eb = float(cfg.eb) * (rng if rng > 0 else 1.0)
    # fp32/int32 domain guard: d° = d/(2eb) must stay within the exact
    # integer range of float32, else the bound is unrepresentable
    if amax > 0 and amax / (2 * eb) >= 2 ** 23:
        raise ValueError(
            f"error bound {eb:g} is below float32 resolution for data with "
            f"max |d|={amax:g} (d° would exceed 2^23); choose eb >= "
            f"{amax / 2 ** 24:g}")
    return eb


def compress(data: torch.Tensor, cfg: CompressorConfig
             ) -> Tuple[CompressedBlob, float]:
    """Returns (blob, resolved_abs_eb); the blob lives on data's device."""
    if cfg.encoder != "huffman":
        raise ValueError(
            f"the CompressedBlob surface encodes the huffman payload "
            f"layout; encoder {cfg.encoder!r} is not supported")
    eb = resolve_eb(cfg, data)
    pp = dispatch.pipeline_policy(data.device, cfg.kernel_impl)
    pred = stages.get_predictor(cfg.predictor)
    enc = stages.get_encoder(cfg.encoder)
    codes, ppay = pred.predict(data, cfg, eb, pp)
    payload = {**enc.encode(codes, cfg, pp), **ppay}
    return CompressedBlob(**{f: payload.get(f)
                             for f in CompressedBlob._fields}), eb


def decompress(blob: CompressedBlob, cfg: CompressorConfig, eb: float,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of `compress`; runs on the device of the blob's words."""
    pred = stages.get_predictor(cfg.predictor)
    enc = stages.get_encoder(cfg.encoder)
    payload = {f: v for f, v in zip(CompressedBlob._fields, blob)
               if v is not None}
    static_meta, table = enc.decode_meta(payload, cfg)
    pp = dispatch.pipeline_policy(blob.words.device, cfg.kernel_impl)
    codes = enc.decode(payload, table, static_meta, cfg, pp)
    return pred.reconstruct(codes, payload, cfg, eb, tuple(shape), pp)


# ---------------------------------------------------------------------------
# Size accounting / ratio
# ---------------------------------------------------------------------------

HEADER_BYTES = 64


def compressed_bytes(blob: CompressedBlob, nbins: int) -> int:
    bits = blob.bits_used.cpu().numpy().astype(np.int64)
    stream = int(np.sum((bits + 31) // 32) * 4)
    outliers = int(blob.n_outliers) * 8       # (idx, delta) int32 pairs
    book = nbins                               # 1 B bitlength per symbol
    gaps = 0
    if blob.gap_bits is not None:              # 4 B bit + 2 B symbol offset
        gaps = blob.gap_bits.numel() * 4 + blob.gap_syms.numel() * 2
    return stream + outliers + book + gaps + HEADER_BYTES


def compression_ratio(data: torch.Tensor, blob: CompressedBlob,
                      nbins: int) -> float:
    raw = data.numel() * data.element_size()
    return raw / compressed_bytes(blob, nbins)


def roundtrip(data: torch.Tensor, cfg: CompressorConfig):
    """compress -> decompress; returns (recon, blob, eb, ratio)."""
    blob, eb = compress(data, cfg)
    recon = decompress(blob, cfg, eb, tuple(data.shape))
    return recon, blob, eb, compression_ratio(data, blob, cfg.nbins)


# ---------------------------------------------------------------------------
# Host-side packing for storage: keep only the used words per chunk.  The
# stage pack/unpack implementations carry the logic; output keys, dtypes
# and bytes are the reference's.
# ---------------------------------------------------------------------------

def pack_blob(blob: CompressedBlob) -> dict:
    payload = {f: v.cpu().numpy() for f, v in
               zip(CompressedBlob._fields, blob) if v is not None}
    d = stages.get_encoder("huffman").pack_payload(payload)
    d.update(stages._pack_outliers(payload))
    return d


def unpack_blob(d: dict, device) -> CompressedBlob:
    """Packed arrays -> a blob of tensors on `device`."""
    enc = stages.get_encoder("huffman").unpack_payload(d, None, None)
    payload = {**enc, **stages._unpack_outliers(d)}
    return CompressedBlob(**{
        f: (torch.from_numpy(np.require(payload[f], requirements="CW"))
            .to(device) if payload.get(f) is not None else None)
        for f in CompressedBlob._fields})
