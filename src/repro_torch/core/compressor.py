"""End-to-end compression pipeline: one `Predictor` + one `Encoder` (see
`repro_torch.core.stages`).

`CompressorConfig.predictor` / `.encoder` pick the stages by registry id
("lorenzo" + "huffman" is the paper's cuSZ pipeline; "interp" and
"bitshuffle" compose into cusz-i and fz).  Every hot stage routes through
the `repro_torch.kernels` ops layer, so the same pipeline runs the CUDA
kernels (CUDA tensors) or their plain PyTorch versions (CPU tensors, or
any tensor under the "torch" policy), selected by
`CompressorConfig.kernel_impl` or a `kernels.dispatch.kernel_policy`
context.  The pipeline runs eagerly on the device of its input.

Two surfaces over the same stages:

* the dict surface (`StagedPipeline`, `staged_compress` /
  `staged_decompress`): payloads are flat dicts of tensors, the union of
  the predictor's and the encoder's disjoint keys, packed and unpacked
  per stage.  Any predictor x encoder composition works here (fz);
* the `CompressedBlob` surface (`compress` / `decompress`, `pack_blob` /
  `unpack_blob`): the named tuple of the lorenzo/interp + huffman payload
  keys, which is the cusz (and cusz-i) container format.

Compressed-size accounting matches the paper's: Huffman bitstream (word
aligned per chunk) + sparse outliers + codebook (bitlengths suffice to
rebuild the canonical book) + the per-subchunk gap arrays + O(1) header
(+ the interp predictor's anchor grid, when present).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.perf.trace import span

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
    anchor: Optional[torch.Tensor] = None     # [n_anchor] int32 interp
    #   anchor grid (None for the lorenzo predictor)


def resolve_eb(cfg: CompressorConfig, data: torch.Tensor) -> float:
    """The absolute error bound for `data` (one device readback)."""
    dmin, dmax = torch.aminmax(data.to(torch.float32))
    # repro-lint: allow[host-sync] one fused min/max reduction; the eb
    # must be a host float before compression starts
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


# ---------------------------------------------------------------------------
# Generic staged pipeline (dict payloads, any predictor x encoder)
# ---------------------------------------------------------------------------

def staged_compress(data: torch.Tensor, cfg: CompressorConfig
                    ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Returns (payload dict on data's device, resolved abs eb)."""
    with span("stage.resolve_eb"):
        eb = resolve_eb(cfg, data)
    with span("stage.predict"):
        pp = dispatch.pipeline_policy(data.device, cfg.kernel_impl)
        pred = stages.get_predictor(cfg.predictor)
        enc = stages.get_encoder(cfg.encoder)
        codes, ppay = pred.predict(data, cfg, eb, pp)
    with span("stage.encode"):
        epay = enc.encode(codes, cfg, pp)
    return {**epay, **ppay}, eb


def staged_decompress(payload: Dict[str, torch.Tensor],
                      cfg: CompressorConfig, eb: float,
                      shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of `staged_compress`, on the device of the payload."""
    pred = stages.get_predictor(cfg.predictor)
    enc = stages.get_encoder(cfg.encoder)
    device = next(iter(payload.values())).device
    with span("stage.decode_meta"):
        static_meta, aux = enc.decode_meta(payload, cfg)
    with span("stage.decode"):
        pp = dispatch.pipeline_policy(device, cfg.kernel_impl)
        codes = enc.decode(payload, aux, static_meta, cfg, pp)
    with span("stage.reconstruct"):
        return pred.reconstruct(codes, payload, cfg, eb, tuple(shape), pp)


@dataclasses.dataclass(frozen=True)
class StagedPipeline:
    """A predictor + encoder composition with the host-side storage and
    validity surface that codecs build on (`codecs.fz`)."""
    predictor: stages.Predictor
    encoder: stages.Encoder

    @staticmethod
    def from_cfg(cfg: CompressorConfig) -> "StagedPipeline":
        return StagedPipeline(stages.get_predictor(cfg.predictor),
                              stages.get_encoder(cfg.encoder))

    def compress(self, data: torch.Tensor, cfg: CompressorConfig):
        return staged_compress(data, cfg)

    def decompress(self, payload: dict, cfg: CompressorConfig, eb: float,
                   shape: Tuple[int, ...]) -> torch.Tensor:
        return staged_decompress(payload, cfg, eb, shape)

    def valid(self, payload: dict) -> bool:
        return self.predictor.valid(payload)

    # -- storage boundary (host) -------------------------------------------
    def pack(self, payload: dict) -> Dict[str, np.ndarray]:
        # repro-lint: allow[host-sync] pack() is the storage boundary
        host = {k: v.cpu().numpy() for k, v in payload.items()}
        pkeys = set(self.predictor.payload_keys)
        ppart = {k: v for k, v in host.items() if k in pkeys}
        epart = {k: v for k, v in host.items() if k not in pkeys}
        return {**self.encoder.pack_payload(epart),
                **self.predictor.pack_payload(ppart)}

    def unpack(self, packed: dict, cfg: CompressorConfig,
               shape: Tuple[int, ...], device) -> Dict[str, torch.Tensor]:
        """Packed arrays -> a payload of tensors on `device`."""
        n_sym = self.predictor.n_codes(tuple(shape), cfg)
        d = dict(self.encoder.unpack_payload(packed, cfg, n_sym))
        d.update(self.predictor.unpack_payload(packed, cfg, tuple(shape)))
        return {k: to_tensor(v, device) for k, v in d.items()}

    def stored_nbytes(self, packed: dict) -> int:
        return (self.encoder.stored_nbytes(packed)
                + self.predictor.stored_nbytes(packed) + HEADER_BYTES)


def to_tensor(a, device) -> torch.Tensor:
    """A host array (packed payload value) as a tensor on `device`."""
    # repro-lint: allow[host-sync] unpack() is the storage->device
    # boundary: one pageable copy per field
    return torch.from_numpy(np.require(a, requirements="CW")).to(device)


# ---------------------------------------------------------------------------
# CompressedBlob surface (the cusz container format)
# ---------------------------------------------------------------------------

def compress(data: torch.Tensor, cfg: CompressorConfig
             ) -> Tuple[CompressedBlob, float]:
    """Returns (blob, resolved_abs_eb); the blob lives on data's device."""
    if cfg.encoder != "huffman":
        raise ValueError(
            f"the CompressedBlob surface encodes the huffman payload "
            f"layout; encoder {cfg.encoder!r} needs staged_compress()")
    payload, eb = staged_compress(data, cfg)
    return CompressedBlob(**{f: payload.get(f)
                             for f in CompressedBlob._fields}), eb


def decompress(blob: CompressedBlob, cfg: CompressorConfig, eb: float,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of `compress`; runs on the device of the blob's words."""
    return staged_decompress({f: v for f, v in zip(CompressedBlob._fields,
                                                   blob) if v is not None},
                             cfg, eb, shape)


# ---------------------------------------------------------------------------
# Size accounting / ratio
# ---------------------------------------------------------------------------

HEADER_BYTES = 64


def compressed_bytes(blob: CompressedBlob, nbins: int) -> int:
    # repro-lint: allow[host-sync] ratio reporting is a host-side metric
    bits = blob.bits_used.cpu().numpy().astype(np.int64)
    stream = int(np.sum((bits + 31) // 32) * 4)
    outliers = int(blob.n_outliers) * 8  # repro-lint: allow[host-sync] ratio reporting; (idx, delta) int32 pairs
    book = nbins                               # 1 B bitlength per symbol
    gaps = 0
    if blob.gap_bits is not None:              # 4 B bit + 2 B symbol offset
        gaps = blob.gap_bits.numel() * 4 + blob.gap_syms.numel() * 2
    anchor = 0 if blob.anchor is None else blob.anchor.numel() * 4
    return stream + outliers + book + gaps + anchor + HEADER_BYTES


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
    # repro-lint: allow[host-sync] pack_blob() is the storage boundary
    payload = {f: v.cpu().numpy() for f, v in
               zip(CompressedBlob._fields, blob) if v is not None}
    d = stages.get_encoder("huffman").pack_payload(payload)
    d.update(stages._pack_outliers(payload))
    if payload.get("anchor") is not None:
        d["anchor"] = np.asarray(payload["anchor"], np.int32)
    return d


def packed_nbytes(d: dict) -> int:
    """Bytes of a packed blob's arrays (`pack_blob`'s dict)."""
    return sum(np.asarray(v).nbytes for v in d.values())


def unpack_blob(d: dict, device) -> CompressedBlob:
    """Packed arrays -> a blob of tensors on `device`."""
    enc = stages.get_encoder("huffman").unpack_payload(d, None, None)
    payload = {**enc, **stages._unpack_outliers(d)}
    if d.get("anchor") is not None:
        payload["anchor"] = np.asarray(d["anchor"], np.int32)
    return CompressedBlob(**{
        f: (to_tensor(payload[f], device)
            if payload.get(f) is not None else None)
        for f in CompressedBlob._fields})
