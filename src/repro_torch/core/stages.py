"""Staged compression pipeline: `Predictor` and `Encoder` stage protocols
with string-keyed registries mirroring `repro_torch.codecs.base`.

The cuSZ pipeline decomposes into two orthogonal stages:

  Predictor  lossy-maps a float field to integer quant codes (plus a
             sparse exact side channel for out-of-cap residuals) and
             reconstructs the field from them within the error bound.
  Encoder    losslessly encodes the quant-code stream to a compact
             payload and decodes it back bit-exactly.

`core.compressor.StagedPipeline` composes one of each; the
`CompressorConfig.predictor` / `.encoder` ids select them.  Registered
stages:

  predictors  "lorenzo"    blocked first-difference (paper §3.1)
              "interp"     multi-level cubic interpolation (cuSZ-i) —
                           `core.interp`
  encoders    "huffman"    canonical Huffman + gap-array deflate (§3.2)
              "bitshuffle" bit-plane shuffle + zero-plane elision
                           (FZ-GPU) — `core.bitplane`

Stage methods that run on the device (`predict`, `reconstruct`,
`encode`, `decode`) receive the resolved `dispatch.PipelinePolicy` and
route every hot kernel through `repro_torch.kernels.*.ops`.  Host-side
methods (`decode_meta`, `pack_payload`, `unpack_payload`,
`stored_nbytes`, `valid`) handle the readbacks and the storage form,
which is numpy and byte-identical to the reference's.

Payloads are flat dicts of tensors; a predictor's and an encoder's key
sets are disjoint, so the composed payload is their union.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.deflate import ops as deflate_ops
from repro_torch.kernels.encode import ops as encode_ops
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.inflate import ops as inflate_ops
from repro_torch.kernels.lorenzo import ops as lorenzo_ops

from . import dualquant as dq
from . import huffman as hf

Payload = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Stage protocols
# ---------------------------------------------------------------------------

class Predictor:
    """Lossy prediction stage: float field <-> integer quant codes.
    Implementations are stateless singletons; every per-field knob rides
    in `CompressorConfig`."""
    name: str = "abstract"
    #: dispatch kernel names this stage routes through
    kernels: Tuple[str, ...] = ()
    #: payload keys this stage owns (disjoint from any encoder's)
    payload_keys: Tuple[str, ...] = ()

    def n_codes(self, shape: Tuple[int, ...], cfg) -> int:
        """Quant-code count for a field of `shape`: `predict` emits
        exactly this many symbols, `reconstruct` reads
        `codes_flat[:n_codes]`."""
        raise NotImplementedError

    def predict(self, data: torch.Tensor, cfg, eb: float,
                pp: dispatch.PipelinePolicy) -> Tuple[torch.Tensor, Payload]:
        """data -> (quant codes, predictor payload).  Code 0 is the
        OUTLIER sentinel; in-cap codes are >= 1."""
        raise NotImplementedError

    def reconstruct(self, codes_flat: torch.Tensor, payload: Payload, cfg,
                    eb: float, shape: Tuple[int, ...],
                    pp: dispatch.PipelinePolicy) -> torch.Tensor:
        """(decoded flat codes, padded past the field's symbol count,
        payload) -> float32 field."""
        raise NotImplementedError

    def valid(self, payload: Payload) -> bool:
        """Host-side post-encode validity check (e.g. outlier overflow)."""
        return True

    def pack_payload(self, payload: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """Host payload -> compact storage arrays."""
        return dict(payload)

    def unpack_payload(self, packed: Dict[str, np.ndarray], cfg,
                       shape: Tuple[int, ...]) -> Dict[str, np.ndarray]:
        """Inverse of `pack_payload` (dense, decode-ready arrays)."""
        return dict(packed)

    def stored_nbytes(self, packed: Dict[str, np.ndarray]) -> int:
        """Accounted storage bytes of this stage's packed payload."""
        raise NotImplementedError


class Encoder:
    """Lossless quant-code encoding stage (same singleton contract)."""
    name: str = "abstract"
    kernels: Tuple[str, ...] = ()
    payload_keys: Tuple[str, ...] = ()

    def encode(self, codes: torch.Tensor, cfg,
               pp: dispatch.PipelinePolicy) -> Payload:
        """Quant codes (any shape, row-major symbol order) -> payload."""
        raise NotImplementedError

    def decode_meta(self, payload: Payload, cfg
                    ) -> Tuple[Tuple[Any, ...], Any]:
        """Host-side decode preparation: (static_meta, aux), e.g. the
        bucketed max codeword length and the cached decode table."""
        return ((), None)

    def decode(self, payload: Payload, aux: Any,
               static_meta: Tuple[Any, ...], cfg,
               pp: dispatch.PipelinePolicy) -> torch.Tensor:
        """payload -> flat int32 codes (padded to the encoder's chunk
        granularity; callers slice to the field's symbol count)."""
        raise NotImplementedError

    def pack_payload(self, payload: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        return dict(payload)

    def unpack_payload(self, packed: Dict[str, np.ndarray], cfg,
                       n_sym: int) -> Dict[str, np.ndarray]:
        return dict(packed)

    def stored_nbytes(self, packed: Dict[str, np.ndarray]) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Registries (string id -> singleton)
# ---------------------------------------------------------------------------

_PREDICTORS: Dict[str, Predictor] = {}
_ENCODERS: Dict[str, Encoder] = {}


def register_predictor(name: str, factory: Callable[[], Predictor]) -> None:
    _PREDICTORS[name] = factory()


def register_encoder(name: str, factory: Callable[[], Encoder]) -> None:
    _ENCODERS[name] = factory()


def get_predictor(name: str) -> Predictor:
    try:
        return _PREDICTORS[name]
    except KeyError:
        raise KeyError(f"unknown predictor {name!r}; registered: "
                       f"{sorted(_PREDICTORS)}") from None


def get_encoder(name: str) -> Encoder:
    try:
        return _ENCODERS[name]
    except KeyError:
        raise KeyError(f"unknown encoder {name!r}; registered: "
                       f"{sorted(_ENCODERS)}") from None


def predictor_names() -> Tuple[str, ...]:
    return tuple(sorted(_PREDICTORS))


def encoder_names() -> Tuple[str, ...]:
    return tuple(sorted(_ENCODERS))


# ---------------------------------------------------------------------------
# Shared shape metadata and the outlier side channel
# ---------------------------------------------------------------------------

def shape_meta(shape: Tuple[int, ...], cfg):
    ndim = len(shape)
    block = cfg.block_for(ndim)
    pshape = dq.padded_shape(shape, block)
    n = int(np.prod(pshape))
    return ndim, block, pshape, n, outlier_capacity(n, cfg)


def outlier_capacity(n: int, cfg) -> int:
    """Sparse outlier store size for n quant values."""
    return max(16, int(n * cfg.outlier_frac))


def _outlier_valid(payload) -> bool:
    # repro-lint: allow[host-sync] one scalar readback per validity check
    return int(payload["n_outliers"]) <= int(payload["out_idx"].shape[0])


def _pack_outliers(payload: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Trim the fixed-capacity outlier store to its used prefix."""
    n_out = int(payload["n_outliers"])
    return {
        "out_idx": np.asarray(payload["out_idx"][:n_out], np.int32),
        "out_val": np.asarray(payload["out_val"][:n_out], np.int32),
        "out_capacity": np.int32(payload["out_idx"].shape[0]),
    }


def _unpack_outliers(packed: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    cap = int(packed["out_capacity"])
    n_out = len(packed["out_idx"])
    # out-of-range fill: the decode-side scatter drops it
    oi = np.full((cap,), 2 ** 31 - 1, np.int32)
    ov = np.zeros((cap,), np.int32)
    oi[:n_out] = packed["out_idx"]
    ov[:n_out] = packed["out_val"]
    return {"out_idx": oi, "out_val": ov,
            "n_outliers": np.int32(n_out)}


# ---------------------------------------------------------------------------
# "lorenzo": the paper's blocked first-difference predictor
# ---------------------------------------------------------------------------

class LorenzoPredictor(Predictor):
    name = "lorenzo"
    kernels = ("lorenzo.dualquant", "lorenzo.reverse")
    payload_keys = ("out_idx", "out_val", "n_outliers")

    def n_codes(self, shape, cfg) -> int:
        return shape_meta(tuple(shape), cfg)[3]

    def predict(self, data, cfg, eb, pp):
        ndim, block, pshape, n, cap = shape_meta(tuple(data.shape), cfg)
        # fused edge pad + block split + PREQUANT + ℓ-delta + POSTQUANT:
        # one kernel call that reads the field in place
        codes, delta = lorenzo_ops.dualquant_field(
            data, block, eb, cfg.nbins,
            impl=pp.for_kernel("lorenzo.dualquant"))
        # code 0 <=> outlier (in-cap codes are >= 1)
        oidx, oval, n_out = dq.extract_outliers(
            delta.reshape(-1), (codes != 0).reshape(-1), cap)
        return codes, {"out_idx": oidx, "out_val": oval, "n_outliers": n_out}

    def reconstruct(self, codes_flat, payload, cfg, eb, shape, pp):
        ndim, block, pshape, n, cap = shape_meta(shape, cfg)
        delta = dq.codes_to_delta(codes_flat[:n], cfg.nbins)
        delta = dq.scatter_outliers(delta, payload["out_idx"],
                                    payload["out_val"])
        nb = tuple(p // b for p, b in zip(pshape, block))
        delta = delta.reshape(nb + tuple(block))
        recon = lorenzo_ops.reverse_blocks(
            delta, eb, impl=pp.for_kernel("lorenzo.reverse"))
        full = dq.block_merge(recon, block)
        return full[tuple(slice(0, s) for s in shape)]

    def valid(self, payload):
        return _outlier_valid(payload)

    def pack_payload(self, payload):
        return _pack_outliers(payload)

    def unpack_payload(self, packed, cfg, shape):
        return _unpack_outliers(packed)

    def stored_nbytes(self, packed):
        # (idx, delta) int32 pairs of the used prefix, as in the paper's
        # sparse outlier accounting
        return len(packed["out_idx"]) * 8


# ---------------------------------------------------------------------------
# "huffman": canonical Huffman + gap-array deflate (payload keys match the
# CompressedBlob field names, so the cusz v2 container format is the
# reference's)
# ---------------------------------------------------------------------------

class HuffmanEncoder(Encoder):
    name = "huffman"
    kernels = ("histogram", "huffman.tree", "huffman.codebook",
               "huffman.decode_table", "encode", "deflate", "inflate")
    payload_keys = ("words", "bits_used", "n_valid", "lengths", "max_len",
                    "gap_bits", "gap_syms")

    def encode(self, codes, cfg, pp):
        hist = hist_ops.histogram(codes, cfg.nbins,
                                  impl=pp.for_kernel("histogram"))
        # the codebook is built on the codes' device: no read of the card
        # between the histogram and the deflate
        lengths = hf.codeword_lengths(hist, impl=pp.for_kernel("huffman.tree"))
        cb = hf.canonical_codebook(lengths,
                                   impl=pp.for_kernel("huffman.codebook"))
        cw, bw = encode_ops.encode(codes, cb,
                                   impl=pp.for_kernel("encode"))
        words, bits, gap_bits, gap_syms = deflate_ops.deflate(
            cw, bw, cfg.chunk_size, cfg.sub_size,
            impl=pp.for_kernel("deflate"))
        nc = words.shape[0]
        n_sym = codes.numel()
        starts = torch.arange(nc, dtype=torch.int64,
                              device=codes.device) * cfg.chunk_size
        n_valid = (n_sym - starts).clamp(0, cfg.chunk_size).to(torch.int32)
        return {"words": words, "bits_used": bits, "n_valid": n_valid,
                "lengths": cb.lengths, "max_len": cb.max_len,
                "gap_bits": gap_bits, "gap_syms": gap_syms}

    def decode_meta(self, payload, cfg):
        # repro-lint: allow[host-sync] max_len picks the LUT-vs-bitscan
        # decode variant; one readback per decode
        max_len = int(payload["max_len"])
        # the bucketed max length picks the sequential decoder of a
        # gap-less stream (table walk or bit scan); the gap decoder serves
        # every bucket
        ml_b = hf.bucket_max_len(max(1, max_len))
        # the decode side resolves its policy before the pipeline's
        table = hf.decode_table(payload["lengths"],
                                impl=dispatch.current_policy()
                                or cfg.kernel_impl)
        return (ml_b,), table

    def decode(self, payload, aux, static_meta, cfg, pp):
        (ml_b,) = static_meta
        gaps = payload.get("gap_bits")
        # a gap-less stream takes the sequential decoder, which has no
        # kernel: only an explicit request for the kernel raises there
        impl = pp.for_kernel("inflate") if gaps is not None \
            else dispatch.current_policy() or cfg.kernel_impl
        return inflate_ops.inflate(
            payload["words"], payload["n_valid"], aux, gaps=gaps, impl=impl,
            bits_used=payload["bits_used"], max_len_static=ml_b).reshape(-1)

    def pack_payload(self, payload):
        bits = np.asarray(payload["bits_used"], dtype=np.int64)
        words = np.asarray(payload["words"])
        chunk_ids, cols = _packed_coords(bits)
        d = {
            "words_packed": words[chunk_ids, cols].astype(np.uint32),
            "bits_used": np.asarray(payload["bits_used"], np.int32),
            "n_valid": np.asarray(payload["n_valid"], np.int32),
            "lengths": np.asarray(payload["lengths"], np.uint8),
            "max_len": np.asarray(payload["max_len"], np.int32),
            "chunk_words": np.int32(words.shape[1]),
        }
        if payload.get("gap_bits") is not None:
            d["gap_bits"] = np.asarray(payload["gap_bits"], np.int32)
            # symbol offsets are < chunk_size; u16 when that fits
            sdt = np.uint16 if words.shape[1] <= (1 << 16) else np.int32
            d["gap_syms"] = np.asarray(payload["gap_syms"]).astype(sdt)
        return d

    def unpack_payload(self, packed, cfg, n_sym):
        bits = np.asarray(packed["bits_used"], np.int64)
        nc = bits.shape[0]
        cw = int(packed["chunk_words"])
        words = np.zeros((nc, cw), np.uint32)
        chunk_ids, cols = _packed_coords(bits)
        words[chunk_ids, cols] = np.asarray(packed["words_packed"],
                                            np.uint32)
        d = {"words": words,
             "bits_used": np.asarray(packed["bits_used"], np.int32),
             "n_valid": np.asarray(packed["n_valid"], np.int32),
             "lengths": np.asarray(packed["lengths"], np.int32),
             "max_len": np.asarray(packed["max_len"], np.int32)}
        if packed.get("gap_bits") is not None:
            d["gap_bits"] = np.asarray(packed["gap_bits"], np.int32)
            d["gap_syms"] = np.asarray(packed["gap_syms"], np.int32)
        return d

    def stored_nbytes(self, packed):
        bits = np.asarray(packed["bits_used"], dtype=np.int64)
        stream = int(np.sum((bits + 31) // 32) * 4)
        book = len(packed["lengths"])          # 1 B bitlength per symbol
        gaps = 0
        if packed.get("gap_bits") is not None:
            gaps = (np.asarray(packed["gap_bits"]).size * 4
                    + np.asarray(packed["gap_syms"]).size * 2)
        return stream + book + gaps


def _packed_coords(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(chunk_id, in-chunk column) of every used word, packed order."""
    nwords = (bits + 31) // 32                       # [nc]
    chunk_ids = np.repeat(np.arange(bits.shape[0]), nwords)
    starts = np.cumsum(nwords) - nwords              # packed offset per chunk
    cols = np.arange(int(nwords.sum())) - np.repeat(starts, nwords)
    return chunk_ids, cols


register_predictor("lorenzo", LorenzoPredictor)
register_encoder("huffman", HuffmanEncoder)

# the sibling stage modules register on import; they import this module
# for the protocol, so their imports come last
from . import bitplane as _bitplane  # noqa: E402,F401  ("bitshuffle")
from . import interp as _interp      # noqa: E402,F401  ("interp")
