"""Error-bounded KV-cache compression for long-context serving.

PREQUANT applied to the decode-time KV cache: K/V are stored as int8 with
per-(head, seq-block) scales, an explicit error bound of scale/2 per
element, and dequantized on the fly inside attention.  For long contexts
this shrinks the dominant serving memory term 4x (bf16->int8 with fp32
scales amortized over SEQ_BLOCK elements).

The layout, constants and containers are the reference's
(`repro.core.kvcache`): a cache quantized, sliced or put on the wire by
either package is byte-identical.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.codecs.base import slice_axis

SEQ_BLOCK = 128          # scale granularity along the sequence axis
#: scale floor for all-zero blocks: matches `int8.block_quantize`'s
#: clamp, so a zero-extension block assembled by hand (cache init, paged
#: slot adoption) is bit-identical to one produced by quantizing zeros
SCALE_FLOOR = 1e-30
_QMAX = 127.0


class QuantKV(NamedTuple):
    """In-memory quantized-cache format: the `"int8-block"` codec's
    payload as a NamedTuple (the decode-step hot path indexes it
    directly; `kv_quantize`/`kv_dequantize` are the codec's math)."""
    q: torch.Tensor          # int8, same shape as the source
    scale: torch.Tensor      # f32, shape = source with seq axis / SEQ_BLOCK


def kv_quantize(x: torch.Tensor, seq_axis: int, *,
                reciprocal: bool = False) -> QuantKV:
    """Blockwise int8 quantization along `seq_axis` (length must be a
    multiple of SEQ_BLOCK; cache buffers are allocated that way).
    Delegates to the registered `"int8-block"` codec's quantization,
    whose block scale is amax / 127, an IEEE divide, as the reference
    computes it eagerly (the codec, and through it prefill and the
    int8-block wire and pages).  `reciprocal=True` gives the bits of the
    reference's compiled requantize, where XLA multiplies by f32(1/127)
    instead; the decode side's restores (`reshard_caches` and
    `PagedKVPool.restore_page` after a cusz / fz / lossless wire) use it,
    so restored caches are bit-identical to the reference's."""
    from repro_torch.codecs import int8 as I8

    assert x.shape[seq_axis] % SEQ_BLOCK == 0, (tuple(x.shape), seq_axis)
    q, scale = I8.block_quantize(x, seq_axis, SEQ_BLOCK,
                                 reciprocal=reciprocal)
    return QuantKV(q, scale)


def kv_dequantize(qkv: QuantKV, seq_axis: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    from repro_torch.codecs import int8 as I8

    return I8.block_dequantize(qkv.q, qkv.scale, seq_axis, SEQ_BLOCK, dtype)


def kv_update_block_(qkv: QuantKV, new: torch.Tensor,
                     pos: Union[int, torch.Tensor],
                     seq_axis: int) -> QuantKV:
    """Write `new` (one token slot, already sized [..,1,..] on seq_axis)
    into the quantized cache at `pos`, IN PLACE.  The owning SEQ_BLOCK's
    scale is monotonically widened (never shrunk) so previously written
    tokens keep their bound.  Widening is per scale coordinate — the
    scale tensor has one entry per (batch, head, dim) coordinate, so one
    coordinate's large value must not widen (and thus requantize-destroy)
    the others; this also keeps the all-zero s_max-extension blocks at
    the 1e-30 floor until *their own* coordinate sees a value.

    `pos` is an int, or with `seq_axis` 1 a [B] integer tensor: row b
    writes at pos[b] (the continuous scheduler's ragged slots; rows are
    independent because the arithmetic is per coordinate).  The widened
    scale is amax times f32(1/127), as the reference's compiled serve
    step computes it; its eager `kv_update_block` divides, which differs
    in the last bit of about one widened scale in twenty.  Returns
    `qkv`."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        assert seq_axis == 1, seq_axis
        q, scale = qkv.q, qkv.scale
        pos = pos.to(device=q.device, dtype=torch.long)
    else:
        # one row: the seq axis becomes axis 1 of a [1, S, ...] view
        q, scale, new = (t.movedim(seq_axis, 0)[None]
                         for t in (qkv.q, qkv.scale, new))
        pos = torch.full((1,), int(pos), dtype=torch.long, device=q.device)
    B, S = q.shape[:2]
    rows = torch.arange(B, device=q.device)
    blk = pos // SEQ_BLOCK
    old_scale = scale[rows, blk]                            # [B, ...]
    # Python-scalar operands: an f32 op rounds them to f32 (the constants
    # of the compiled reference), with no host-to-device copy
    need = new[:, 0].abs().to(torch.float32) * (1.0 / _QMAX)
    new_scale = torch.maximum(old_scale, need.clamp_min(SCALE_FLOOR))
    # requantize the block's existing tokens under the widened scale so
    # their dequantized values are preserved (bound becomes new_scale/2)
    qb = q.unflatten(1, (S // SEQ_BLOCK, SEQ_BLOCK))
    requant = torch.round(qb[rows, blk].to(torch.float32)
                          * (old_scale / new_scale)[:, None]
                          ).clamp(-_QMAX, _QMAX).to(torch.int8)
    qb[rows, blk] = requant
    q[rows, pos] = torch.round(new[:, 0].to(torch.float32) / new_scale
                               ).clamp(-_QMAX, _QMAX).to(torch.int8)
    scale[rows, blk] = new_scale
    return qkv


def kv_update_block(qkv: QuantKV, new: torch.Tensor,
                    pos: Union[int, torch.Tensor],
                    seq_axis: int) -> QuantKV:
    """`kv_update_block_` on a copy: returns a new QuantKV and leaves
    `qkv` as it was (the reference's functional form)."""
    return kv_update_block_(QuantKV(qkv.q.clone(), qkv.scale.clone()),
                            new, pos, seq_axis)


# ---------------------------------------------------------------------------
# cuSZ offload.  The int8 path above is the in-memory format; the wire and
# disk one is the `"cusz"` codec:
#
#     c = codecs.get("cusz", cfg=cfg).encode(block)   # keeps bf16 dtype
#     block2 = codecs.decode(c)
#
# The entry points below are DEPRECATED shims over that path: they lose
# the source dtype (restore hardcodes the caller's) and need eb/shape fed
# back out-of-band — exactly the bug class the Container header fixes.
# ---------------------------------------------------------------------------

_WARNED = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, DeprecationWarning, stacklevel=3)


def kv_offload_pack(x: torch.Tensor, cfg) -> Tuple[dict, float]:
    """DEPRECATED: use `codecs.get("cusz", cfg=cfg).encode(x)`."""
    _warn_once(
        "kv_offload_pack",
        "kv_offload_pack is deprecated; use "
        "repro_torch.codecs.get('cusz', cfg=cfg).encode(x) — the "
        "returned Container records dtype/shape/eb itself")
    from repro_torch.core import compressor as CZ

    blob, eb = CZ.compress(x.to(torch.float32), cfg)
    return CZ.pack_blob(blob), eb


def kv_offload_restore(packed: dict, eb: float, shape, cfg,
                       dtype=torch.bfloat16,
                       device: Optional[str] = None) -> torch.Tensor:
    """DEPRECATED: use `codecs.decode(container)` (dtype comes from the
    container header, not a caller-side default)."""
    _warn_once(
        "kv_offload_restore",
        "kv_offload_restore is deprecated; use "
        "repro_torch.codecs.decode(container)")
    from repro_torch.codecs.base import input_device
    from repro_torch.core import compressor as CZ

    blob = CZ.unpack_blob(packed, input_device(None, device))
    return CZ.decompress(blob, cfg, eb, tuple(shape)).to(dtype)


def error_bound(qkv: QuantKV) -> torch.Tensor:
    """Per-block abs error bound = scale/2 (the paper's eb semantics)."""
    return qkv.scale / 2.0


# ---------------------------------------------------------------------------
# Prefill -> decode handoff wire format: per-seq-slab registry Containers.
#
# The disaggregated-serving reshard moves each cache tensor as a tuple of
# self-describing Containers sliced along the sequence axis (one slab per
# SEQ_BLOCK group by default).  The wire codec is a registry choice:
#
#   * "int8-block" (default): split-stable blockwise quantization — a
#     QuantKV source is re-sliced in *payload space* (no dequantize) and
#     the decode side adopts the payload directly as its in-memory
#     QuantKV cache, so compressed bytes cross the boundary with zero
#     f32 round trip.
#   * "cusz": the full dual-quant + Huffman pipeline per slab (the
#     host-offload / storage leg; each slab container is independent).
#   * "fz": Lorenzo + fused bitshuffle with zero-plane elision — the
#     throughput-class error-bounded wire (no codebook build on encode,
#     no host prep on decode).
#   * "lossless": raw bytes (the baseline the benchmarks compare against).
# ---------------------------------------------------------------------------

#: default cusz wire configuration for cache slabs: a serving-tolerance
#: value-range-relative bound and full outlier capacity (never overflows)
CUSZ_WIRE_CFG = {"eb": 1e-2, "eb_mode": "valrel", "outlier_frac": 1.0}

#: default fz wire configuration: same serving-tolerance bound; the
#: 512-symbol chunk keeps plane-elision granularity near head-dim slabs
FZ_WIRE_CFG = {"eb": 1e-2, "eb_mode": "valrel", "outlier_frac": 1.0,
               "chunk_size": 512}

#: wires that encode a whole dequantized slab through a registry codec
#: (vs. the payload-space int8-block path)
WHOLE_SLAB_WIRES = ("cusz", "fz", "lossless")


def _wire_codec(wire: str, seq_axis: int, wire_cfg: Optional[dict] = None):
    from repro_torch import codecs

    if wire == "cusz":
        return codecs.get("cusz", **(wire_cfg or CUSZ_WIRE_CFG))
    if wire == "fz":
        return codecs.get("fz", **(wire_cfg or FZ_WIRE_CFG))
    if wire == "lossless":
        return codecs.get("lossless")
    return codecs.get_block_codec(wire, axis=seq_axis, block=SEQ_BLOCK)


def _n_slabs(length: int, nslabs: Optional[int]) -> int:
    if nslabs is None:
        nslabs = max(1, length // SEQ_BLOCK)
    assert length % nslabs == 0, (length, nslabs)
    return nslabs


def _encode_slab(codec, slab, seq_axis: int):
    """Encode one slab through a whole-slab (non-blockwise) codec,
    flattened to [tokens, features] first: the chunked-transform codecs
    pad every dim to Lorenzo-block multiples, and a cache's small
    head/dim axes would blow that padding up 4-8x.  The slab's logical
    shape rides in the header (`kv_shape`) so the decode side restores
    it."""
    feat = 1
    for s in slab.shape[seq_axis + 1:]:
        feat *= int(s)
    flat = slab.reshape(-1, feat) if feat > 1 else slab.reshape(-1)
    c = codec.encode(flat)
    return c.replace(header=c.header.with_params(
        kv_shape=tuple(int(s) for s in slab.shape)))


def kv_wire_encode(x, seq_axis: int, *, wire: str = "int8-block",
                   nslabs: Optional[int] = None,
                   source_dtype=torch.bfloat16,
                   wire_cfg: Optional[dict] = None,
                   pack: bool = True) -> Tuple:
    """Encode one cache tensor (raw tensor or in-memory ``QuantKV``) into
    per-seq-slab Containers.  Returns a tuple of (packed) containers whose
    seq-axis shapes sum to the source length.  With the int8-block wire a
    QuantKV source never leaves payload space, and a raw source encodes
    bit-identically to whole-tensor ``kv_quantize`` (slab boundaries are
    SEQ_BLOCK-aligned, so no scale block straddles a slice)."""
    from repro_torch import codecs

    codec = _wire_codec(wire, seq_axis, wire_cfg)
    if isinstance(x, QuantKV):
        if wire == "int8-block":
            n = _n_slabs(x.q.shape[seq_axis], nslabs)
            step = x.q.shape[seq_axis] // n
            assert step % SEQ_BLOCK == 0, (tuple(x.q.shape), seq_axis, n)
            sstep = step // SEQ_BLOCK
            parts = []
            for i in range(n):
                q = slice_axis(x.q, seq_axis, i * step, (i + 1) * step)
                scale = slice_axis(x.scale, seq_axis, i * sstep,
                                    (i + 1) * sstep)
                header = codecs.make_header(
                    codec.name, codec.version,
                    SimpleNamespace(dtype=source_dtype, shape=q.shape),
                    axis=seq_axis, block=SEQ_BLOCK)
                parts.append(codecs.Container(header,
                                              {"q": q, "scale": scale}))
            return tuple(codec.pack(p) for p in parts) if pack \
                else tuple(parts)
        x = kv_dequantize(x, seq_axis, dtype=source_dtype)

    n = _n_slabs(x.shape[seq_axis], nslabs)
    if wire == "int8-block":
        assert (x.shape[seq_axis] // n) % SEQ_BLOCK == 0, \
            (tuple(x.shape), seq_axis, n)
        parts = codec.encode_parts(x, seq_axis, n)
    else:
        step = x.shape[seq_axis] // n
        parts = []
        for i in range(n):
            slab = slice_axis(x, seq_axis, i * step, (i + 1) * step)
            c = _encode_slab(codec, slab, seq_axis)
            if wire != "lossless" and not codec.valid(c):
                # graceful degradation: a slab the codec cannot represent
                # faithfully (cusz outlier overflow) ships raw instead of
                # aborting the handoff; the decode side reads each part's
                # own header, so mixed slabs restore transparently
                c = _encode_slab(codecs.get("lossless"), slab, seq_axis)
            parts.append(c)

    def _pack(p):
        own = codec if p.header.codec == codec.name \
            else codecs.get(p.header.codec)
        return own.pack(p)

    return tuple(_pack(p) for p in parts) if pack else tuple(parts)


def kv_wire_adopt(parts: Sequence, seq_axis: int,
                  device: Optional[str] = None) -> QuantKV:
    """Adopt int8-block wire containers directly as the in-memory QuantKV
    cache: the quantized payload (q int8 + f32 block scales) is
    concatenated along the seq axis and becomes the cache — no dequantize
    and no re-quantization round trip.  Packed parts land on `device`
    (default CUDA).  Raises for non-int8-block wires (those must go
    through ``kv_wire_restore``)."""
    from repro_torch import codecs

    for p in parts:
        if p.header.codec != "int8-block":
            raise ValueError(
                f"cannot adopt codec {p.header.codec!r} as QuantKV; only "
                f"the int8-block wire payload IS the in-memory format")
    codec = codecs.get("int8-block")
    payloads = [codec._device_payload(p, device) for p in parts]
    q = torch.cat([p["q"] for p in payloads], dim=seq_axis)
    scale = torch.cat([p["scale"] for p in payloads], dim=seq_axis)
    return QuantKV(q, scale)


def kv_slab_shape(part) -> Tuple[int, ...]:
    """Logical (un-flattened) slab shape of a wire container."""
    kv_shape = part.header.param("kv_shape")
    return tuple(kv_shape) if kv_shape is not None else part.header.shape


def kv_wire_restore(parts: Sequence, seq_axis: int, dtype=torch.bfloat16,
                    device: Optional[str] = None) -> torch.Tensor:
    """Decode wire containers back to a dense cache tensor (any codec),
    concatenated along the seq axis.  Packed parts decode on `device`
    (default CUDA)."""
    from repro_torch import codecs

    vals = []
    for p in parts:
        v = codecs.decode(p, device=device).reshape(kv_slab_shape(p))
        vals.append(v.to(dtype))
    return torch.cat(vals, dim=seq_axis)


def kv_wire_nbytes(parts: Sequence) -> int:
    """Bytes the containers occupy on the wire (packed payload bytes)."""
    return sum(p.nbytes for p in parts)


# ---------------------------------------------------------------------------
# Page-granular layer: one *page* = one SEQ_BLOCK-aligned seq slab of a
# cache tensor, kept in the in-memory QuantKV payload form.  A paged serve
# pool slices sequences into pages, parks them in a shared device pool
# and evicts cold ones to host through a wire codec; everything here
# stays in payload space for the int8-block case, so pool pages adopted
# back into a decode slot are bit-identical to the whole-tensor quantize
# path.
# ---------------------------------------------------------------------------

def kv_page_count(length: int) -> int:
    """Pages needed to back `length` written cache positions."""
    return -(-int(length) // SEQ_BLOCK)


def kv_page_slice(qkv: QuantKV, seq_axis: int, idx: int) -> QuantKV:
    """Payload-space slice of page `idx`: q gets SEQ_BLOCK rows, scale
    gets the one matching block row — no dequantize."""
    q = slice_axis(qkv.q, seq_axis, idx * SEQ_BLOCK, (idx + 1) * SEQ_BLOCK)
    scale = slice_axis(qkv.scale, seq_axis, idx, idx + 1)
    return QuantKV(q, scale)


def kv_page_concat(slabs: Sequence[QuantKV], seq_axis: int) -> QuantKV:
    """Payload-space concat of page slabs along the seq axis (inverse of
    `kv_page_slice` over consecutive pages)."""
    q = torch.cat([s.q for s in slabs], dim=seq_axis)
    scale = torch.cat([s.scale for s in slabs], dim=seq_axis)
    return QuantKV(q, scale)


def kv_page_encode(slab: QuantKV, seq_axis: int, *,
                   codec: str = "int8-block",
                   source_dtype=torch.bfloat16,
                   codec_cfg: Optional[dict] = None) -> Tuple:
    """Page-granular wire encode (the pool's eviction leg): one page slab
    becomes a 1-tuple of packed Containers.  "int8-block" never leaves
    payload space (bit-exact restore); the whole-slab wires ("cusz",
    "fz", "lossless") dequantize the slab and re-encode it whole (the
    restore side re-quantizes, stacking the codec's bound on top of the
    page's scale/2)."""
    return kv_wire_encode(slab, seq_axis, wire=codec, nslabs=1,
                          source_dtype=source_dtype, wire_cfg=codec_cfg)


def kv_page_adopt(parts: Sequence, seq_axis: int,
                  device: Optional[str] = None) -> QuantKV:
    """Adopt packed int8-block page containers back as the in-memory
    QuantKV slab — payload-space, bit-exact (`kv_wire_adopt` per page)."""
    return kv_wire_adopt(parts, seq_axis, device=device)
