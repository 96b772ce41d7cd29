"""Self-describing versioned container: the one storage format every codec
produces and consumes, byte-compatible with the reference's.

A `Container` is a dict of payload arrays (torch tensors in device form,
numpy arrays in storage form) plus a static `Header` that records
everything needed to decode: codec id, codec version, the source array's
dtype and shape, and the codec's static parameters (error bound, bin
count, block table, ...).  `to_arrays`/`from_arrays` give the
host/storage view (npz-friendly field dict + JSON-able header); a
container written by either package decodes in the other.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

CONTAINER_FORMAT = 1


class ChecksumError(ValueError):
    """A container's payload does not match its header checksum — the
    bytes were corrupted somewhere between `pack` and now."""


def _freeze(v):
    """Make a params value hashable (lists -> tuples, recursively)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _jsonable(v):
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return v


def dtype_name(dtype) -> str:
    """Numpy-style name of a torch or numpy dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def to_numpy(v) -> np.ndarray:
    """Host numpy view of a payload value (tensor, array or scalar)."""
    if isinstance(v, torch.Tensor):
        # repro-lint: allow[host-sync] the host copy behind pack(),
        # to_arrays() and the crc32: the device->storage boundary
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass(frozen=True)
class Header:
    """Static, hashable codec header."""
    codec: str                                   # registry id, e.g. "cusz"
    version: int                                 # codec format version
    dtype: str                                   # source dtype name
    shape: Tuple[int, ...]                       # source shape
    params: Tuple[Tuple[str, Any], ...] = ()     # static codec params

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default

    def with_params(self, **kw) -> "Header":
        """Return a header with `kw` merged into params (replace on key).
        Params stay key-sorted, the canonical order `make_header` and
        `from_json` produce, so header equality never depends on merge
        order."""
        items = [(k, v) for k, v in self.params if k not in kw]
        items += [(k, _freeze(v)) for k, v in kw.items()]
        return dataclasses.replace(self, params=tuple(sorted(items)))

    def without_params(self, *keys: str) -> "Header":
        """Return a header with `keys` removed from params (`unpack` drops
        the storage-only ``checksum``)."""
        return dataclasses.replace(
            self, params=tuple((k, v) for k, v in self.params
                               if k not in keys))

    def to_json(self) -> Dict[str, Any]:
        return {"format": CONTAINER_FORMAT, "codec": self.codec,
                "version": self.version, "dtype": self.dtype,
                "shape": list(self.shape),
                "params": {k: _jsonable(v) for k, v in self.params}}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Header":
        fmt = d.get("format", CONTAINER_FORMAT)
        if fmt > CONTAINER_FORMAT:
            raise ValueError(f"container format {fmt} is newer than this "
                             f"reader ({CONTAINER_FORMAT})")
        params = tuple(sorted((k, _freeze(v))
                              for k, v in dict(d.get("params", {})).items()))
        return Header(codec=str(d["codec"]), version=int(d["version"]),
                      dtype=str(d["dtype"]), shape=tuple(d["shape"]),
                      params=params)


def make_header(codec: str, version: int, like, **params) -> Header:
    """Header for a source array `like` (tensor or array: .dtype/.shape)."""
    items = tuple(sorted((k, _freeze(v)) for k, v in params.items()))
    return Header(codec=codec, version=int(version),
                  dtype=dtype_name(like.dtype),
                  shape=tuple(int(s) for s in like.shape), params=items)


class Container:
    """header (static) + payload (dict of tensors or arrays)."""

    __slots__ = ("header", "payload")

    def __init__(self, header: Header, payload: Dict[str, Any]):
        self.header = header
        self.payload = dict(payload)

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                   else np.asarray(v).nbytes for v in self.payload.values())

    def replace(self, header: Header = None, payload=None) -> "Container":
        return Container(header if header is not None else self.header,
                         payload if payload is not None else self.payload)

    def __repr__(self):
        h = self.header
        return (f"Container(codec={h.codec!r}, v{h.version}, "
                f"dtype={h.dtype}, shape={h.shape}, "
                f"fields={sorted(self.payload)})")


# ---------------------------------------------------------------------------
# Payload integrity (crc32 checksums, stamped by `Codec.pack`)
# ---------------------------------------------------------------------------

def payload_crc32(payload: Mapping[str, Any]) -> int:
    """crc32 over the payload's canonical byte stream: sorted field names
    with each field's dtype, shape and raw bytes, so a corrupted file that
    swaps or reshapes a field also fails verification."""
    crc = 0
    for k in sorted(payload):
        arr = np.ascontiguousarray(to_numpy(payload[k]))
        meta = f"{k}:{arr.dtype.str}:{arr.shape};".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(meta, crc))
    return crc & 0xFFFFFFFF


def stamp_checksum(c: Container) -> Container:
    """Record the payload crc32 in the header (storage-form containers;
    every `pack` implementation ends with this)."""
    return c.replace(header=c.header.with_params(
        checksum=payload_crc32(c.payload)))


def verify_container(c: Container) -> bool:
    """True when the payload matches the header checksum.  Containers
    without a checksum param verify trivially."""
    want = c.header.param("checksum")
    return want is None or payload_crc32(c.payload) == int(want)


def check_container(c: Container) -> None:
    """`verify_container`, but raising `ChecksumError` with the detail."""
    want = c.header.param("checksum")
    if want is None:
        return
    got = payload_crc32(c.payload)
    if got != int(want):
        raise ChecksumError(
            f"container payload checksum mismatch for codec "
            f"{c.header.codec!r} shape {c.header.shape}: header says "
            f"{int(want):#010x}, payload hashes to {got:#010x}")


# ---------------------------------------------------------------------------
# Shard reassembly (payload-space concatenation)
# ---------------------------------------------------------------------------

def concat_containers(parts, axis: int, field_axes: Mapping[str, Any]
                      ) -> Container:
    """Merge axis-sharded containers of one codec into a single container
    without decoding: each payload field is concatenated along the axis
    `field_axes` maps it to (None = shared field, taken from the first
    part).  Headers must agree except for ``shape[axis]``, which the
    merged header sums; per-part checksums are ignored and dropped."""
    h0 = parts[0].header

    def _cmp(h):
        return tuple((k, v) for k, v in h.params if k != "checksum")
    for p in parts[1:]:
        if p.header.codec != h0.codec or _cmp(p.header) != _cmp(h0):
            raise ValueError(f"cannot concat containers with differing "
                             f"codec/params: {p.header} vs {h0}")
    h0 = h0.without_params("checksum")
    shape = list(h0.shape)
    shape[axis] = sum(int(p.header.shape[axis]) for p in parts)
    payload: Dict[str, Any] = {}
    for field, fa in field_axes.items():
        vals = [p.payload[field] for p in parts]
        if fa is None:
            payload[field] = vals[0]
        elif all(isinstance(v, np.ndarray) for v in vals):
            payload[field] = np.concatenate(vals, axis=fa)
        else:
            dev = next(v.device for v in vals if isinstance(v, torch.Tensor))
            payload[field] = torch.cat(
                [torch.as_tensor(v, device=dev) for v in vals], dim=fa)
    return Container(dataclasses.replace(h0, shape=tuple(shape)), payload)


# ---------------------------------------------------------------------------
# Host / storage view
# ---------------------------------------------------------------------------

def to_arrays(c: Container) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(header-json, {field: numpy array}) — the npz/storage form."""
    return c.header.to_json(), {k: to_numpy(v) for k, v in c.payload.items()}


def from_arrays(header, arrays: Mapping[str, Any]) -> Container:
    """Rebuild a container from `to_arrays` output (header json or Header)."""
    h = header if isinstance(header, Header) else Header.from_json(header)
    return Container(h, dict(arrays))
