"""The `Codec` protocol and the string-keyed codec registry.

Every compression surface implements one contract:

    encode(x, *, cfg=None, device=None)   -> Container  (device form)
    decode(container, *, like, device)    -> torch.Tensor
    pack(container)                       -> Container  (numpy storage form)
    unpack(container, device=None)        -> Container  (back to tensors)

`decode` needs nothing but the container: dtype, shape and every codec
parameter ride in the header.  `like` optionally overrides the output
dtype/shape.  `decode` transparently unpacks packed input.

Devices: an encode input that is a tensor stays on its device; a numpy
input goes to `device`, which defaults to "cuda".  A packed (numpy)
container decodes on `device`, default "cuda"; a device-form container
decodes where its tensors are.  Without CUDA the default raises: the CPU
runs only when the caller asks for it (``device="cpu"``), never as a
silent fallback.

Registry: `get("cusz")`, `get("int8")`, `get("int8-block", axis=2)`, ...
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.compressor import to_tensor
from repro_torch.perf.trace import spanned

from .container import (Container, Header, check_container, make_header,
                        stamp_checksum, to_numpy)


def input_device(x, device=None) -> torch.device:
    """Where an entry point runs for input `x`: `device` if given, else the
    tensor's own device, else CUDA (numpy input, packed containers).
    Raises when CUDA is absent and no device was given."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: numpy input and packed containers run on CUDA "
            "by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, device=None) -> torch.Tensor:
    """`x` (tensor or array) as a tensor on `input_device(x, device)`."""
    dev = input_device(x, device)
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dev)


def torch_dtype(name: str) -> torch.dtype:
    """Header dtype name ("float32", "bfloat16") -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


class Codec:
    """Base class: subclasses set `name`/`version`, implement encode/decode.
    Instances are cheap, immutable and hashable (frozen dataclasses)."""

    name: str = "?"
    version: int = 1
    #: Sharded-encode capability: a codec either overrides `shard_axis` +
    #: `payload_axes` (split-stable along some axis) or sets
    #: ``shardable = False`` — the checkpoint planner then keeps each leaf
    #: whole on one owner shard.
    shardable: bool = True

    # -- required -----------------------------------------------------------
    def encode(self, x, *, cfg=None, device=None) -> Container:
        raise NotImplementedError

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        raise NotImplementedError

    # -- storage form (override when a denser packing exists) ---------------
    def pack(self, c: Container) -> Container:
        """Host/storage form: numpy payload, `packed=True` plus a payload
        crc32 (``checksum``) in the header."""
        if c.header.param("packed"):
            return c
        payload = {k: to_numpy(v) for k, v in c.payload.items()}
        return stamp_checksum(
            Container(c.header.with_params(packed=True), payload))

    def unpack(self, c: Container, device=None) -> Container:
        """Inverse of `pack`: tensors on `device` (default CUDA), with the
        storage-only params dropped (``checksum`` must not leak into
        device headers)."""
        if not c.header.param("packed"):
            return c
        dev = input_device(None, device)
        payload = {k: to_tensor(v, dev) for k, v in c.payload.items()}
        return Container(
            c.header.with_params(packed=False).without_params("checksum"),
            payload)

    # -- shared helpers -----------------------------------------------------
    def _device_payload(self, c: Container, device=None) -> dict:
        """The payload as tensors: unpacked onto `device` when packed, else
        moved there when `device` is given."""
        c = self.unpack(c, device)
        if device is None:
            return dict(c.payload)
        return {k: v.to(device) for k, v in c.payload.items()}

    def _header(self, x, **params) -> Header:
        return make_header(self.name, self.version, x, **params)

    def _finish(self, y: torch.Tensor, header: Header, like) -> torch.Tensor:
        """Cast/reshape decode output per the header (or `like` override)."""
        if like is not None:
            dt = like.dtype if isinstance(like.dtype, torch.dtype) \
                else torch_dtype(np.dtype(like.dtype).name)
            return y.reshape(tuple(like.shape)).to(dt)
        return y.reshape(header.shape).to(torch_dtype(header.dtype))

    def stored_nbytes(self, c: Container) -> int:
        """Bytes this container occupies in storage form."""
        return self.pack(c).nbytes

    def valid(self, c: Container) -> bool:
        """Whether this (device-form) container decodes faithfully."""
        return True

    # -- sharded encode (the per-host checkpoint write path) ----------------
    #
    # A codec is *split-stable* along an axis when encoding each slice
    # independently decodes to exactly what encoding the whole tensor
    # would, so a sharded save is bit-identical to a single-file save.
    # Elementwise codecs (lossless, int8 with a pinned global scale,
    # int8-block with block-aligned splits) qualify; chunked-transform
    # codecs (cusz, zfp) do not and return None, which makes the
    # checkpoint planner keep the whole leaf on one owner shard.

    def shard_axis(self, shape, nshards: int):
        """Axis to split a `shape` tensor over `nshards` hosts, or None
        when this codec cannot split it without changing the decode."""
        return None

    def encode_parts(self, x, axis: int, nshards: int):
        """Encode `x` as `nshards` independent slice containers along
        `axis`, bit-equivalent to `encode(x)` on decode; codecs with
        cross-slice state (per-tensor scales) override to pin it."""
        step = x.shape[axis] // nshards
        return [self.encode(slice_axis(x, axis, h * step, (h + 1) * step))
                for h in range(nshards)]

    def payload_axes(self, axis: int):
        """Per-field concat axis for merging slice containers along source
        `axis` in payload space (`container.concat_containers`), or None
        when unsupported: the loader then decodes each part and
        concatenates values."""
        return None


def slice_axis(x, axis: int, start: int, stop: int):
    """`x[start:stop]` along `axis` (tensor or array)."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[..., Codec]] = {}
_DEFAULTS: Dict[str, Codec] = {}      # cache for kwarg-less lookups


def register(name: str, factory: Callable[..., Codec]) -> None:
    """Register a codec factory under a string key.  `factory(**kwargs)`
    must return a configured `Codec` instance."""
    _FACTORIES[name] = factory
    _DEFAULTS.pop(name, None)


def get(name: str, **kwargs) -> Codec:
    """Look up a configured codec: `get("cusz", eb=1e-4, eb_mode="valrel")`.
    Without kwargs the default-configured instance is cached and shared."""
    if name not in _FACTORIES:
        raise KeyError(f"unknown codec {name!r}; registered: {names()}")
    if not kwargs:
        if name not in _DEFAULTS:
            _DEFAULTS[name] = _FACTORIES[name]()
        return _DEFAULTS[name]
    return _FACTORIES[name](**kwargs)


def names() -> List[str]:
    return sorted(_FACTORIES)


def get_block_codec(name: str, *, axis: int, block: int) -> Codec:
    """Look up a codec that quantizes blockwise along one axis (the wire
    and cache format of the KV cache).  Raises a clear error for registry
    ids that take no axis/block configuration."""
    try:
        return get(name, axis=axis, block=block)
    except TypeError:
        raise ValueError(
            f"codec {name!r} is not a blockwise wire codec: it must accept "
            f"axis=/block= configuration (e.g. 'int8-block')") from None


@spanned("codec.decode")
def decode(c: Container, *, like=None, verify: bool = False,
           device: Optional[str] = None, **codec_kwargs) -> torch.Tensor:
    """Decode a container by its own header.  `codec_kwargs` configure the
    decode-side codec (e.g. kernel_impl).  ``verify=True`` checks the
    payload against the header's crc32 first and raises `ChecksumError`
    on mismatch."""
    if verify:
        check_container(c)
    codec = get(c.header.codec, **codec_kwargs)
    if c.header.version > codec.version:
        raise ValueError(
            f"container written by {c.header.codec} v{c.header.version}, "
            f"but installed codec is v{codec.version}")
    return codec.decode(c, like=like, device=device)
