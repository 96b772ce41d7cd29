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
decodes where its tensors are.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .container import Container, Header, check_container, make_header


def input_device(x, device=None) -> torch.device:
    """Where an entry point runs for input `x`: `device` if given, else the
    tensor's own device, else CUDA (numpy input)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device("cuda")


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

    # -- required -----------------------------------------------------------
    def encode(self, x, *, cfg=None, device=None) -> Container:
        raise NotImplementedError

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        raise NotImplementedError

    # -- storage form ---------------------------------------------------------
    def pack(self, c: Container) -> Container:
        """Host/storage form: numpy payload, `packed=True` plus a payload
        crc32 (``checksum``) in the header."""
        raise NotImplementedError

    def unpack(self, c: Container, device=None) -> Container:
        """Inverse of `pack`: tensors on `device` (default CUDA), with the
        storage-only params dropped."""
        raise NotImplementedError

    # -- shared helpers -----------------------------------------------------
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
