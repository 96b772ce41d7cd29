"""Identity codec: raw arrays behind the same `Codec` contract.

Exists so every checkpoint leaf — compressed or not — goes through one
container format, and so non-native dtypes survive storage: numpy has no
bfloat16, so `pack` bitcasts such a tensor to a same-width unsigned view
(uint16 for bfloat16, the reference's stored bytes) and `unpack`
restores it from the header's recorded dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.sharding import even_shard_axis

from .base import Codec, as_tensor, input_device, register, torch_dtype
from .container import Container, stamp_checksum, to_numpy

_INT_OF = {1: (torch.int8, np.uint8), 2: (torch.int16, np.uint16),
           4: (torch.int32, np.uint32), 8: (torch.int64, np.uint64)}
# dtypes that exist in torch but not in numpy: stored as raw bits
_NO_NUMPY = tuple(getattr(torch, n) for n in
                  ("bfloat16", "float8_e4m3fn", "float8_e5m2")
                  if hasattr(torch, n))


def _storage_array(v) -> np.ndarray:
    """Host array of a payload value; dtypes numpy lacks go as unsigned
    integers of the same width."""
    if isinstance(v, torch.Tensor) and v.dtype in _NO_NUMPY:
        sint, uint = _INT_OF[v.element_size()]
        # repro-lint: allow[host-sync] pack() IS the device->storage boundary
        return v.detach().cpu().view(sint).numpy().view(uint)
    return to_numpy(v)


def _restore(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """Tensor of the header's dtype from a stored array (undoes the
    storage bitcast)."""
    arr = np.require(np.asarray(arr), requirements="CW")
    want = torch_dtype(dtype_name)
    if want in _NO_NUMPY:
        sint, _ = _INT_OF[arr.dtype.itemsize]
        return torch.from_numpy(arr).view(sint).view(want).to(device)
    np_want = np.dtype(dtype_name)
    if arr.dtype != np_want and arr.dtype.itemsize == np_want.itemsize:
        arr = arr.view(np_want)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass(frozen=True)
class LosslessCodec(Codec):
    name = "lossless"
    version = 1

    def encode(self, x, *, cfg=None, device=None) -> Container:
        return Container(self._header(x), {"data": as_tensor(x, device)})

    def decode(self, c: Container, *, like=None, device=None) -> torch.Tensor:
        p = self._device_payload(c, device)
        return self._finish(p["data"], c.header, like)

    def pack(self, c: Container) -> Container:
        if c.header.param("packed"):
            return c
        return stamp_checksum(Container(
            c.header.with_params(packed=True),
            {"data": _storage_array(c.payload["data"])}))

    def unpack(self, c: Container, device=None) -> Container:
        if not c.header.param("packed"):
            return c
        data = _restore(c.payload["data"], c.header.dtype,
                        input_device(None, device))
        return Container(
            c.header.with_params(packed=False).without_params("checksum"),
            {"data": data})

    # -- sharded encode: identity is trivially split-stable
    def shard_axis(self, shape, nshards: int):
        return even_shard_axis(shape, nshards)

    def payload_axes(self, axis: int):
        return {"data": axis}


register("lossless", lambda **kw: LosslessCodec(**kw))
