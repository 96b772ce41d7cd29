"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, initializers."""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


class Split(NamedTuple):
    """This rank's slice of a dim that the ranks of a process group
    split (a cache of the mesh decode): the slice's first index and the
    group whose ranks hold the other slices."""
    first: int
    group: object


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, computed in numpy float32 with a Python-float
    theta exactly as the reference computes them."""
    return 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim)


@functools.lru_cache(maxsize=None)
def _device_freqs(head_dim: int, theta: float, device: torch.device
                  ) -> torch.Tensor:
    """`rope_freqs` on `device`, copied there once: a copy from pageable
    host memory inside the decode loop would wait for the stream."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: [..., S] integer positions."""
    from torch._subclasses.fake_tensor import is_fake

    hd = x.shape[-1]
    if is_fake(x):       # a cached fake tensor would outlive its mode
        freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    else:
        freqs = _device_freqs(hd, theta, x.device)
    ang = pos[..., None].float() * freqs                   # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: Union[int, Sequence[int]] = 0, device=None,
               std: Optional[float] = None) -> torch.Tensor:
    """Normal f32 weights scaled by `std` (default 1/sqrt(fan_in)), drawn
    from `gen` on the generator's device and moved to `device` (default:
    the generator's).  Without a generator they are drawn on `device`
    (the meta device allocates nothing)."""
    if std is None:
        fan_in = shape[in_axis] if isinstance(in_axis, int) else \
            math.prod(shape[a] for a in in_axis)
        std = 1.0 / math.sqrt(fan_in)
    where = gen.device if gen is not None else device
    w = torch.randn(tuple(shape), generator=gen, device=where,
                    dtype=torch.float32) * std
    return w.to(device) if device is not None else w


def local_weights(p, mesh, rows, on_model, split_dim=None):
    """A mesh block's weights (a dict of DTensors) as this rank's local
    tensors, for a block that runs the off-mesh code on its own rows
    (`rows`: per mesh dim, whether the activations' rows are split over
    it).  Each weight is gathered whole, except over the mesh dims in
    `on_model` where ``split_dim(name, t)`` names a dim: that dim stays
    split (the heads of an attention block).  Gradients: a partial sum
    over the row axes (each rank saw its own rows) and over a split
    axis for a weight that has no split dim (it saw its own heads
    only), replicated elsewhere (every rank computed the same)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = {}
    for name, t in p.items():
        d = split_dim(name, t) if split_dim is not None else None
        pl = [Shard(d) if m and d is not None else Replicate()
              for m in on_model]
        t = t.redistribute(mesh, pl)
        out[name] = t.to_local(grad_placements=[
            Partial() if r or (m and d is None) else q
            for r, m, q in zip(rows, on_model, pl)])
    return out
