"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, initializers."""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


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
    hd = x.shape[-1]
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
