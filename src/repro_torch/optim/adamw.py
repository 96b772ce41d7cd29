"""AdamW with optional int8 block-quantized moments (the paper's PREQUANT
applied to optimizer state: a quarter of the resident bytes of m and v,
plus one f32 scale per 128 values).

The reference's `repro.optim.adamw`, with its names, NamedTuples and
arithmetic, run in place: `update` writes each parameter and moment leaf
where it lies, leaf by leaf in the reference's pytree order.  A
functional update (new params, m and v before the old ones die) would
need a second copy of the 48 GB f32 train state of a 4 B-parameter model
on an 80 GB card.

The reference's step is jitted, where XLA turns the divide by the
constant 127 in `_quantize` into a multiply by f32(1/127); the port
computes the scale in that form, so int8 codes and scales equal the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.codecs.base import input_device
from repro_torch.codecs.int8 import recip
from repro_torch.tree import (is_namedtuple, leaves, leaves_up_to,
                               pop_leaves, tree_map)

QBLOCK = 128
_SCALE_FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized_moments: bool = False   # int8 m/v (large models)


class QTensor(NamedTuple):
    """Blockwise int8 tensor of the source's shape; scales per QBLOCK
    along the last dim."""
    q: torch.Tensor        # int8, x.shape
    scale: torch.Tensor    # f32,  x.shape[:-1] + (last/QBLOCK,)


class AdamWState(NamedTuple):
    count: torch.Tensor    # 0-d int32
    m: Any
    v: Any


def _quantizable(x: torch.Tensor) -> bool:
    return x.dim() >= 1 and x.shape[-1] % QBLOCK == 0 and x.numel() >= 4096


def _quantize(x: torch.Tensor):
    """QTensor of `x` (a copy of `x` in f32 for tiny leaves), with the
    jitted reference's scale ``max|block| * f32(1/127)``."""
    if not _quantizable(x):
        return x.to(torch.float32, copy=True)
    return _quantize_blocks(x)


def _quantize_blocks(x: torch.Tensor) -> QTensor:
    """`x` in int8 blocks of QBLOCK along its last dim (a whole number of
    them): a whole leaf, or a rank's shard of a leaf that is
    quantizable."""
    nb = x.shape[-1] // QBLOCK
    xf = x.to(torch.float32).reshape(x.shape[:-1] + (nb, QBLOCK))
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax * recip(127.0, amax), _SCALE_FLOOR)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(
        torch.int8).reshape(x.shape)
    return QTensor(q, scale)


def _dequantize(qt, shape) -> torch.Tensor:
    if not isinstance(qt, QTensor):
        return qt
    nb = shape[-1] // QBLOCK
    xf = qt.q.to(torch.float32).reshape(tuple(shape[:-1]) + (nb, QBLOCK))
    return (xf * qt.scale[..., None]).reshape(shape)


def _local(t):
    """A DTensor's local shard (a view: in-place writes land in the
    DTensor); any other tensor or QTensor as it is.  The update is
    elementwise and runs where the moments live (`update`), so each
    rank updates its own shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, QTensor):
        return QTensor(_local(t.q), _local(t.scale))
    return t.to_local() if isinstance(t, DTensor) else t


def moment_placements(p):
    """The placements of the int8 moments of the DTensor `p`
    (`sharding.quantized_moment_spec` of its spec): its own, unless they
    split the last dim into shards that are not whole QBLOCKs."""
    from repro_torch.dist.sharding import (mesh_shape, placements,
                                           quantized_moment_spec, spec_of)

    mesh = p.device_mesh
    spec = quantized_moment_spec(spec_of(p), p.shape, mesh_shape(mesh))
    return tuple(placements(spec, mesh, p.dim()))


def _zero_quantized(p):
    """Zero int8 moments of `p`.  On a DTensor each rank quantizes its
    own shard, placed by `moment_placements`, so that its blocks are
    the global array's: codes and scales are the reference's
    global-array `_quantize`, bit for bit."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return _quantize(torch.zeros_like(p))
    if not _quantizable(p):
        return torch.zeros_like(p, dtype=torch.float32)
    pl = moment_placements(p)
    local = torch.zeros_like(p.redistribute(p.device_mesh, pl).to_local(),
                             dtype=torch.float32)
    return QTensor(*(DTensor.from_local(t, p.device_mesh, pl,
                                        run_check=False)
                     for t in _quantize_blocks(local)))


def _device_of(tree) -> torch.device:
    first = leaves(tree)
    return first[0].device if first else torch.device("cpu")


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments on each parameter's device (f32, or QTensors where the
    leaf is quantizable and `cfg.quantized_moments`)."""
    if cfg.quantized_moments:
        zero = _zero_quantized
    else:
        def zero(p):
            return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(torch.zeros((), dtype=torch.int32,
                                  device=_device_of(params)),
                      tree_map(zero, params), tree_map(zero, params))


def _leaf_(g: torch.Tensor, m, v, p: torch.Tensor, cfg: AdamWConfig,
           b1c: torch.Tensor, b2c: torch.Tensor) -> None:
    """One leaf of the reference's update, written into p, m and v."""
    g = g.to(torch.float32)
    mq, vq = isinstance(m, QTensor), isinstance(v, QTensor)
    m_f = _dequantize(m, g.shape) if mq else m
    v_f = _dequantize(v, g.shape) if vq else v
    # m = b1·m + (1-b1)·g ;  v = b2·v + (1-b2)·g·g
    t = g * (1 - cfg.b1)
    m_f.mul_(cfg.b1).add_(t)
    torch.mul(g, 1 - cfg.b2, out=t)
    t.mul_(g)
    v_f.mul_(cfg.b2).add_(t)
    # upd = (m / b1c) / (sqrt(v / b2c) + eps)
    torch.div(v_f, b2c, out=t)
    t.sqrt_().add_(cfg.eps)
    upd = torch.div(m_f, b1c)
    upd.div_(t)
    # p = p - lr·(upd + wd·p)
    torch.mul(p, cfg.weight_decay, out=t)
    upd.add_(t)
    upd.mul_(cfg.lr)
    p.sub_(upd)
    for moment, f in ((m, m_f), (v, v_f)):
        if isinstance(moment, QTensor):
            q = _quantize_blocks(f)
            moment.q.copy_(q.q)
            moment.scale.copy_(q.scale)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step in place: `params` and the moments of `state` are
    written leaf by leaf (the reference's arithmetic), and each gradient
    leaf is dropped from `grads` once it is used.  Returns
    (params, AdamWState(count + 1, m, v)), the same trees."""
    c = _local(state.count) + 1       # a restored count may be placed
    cf = c.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=cf.device), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=cf.device), cf)
    flat_p = leaves(params)
    flat_m = leaves_up_to(params, state.m)
    flat_v = leaves_up_to(params, state.v)
    for g, m, v, p in zip(pop_leaves(grads), flat_m, flat_v, flat_p):
        # the update runs where the moments live: the parameter's
        # placements, or int8 moments' own (`moment_placements`), with
        # the parameter moved there and its new values moved back
        at = getattr(m.q if isinstance(m, QTensor) else m, "placements",
                     None)
        if getattr(g, "placements", None) != at:
            g = g.redistribute(p.device_mesh, at)
        pm = p
        if getattr(p, "placements", None) != at:
            pm = p.redistribute(p.device_mesh, at)
        _leaf_(_local(g), _local(m), _local(v), _local(pm), cfg,
               b1c.to(p.device), b2c.to(p.device))
        if pm is not p:
            _local(p).copy_(_local(pm.redistribute(p.device_mesh,
                                                   p.placements)))
        del g, pm
    return params, AdamWState(c, state.m, state.v)


def opt_state_from_numpy(state, device=None) -> AdamWState:
    """The reference's `AdamWState` as numpy arrays
    (``jax.tree.map(np.asarray, opt)``) -> the port's, on `device`
    (default CUDA): its QTensor moments become the port's QTensors."""
    device = input_device(None, device)

    def conv(t):
        if is_namedtuple(t):
            items = [conv(x) for x in t]
            return (QTensor(*items) if tuple(t._fields) == QTensor._fields
                    else type(t)(*items))
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        # a copy keeps 0-d arrays 0-d and jax's read-only views writable
        return torch.from_numpy(np.array(t, copy=True)).to(device)

    count, m, v = state
    return AdamWState(conv(count), conv(m), conv(v))
