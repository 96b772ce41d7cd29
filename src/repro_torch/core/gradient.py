"""Error-bounded gradient compression for the cross-pod all-reduce.

The paper's PREQUANT (d° = round(d/(2·eb))) applied to the
distributed-training collective: gradients are quantized to narrow
integers before the reduction, so the all-reduce moves 1-2 bytes per
value instead of 4.  With the per-tensor scale s = amax·npods/qmax every
value's error is at most s/2, and so is the error of the pod mean.  All
pods share one scale (amax over every pod), so the integer sum is exact
and cannot overflow: |q| <= qmax // npods.

Off-mesh the pod axis is a leading axis of one tensor on one device, as
the reference runs it without a mesh; the sum over it is the all-reduce.
The reference's step is jitted, where XLA turns ``amax / qeff`` into
``amax * f32(1/qeff)``; the port derives the shared scale in that form,
so codes and means equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.codecs import int8 as I8
from repro_torch.dist.context import constrain_like_params
from repro_torch.tree import tree_map


def compressed_psum_mean(grads_podded: Any, mode: str, npods: int) -> Any:
    """grads_podded: tree whose leaves have a leading pod axis of size
    `npods`.  Returns the pod-mean tree without that axis.

    mode: 'none' | 'int8' | 'int16', a `repro_torch.codecs` registry name
    whose `quantize` math (with the shared cross-pod scale) is used."""
    if mode == "none":
        return tree_map(lambda g: torch.mean(g, dim=0), grads_podded)
    from repro_torch import codecs

    codec = codecs.get(mode)
    qeff = float(codec.qmax // npods)                # per-pod level budget
    grads_podded = constrain_like_params(grads_podded, lead_axis="pod")

    def one(g):
        amax = g.to(torch.float32).abs().amax()
        scale = I8._floor(amax * I8.recip(qeff, amax))
        q, scale = I8.quantize(g, qeff, codec.qdtype, scale=scale)
        s = torch.sum(q, dim=0, dtype=codec.qdtype)   # the narrow all-reduce
        return s.to(torch.float32) * (scale * I8.recip(npods, scale))

    return tree_map(one, grads_podded)


def quantize_tensor(g: torch.Tensor, mode: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone PREQUANT of one tensor: (q, scale), the registered
    codec's `quantize` math."""
    from repro_torch import codecs

    codec = codecs.get(mode)
    return I8.quantize(g, float(codec.qmax), codec.qdtype)


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return I8.dequantize(q, scale)


def error_bound_of(g: torch.Tensor, mode: str) -> torch.Tensor:
    """The effective absolute error bound (= scale/2) of a tensor."""
    from repro_torch import codecs

    qmax = float(codecs.get(mode).qmax)
    return I8.true_div(g.abs().amax(), qmax) / 2.0
