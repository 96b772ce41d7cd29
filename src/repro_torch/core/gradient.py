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
On a mesh with a "pod" axis each rank holds its own pod's grads (no
leading axis), and the pod mean is explicit: a small f32
``all_reduce(MAX)`` of each leaf's amax over the pod group, then an
``all_reduce(SUM)`` of the integer codes in the codec's narrow dtype.
The reference's step is jitted, where XLA turns ``amax / qeff`` into
``amax * f32(1/qeff)``; the port derives the shared scale in that form,
so codes and means equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.codecs import int8 as I8
from repro_torch.dist.context import constrain_like_params, current_mesh
from repro_torch.dist.sharding import mesh_shape
from repro_torch.tree import tree_map


def compressed_psum_mean(grads_podded: Any, mode: str, npods: int) -> Any:
    """grads_podded: tree whose leaves have a leading pod axis of size
    `npods`.  Returns the pod-mean tree without that axis.

    mode: 'none' | 'int8' | 'int16', a `repro_torch.codecs` registry name
    whose `quantize` math (with the shared cross-pod scale) is used.

    Under a mesh with a "pod" axis the leaves are this rank's pod's
    grads, without the leading axis (DTensors on the pod's sub-mesh, or
    plain tensors), and the mean is taken across the pod group
    (`pod_mean`)."""
    mesh = current_mesh()
    if mesh is not None and "pod" in mesh_shape(mesh):
        if npods != mesh_shape(mesh)["pod"]:
            raise ValueError(f"npods={npods} but the mesh has "
                             f"{mesh_shape(mesh)['pod']} pods")
        return pod_mean(grads_podded, mode, mesh)
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


def pod_mean(grads: Any, mode: str, mesh) -> Any:
    """The mean over `mesh`'s "pod" axis of each rank's pod grads (same
    structure and placements out as in).  mode 'none' all-reduces the f32
    values; 'int8' / 'int16' quantize with the pod-wide shared scale
    ``max(amax·f32(1/qeff), 1e-30)``, qeff = qmax // npods, and
    all-reduce the integer codes in the codec's narrow dtype; the mean is
    ``sum.float() * (scale * f32(1/npods))``, the jitted reference's
    form, so it equals the mesh-less mean bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    group = mesh.get_group("pod")
    npods = mesh_shape(mesh)["pod"]

    def parts(g):
        if isinstance(g, DTensor):
            return g.to_local(), (lambda t: DTensor.from_local(
                t, g.device_mesh, g.placements, run_check=False))
        return g, (lambda t: t)

    if mode == "none":
        def one(g):
            local, wrap = parts(g)
            s = local.to(torch.float32, copy=True,
                         memory_format=torch.contiguous_format)
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
            return wrap(s * I8.recip(npods, s))
        return tree_map(one, grads)
    from repro_torch import codecs

    codec = codecs.get(mode)
    qeff = float(codec.qmax // npods)

    def one(g):
        local, wrap = parts(g)
        amax = g.to(torch.float32).abs().amax()
        if isinstance(amax, DTensor):
            amax = amax.full_tensor()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = I8._floor(amax * I8.recip(qeff, amax))
        q, scale = I8.quantize(local, qeff, codec.qdtype, scale=scale)
        q = q.contiguous()                     # NCCL takes dense buffers
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return wrap(q.to(torch.float32) * (scale * I8.recip(npods, scale)))

    return tree_map(one, grads)


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
