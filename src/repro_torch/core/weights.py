"""Error-bounded weight compression for FSDP parameter gathers.

The paper's PREQUANT applied to the gather: each leaf is quantized to
int8 with blockwise scales (QBLOCK along the last dim) before use, and a
straight-through estimator keeps the backward exact with respect to the
f32 masters: quantized communication and compute, not quantized storage.
Error bound per element: scale/2 with scale = blockmax/127.

Off-mesh the form is `compress_for_gather`, the additive STE
``p + (qdq(p) - p).detach()`` (the reference's
``p + stop_gradient(qdq(p) - p)``).  On a mesh that form would gather the
f32 master; there `gather_dequant_tree` runs inside the model's period
loop, one period's weights at a time: each FSDP-sharded leaf is
quantized where it lies, its int8 codes and f32 block scales are
redistributed from the FSDP placement to the one without ``"data"`` (the
all-gather moves int8), and the gathered codes are dequantized for the
products.  The backward is the identity to the f32 master
(`gather_dequant_leaf`, an autograd Function: the reference's
``custom_vjp``), reduce-scattered back onto the master's placement.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.codecs import int8 as I8
from repro_torch.dist.sharding import P, mesh_shape, placements
from repro_torch.tree import leaves_with_path, rebuild

QBLOCK = 128
_SKIP_SUBSTR = ("norm",)     # tiny / sensitive leaves stay uncompressed


def _names(path):
    return [str(k) for k in path]


def _quantizable(path_names, x: torch.Tensor) -> bool:
    if any(s in n for n in path_names for s in _SKIP_SUBSTR):
        return False
    return x.dim() >= 1 and x.shape[-1] % QBLOCK == 0 and x.numel() >= 4096


def _qdq(x: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize (the value the forward pass sees), the
    "int8-block" codec's math along the last dim, with the scale in the
    jitted reference's form (``amax * f32(1/127)``)."""
    q, scale = I8.block_quantize(x.to(torch.float32), -1, QBLOCK,
                                 reciprocal=True)
    return I8.block_dequantize(q, scale, -1, QBLOCK, x.dtype)


def compress_for_gather(params: Any) -> Any:
    """Mesh-less variant: the forward sees int8-quantized values, the
    gradient with respect to the f32 masters is the identity (additive
    STE).  Norm leaves and leaves that are small or not block-aligned pass
    through."""
    out = []
    for path, p in leaves_with_path(params):
        if _quantizable(_names(path), p):
            with torch.no_grad():
                delta = _qdq(p) - p
            p = p + delta
        out.append(p)
    return rebuild(params, iter(out))


# ---------------------------------------------------------------------------
# mesh-aware int8 weight gather
# ---------------------------------------------------------------------------

def _drop_data(spec) -> P:
    """The spec without the FSDP axis (tensor-parallel axes kept)."""
    def clean(el):
        if el == "data":
            return None
        if isinstance(el, (tuple, list)):
            kept = tuple(a for a in el if a != "data")
            return kept if kept else None
        return el
    return P(*[clean(e) for e in spec])


def _has_data(spec) -> bool:
    return any(el == "data" or (isinstance(el, (tuple, list))
                                and "data" in el) for el in spec)


class _GatherDequant(torch.autograd.Function):
    """Forward: quantize the local shard of the master, redistribute the
    int8 codes and f32 scales to `tgt` (the all-gather over "data" moves
    int8), dequantize.  Backward: the identity to the master, with the
    cotangent redistributed onto the master's placements."""

    @staticmethod
    def forward(ctx, p, mesh, src, tgt):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.src = mesh, src
        q, scale = I8.block_quantize(p.to_local().to(torch.float32), -1,
                                     QBLOCK, reciprocal=True)
        q = DTensor.from_local(q, mesh, src, run_check=False)
        scale = DTensor.from_local(scale, mesh, src, run_check=False)
        q = q.redistribute(mesh, tgt).to_local()
        scale = scale.redistribute(mesh, tgt).to_local()
        out = I8.block_dequantize(q, scale, -1, QBLOCK, p.dtype)
        return DTensor.from_local(out, mesh, tgt, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.src), None, None, None


def gather_dequant_leaf(p, spec, mesh):
    """`p` (a DTensor placed by `spec`) as int8-quantized values placed
    without "data": the int8 gather.  The gradient passes straight
    through to the f32 master."""
    return _GatherDequant.apply(p, mesh, placements(spec, mesh, p.dim()),
                                placements(_drop_data(spec), mesh, p.dim()))


def gather_dequant_tree(params: Any, specs: Any, mesh) -> Any:
    """`gather_dequant_leaf` on every quantizable FSDP-sharded leaf of one
    period's parameters (called inside the period loop, so only one
    period's weights are held gathered at a time).  A leaf whose local
    last dim is not block-aligned passes through, as in the reference."""
    sizes = mesh_shape(mesh)
    flat_specs = [sp for _, sp in leaves_with_path(specs)]
    out = []
    for (path, p), spec in zip(leaves_with_path(params), flat_specs):
        if _quantizable(_names(path), p) and _has_data(spec):
            last = spec[-1] if len(spec) == p.dim() else None
            div = 1
            if last is not None:
                for a in (last if isinstance(last, tuple) else (last,)):
                    div *= sizes[a]
            if (p.shape[-1] // div) % QBLOCK == 0:
                p = gather_dequant_leaf(p, spec, mesh)
        out.append(p)
    return rebuild(params, iter(out))


@torch.no_grad()
def max_weight_error(params: Any) -> float:
    """Worst blockmax-relative quantization error across the quantizable
    leaves: 1/(2·127) by construction; measured for tests."""
    worst = 0.0
    for path, p in leaves_with_path(params):
        if not _quantizable(_names(path), p):
            continue
        err = (_qdq(p) - p).abs().max()
        ref = p.abs().max()
        worst = max(worst, float(err / (ref + 1e-30)))
    return worst
