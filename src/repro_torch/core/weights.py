"""Error-bounded weight compression for FSDP parameter gathers.

The paper's PREQUANT applied to the gather: each leaf is quantized to
int8 with blockwise scales (QBLOCK along the last dim) before use, and a
straight-through estimator keeps the backward exact with respect to the
f32 masters: quantized communication and compute, not quantized storage.
Error bound per element: scale/2 with scale = blockmax/127.

The port has no mesh yet, so it carries the reference's mesh-less form,
`compress_for_gather` (the additive STE ``p + (qdq(p) - p).detach()``,
which is the reference's ``p + stop_gradient(qdq(p) - p)``), and
`max_weight_error`.  The mesh gathers (`gather_dequant_leaf`,
`gather_dequant_tree`) come with the port's meshes.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.codecs import int8 as I8
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
