"""Multi-level interpolation predictor (cuSZ-i, arXiv 2312.05492) behind
the `Predictor` stage protocol.

Scheme: prequantize ONCE to exact int32 (the pipeline's only lossy
step), then lift level by level: along each axis the samples split into
even/odd strides, every odd sample is predicted with an integer cubic
stencil over its four even neighbours, and only the residual is kept;
the even half recurses until every dim is at the anchor size.  The small
anchor grid rides in the payload uncompressed (int32).

The lifting runs on prequantized integers with floor-division
arithmetic, so encode and decode are exact inverses and the single
prequant rounding bounds the error by eb at any level count.

The level plan is a pure function of the field shape; each level moves
its axis last, splits even/odd strides, edge-pads the even rows and hands
[R, me+3] / [R, mo] rows to one kernel launch (`kernels.interp`).  The
residual stream order (level-major, then row-major in the moved layout)
is shared by predict and reconstruct, and is the reference's.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.interp import ops as interp_ops
from repro_torch.perf.trace import span

from . import dualquant as dq
from . import stages

#: stop splitting once every dim is at most this (the anchor grid)
ANCHOR = 4
#: the span around the level loop of `predict` and of `reconstruct`: one
#: per field, so the loop's torch copies can be told apart from the rest
#: of `stage.predict` / `stage.reconstruct` in a trace
LEVELS_SPAN = "stage.interp.levels"


@functools.lru_cache(maxsize=512)
def interp_plan(shape: Tuple[int, ...]
                ) -> Tuple[Tuple[Tuple[int, Tuple[int, ...]], ...],
                           Tuple[int, ...]]:
    """Static level plan for `shape`.

    Returns (steps, anchor_shape): each step is (axis, shape-before-
    split); the split replaces size s with ceil(s/2) evens, emitting
    floor(s/2) odd residuals.  At least one step is forced for tiny
    fields (so the encoder always sees a nonempty code stream) unless
    every dim is 1.
    """
    s = list(shape)
    steps: List[Tuple[int, Tuple[int, ...]]] = []
    while max(s) > ANCHOR:
        for a in range(len(s)):
            if s[a] > ANCHOR:
                steps.append((a, tuple(s)))
                s[a] = (s[a] + 1) // 2
    if not steps and max(s) >= 2:
        a = int(np.argmax(s))
        steps.append((a, tuple(s)))
        s[a] = (s[a] + 1) // 2
    return tuple(steps), tuple(s)


def _n_residuals(shape: Tuple[int, ...]) -> int:
    _, anchor_shape = interp_plan(shape)
    return int(np.prod(shape)) - int(np.prod(anchor_shape))


def _pad_even(e2: torch.Tensor) -> torch.Tensor:
    """[R, me] -> [R, me+3]: edge-replicate 1 left / 2 right so every odd
    position gathers four even neighbours at fixed offsets."""
    return torch.cat([e2[:, :1], e2, e2[:, -1:], e2[:, -1:]], dim=1)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Merge even/odd strides back along the last axis (exact inverse of
    the [0::2]/[1::2] split)."""
    s = even.shape[-1] + odd.shape[-1]
    out = torch.empty(even.shape[:-1] + (s,), dtype=even.dtype,
                      device=even.device)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


class InterpPredictor(stages.Predictor):
    name = "interp"
    kernels = ("interp.predict", "interp.reconstruct")
    payload_keys = ("out_idx", "out_val", "n_outliers", "anchor")

    def n_codes(self, shape, cfg) -> int:
        return max(1, _n_residuals(tuple(shape)))

    def predict(self, data, cfg, eb, pp):
        shape = tuple(data.shape)
        steps, _ = interp_plan(shape)
        impl = pp.for_kernel("interp.predict")
        x = dq.prequant(data, eb)
        parts = []
        with span(LEVELS_SPAN):
            for axis, _ in steps:
                xm = torch.movedim(x, axis, -1)
                even, odd = xm[..., 0::2], xm[..., 1::2]
                e2 = even.reshape(-1, even.shape[-1])
                o2 = odd.reshape(-1, odd.shape[-1]).contiguous()
                r2 = interp_ops.residual_rows(_pad_even(e2), o2, impl=impl)
                parts.append(r2.reshape(-1))
                x = torch.movedim(even, -1, axis)
        if parts:
            resid = torch.cat(parts)
        else:
            # degenerate all-ones shape: one in-cap dummy symbol, so the
            # encoder never sees an empty stream
            resid = torch.zeros((1,), dtype=torch.int32, device=data.device)
        codes, in_cap = dq.postquant_codes(resid, cfg.nbins)
        cap = stages.outlier_capacity(int(np.prod(shape)), cfg)
        oidx, oval, n_out = dq.extract_outliers(resid, in_cap, cap)
        return codes, {"out_idx": oidx, "out_val": oval,
                       "n_outliers": n_out,
                       "anchor": x.reshape(-1).to(torch.int32)}

    def reconstruct(self, codes_flat, payload, cfg, eb, shape, pp):
        steps, anchor_shape = interp_plan(tuple(shape))
        impl = pp.for_kernel("interp.reconstruct")
        # nothing from here to the return reads the card, so the host
        # queues the level loop while the card still works on the deltas
        delta = dq.outlier_deltas(codes_flat[:self.n_codes(shape, cfg)],
                                  cfg.nbins, payload["out_idx"],
                                  payload["out_val"])
        # replay the plan for each step's residual offset and its odd
        # shape in the moved layout
        segs = []
        off = 0
        for axis, shp in steps:
            moved = shp[:axis] + shp[axis + 1:] + (shp[axis] // 2,)
            segs.append((axis, moved, off))
            off += int(np.prod(moved))
        x = payload["anchor"].reshape(anchor_shape)
        with span(LEVELS_SPAN):
            for axis, odd_shape, off in reversed(segs):
                em = torch.movedim(x, axis, -1)
                e2 = em.reshape(-1, em.shape[-1])
                r2 = delta[off:off + int(np.prod(odd_shape))].reshape(
                    -1, odd_shape[-1])
                o2 = interp_ops.odd_rows(_pad_even(e2), r2, impl=impl)
                x = torch.movedim(_interleave(em, o2.reshape(odd_shape)),
                                  -1, axis)
        return dq.dequant(x, eb)

    def valid(self, payload):
        return stages._outlier_valid(payload)

    def pack_payload(self, payload):
        d = stages._pack_outliers(payload)
        d["anchor"] = np.asarray(payload["anchor"], np.int32)
        return d

    def unpack_payload(self, packed, cfg, shape):
        d = stages._unpack_outliers(packed)
        d["anchor"] = np.asarray(packed["anchor"], np.int32)
        return d

    def stored_nbytes(self, packed):
        return (len(packed["out_idx"]) * 8
                + np.asarray(packed["anchor"]).size * 4)


stages.register_predictor("interp", InterpPredictor)
