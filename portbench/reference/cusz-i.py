"""Plain reference of the cusz-i codec, frozen for the benchmark.

cuSZ-i (arXiv:2312.05492) replaces cusz's blocked Lorenzo predictor by
multi-level interpolation.  Written out in plain PyTorch, on whatever
device its input is on:

  1. the value-relative error bound and PREQUANT, q = rint(x * f32(1 /
     f32(2 eb))), as cusz's (`reference/cusz.py`);
  2. the level plan: every axis longer than 4 is halved in turn, axis 0
     first, round after round, until no axis is longer than 4; a step
     along an axis of length s keeps its ceil(s / 2) even positions and
     leaves its floor(s / 2) odd positions to predict;
  3. each odd position is predicted from its four even neighbours
     a, b, c, d (even indices j - 1 .. j + 2 for odd index 2 j + 1, the
     indices clamped to the even row, i.e. the row edge-replicated by 1
     on the left and 2 on the right) by the integer stencil
     (9 (b + c) - a - d + 8) >> 4, and its residual is kept: step by
     step, each step's residuals in row-major order with the step's axis
     moved last; the even positions go on to the next step, and what is
     left after the last step is the anchor grid (at most 4 per axis);
  4. residuals mapped to codes and outliers as cusz's deltas, with the
     outlier capacity taken from the field's size, and the same Huffman
     payload;
  5. the anchor grid rides along as int32, row-major.

Departures from the paper, all of them the repository's design: the
levels run on the prequantized integers with floor arithmetic, so
decode inverts encode exactly and the one rounding is PREQUANT's (the
paper predicts from reconstructed values and bounds each level's error);
the stencil is one cubic for every level and axis, with replicated
edges, and the level order is the plan above (the paper tunes the spline
and the order of the axes per level, from a fixed anchor stride).

`compress` gives the container's header fields and payload arrays, the
device form that the program's `encode` returns; `stored_nbytes` counts
the bytes of its storage form (`pack`); `reconstruct` gives what a
decode must return, q * f32(2 eb), since the lifting is exact.  Nothing
here imports the program; the parts shared with cusz are read from the
file beside this one.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import torch


def _load_cusz():
    path = Path(__file__).with_name("cusz.py")
    spec = importlib.util.spec_from_file_location("cusz_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_cusz = _load_cusz()
resolve_eb = _cusz.resolve_eb
prequant = _cusz.prequant
reconstruct = _cusz.reconstruct
tolerance = _cusz.tolerance
LIMITS = _cusz.LIMITS

#: no axis of the anchor grid is longer than this
ANCHOR = 4


def level_plan(shape) -> Tuple[List[Tuple[int, Tuple[int, ...]]],
                               Tuple[int, ...]]:
    """(steps, anchor shape): each step is (axis, the shape it splits)."""
    s = list(shape)
    if max(s) <= ANCHOR:
        raise ValueError(f"the reference covers fields with an axis longer "
                         f"than {ANCHOR}, not {tuple(shape)}")
    steps = []
    while max(s) > ANCHOR:
        for a in range(len(s)):
            if s[a] > ANCHOR:
                steps.append((a, tuple(s)))
                s[a] = (s[a] + 1) // 2
    return steps, tuple(s)


def residuals(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(residuals, anchor) of the prequantized field `q`, both int32 and
    flat, in the order of item 3 of the module's description."""
    steps, _ = level_plan(q.shape)
    dev = q.device
    out = []
    for axis, shp in steps:
        s = shp[axis]
        even = q.index_select(axis, torch.arange(0, s, 2, device=dev))
        odd = q.index_select(axis, torch.arange(1, s, 2, device=dev))
        j = torch.arange(odd.shape[axis], device=dev)
        last = even.shape[axis] - 1

        def at(k):
            return even.index_select(axis, (j + k).clamp(0, last))

        pred = (9 * (at(0) + at(1)) - at(-1) - at(2) + 8) >> 4
        out.append((odd - pred).movedim(axis, -1).reshape(-1))
        q = even
    return torch.cat(out), q.reshape(-1)


def compress(x: torch.Tensor, params: dict, dtype=torch.float32
             ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(header fields, payload arrays) of the cusz-i container of `x`;
    `dtype` is PREQUANT's (float32; the control's bfloat16)."""
    x = x.to(torch.float32).contiguous()
    eb = resolve_eb(x, params)
    nbins = int(params["nbins"])
    resid, anchor = residuals(prequant(x, eb, dtype))
    radius = nbins // 2
    in_cap = (resid > -radius) & (resid < radius)
    codes = torch.where(in_cap, resid + radius, 0).to(torch.int32)
    cap = max(16, int(x.numel() * float(params["outlier_frac"])))
    idx, val, n_out = _cusz.outliers(codes, resid, cap)
    del resid
    payload = _cusz.huffman_payload(codes, nbins, int(params["chunk_size"]),
                                    int(params["sub_size"]))
    payload.update(out_idx=idx, out_val=val, n_outliers=n_out,
                   anchor=anchor.to(torch.int32))
    header = {"shape": list(x.shape), "dtype": "float32", "eb": eb,
              "nbins": nbins, "chunk_size": int(params["chunk_size"]),
              "sub_size": int(params["sub_size"]),
              "block": list(_cusz.BLOCKS[x.ndim]),
              "outlier_frac": float(params["outlier_frac"]),
              "predictor": "interp"}
    return header, payload


def stored_nbytes(payload: Dict[str, torch.Tensor]) -> int:
    """cusz's storage form plus the anchor grid, 4 B a value."""
    return _cusz.stored_nbytes(payload) + 4 * int(payload["anchor"].numel())
