"""Plain PyTorch version of the per-level cubic interpolation step.

One interpolation level along one axis, collapsed to 2-D rows (the
predictor moves the working axis last and flattens the rest):

  pe   [R, me+3] int32  even-sample rows, edge-replicate padded with one
                        sample left and two right (so every odd position
                        sees four even neighbours at fixed offsets)
  odd  [R, mo]   int32  the odd samples (encode) / their residuals (decode)

The prediction for odd position i is the integer cubic stencil
p = (9·(b+c) − a − d + 8) >> 4 with a..d = pe[:, i .. i+3].  All
arithmetic is exact int32 (prequant magnitudes stay below 2^23, so
9·(b+c) cannot overflow) and `>>` on int32 is an arithmetic shift
(floor), as in the reference, so encode and decode are exact inverses.
"""
from __future__ import annotations

import torch


def _predict(pe: torch.Tensor, mo: int) -> torch.Tensor:
    a = pe[:, 0:mo]
    b = pe[:, 1:1 + mo]
    c = pe[:, 2:2 + mo]
    d = pe[:, 3:3 + mo]
    return (9 * (b + c) - a - d + 8) >> 4


def residual_rows_ref(pe: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Encode direction: residual = odd − prediction(even)."""
    return odd - _predict(pe, odd.shape[1])


def odd_rows_ref(pe: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    """Decode direction: odd = residual + prediction(even)."""
    return resid + _predict(pe, resid.shape[1])
