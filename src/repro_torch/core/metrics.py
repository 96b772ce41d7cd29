"""Quality metrics used in the paper's evaluation (§4.2.2)."""
from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def rmse(a, b) -> float:
    a = _t(a).to(torch.float64)
    b = _t(b).to(device=a.device, dtype=torch.float64)
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def psnr(orig, recon) -> float:
    """PSNR = 20·log10((max−min)/RMSE)  (paper footnote 6)."""
    o = _t(orig)
    rng = float(o.max()) - float(o.min())
    r = rmse(o, recon)
    return 20.0 * float(np.log10(rng / r)) if r > 0 else float("inf")


def max_abs_err(orig, recon) -> float:
    o = _t(orig)
    r = _t(recon).to(o.device)
    # repro-lint: allow[host-sync] the metric is a host float by design
    return float(torch.max(torch.abs(o - r)))


def nrmse(orig, recon) -> float:
    o = _t(orig)
    return rmse(o, recon) / (float(o.max()) - float(o.min()))


def bitrate(n_elements: int, compressed_bytes: int) -> float:
    """Bits per element (the x-axis of the paper's rate-distortion plots)."""
    return compressed_bytes * 8.0 / n_elements


def verify_error_bound(orig, recon, eb: float) -> bool:
    """The paper's defining guarantee |d − d•| ≤ eb, up to float32
    representability: the PREQUANT divide and the dequant multiply each
    round once, so the exact bound eb widens by O(|d|·eps32)."""
    # repro-lint: allow[host-sync] verification is host-side by design
    m = max_abs_err(orig, recon)
    amax = float(torch.max(torch.abs(_t(orig))))  # repro-lint: allow[host-sync] verification is host-side
    eps = float(np.finfo(np.float32).eps)
    return bool(m <= eb * (1.0 + 1e-5) + 4.0 * eps * amax
                + float(np.finfo(np.float32).tiny))
