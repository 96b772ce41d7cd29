"""Synthetic SDRBench-like fields (paper Table 2 stand-ins).

A numpy copy of the reference's generator, byte-identical to it: smooth
large-scale structure + localized features + (for HACC) particle-like
low-coherence series, plus heavy zero-concentration variants (paper
Table 9: CLOUDf48 / QSNOWf48 / baryon_density are ~89-99% within ±eb of
0/min).

`_smooth`, `cesm_like` and `nyx_like` also take `device=`: the same
numpy-drawn parameters, evaluated with torch on that device.  That path
makes the paper-size fields (e.g. NYX 512³) in seconds on a card; it is
not byte-identical to the numpy path (the sine is another
implementation).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _grids(shape, rng):
    axes = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    return np.meshgrid(*axes, indexing="ij")


def _smooth_torch(shape, rng, octaves, scale, device):
    nd = len(shape)
    grids = []
    for d, s in enumerate(shape):
        g = torch.from_numpy(np.linspace(0.0, 1.0, s, dtype=np.float32))
        view = [1] * nd
        view[d] = s
        grids.append(g.to(device).reshape(view))
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    amp = 1.0
    for o in range(octaves):
        k = scale * (2.0 ** o)
        nfeat = 6
        w = rng.standard_normal((nfeat, nd)).astype(np.float32) * k
        ph = rng.uniform(0, 2 * np.pi, nfeat).astype(np.float32)
        a = rng.standard_normal(nfeat).astype(np.float32) * amp
        for i in range(nfeat):
            arg = torch.full((1,) * nd, float(ph[i]), device=device)
            for d, g in enumerate(grids):
                arg = arg + float(w[i, d]) * g
            out += float(a[i]) * torch.sin(arg)
        amp *= 0.5
    return out


def _smooth(shape, rng, octaves=4, scale=8.0, device=None):
    """Band-limited random field via random Fourier features (cheap Perlin
    stand-in, fully vectorized).  numpy unless `device` is given."""
    if device is not None:
        return _smooth_torch(shape, rng, octaves, scale, device)
    grids = _grids(shape, rng)
    out = np.zeros(shape, np.float32)
    amp = 1.0
    for o in range(octaves):
        k = scale * (2.0 ** o)
        nfeat = 6
        w = rng.standard_normal((nfeat, len(shape))).astype(np.float32) * k
        ph = rng.uniform(0, 2 * np.pi, nfeat).astype(np.float32)
        a = rng.standard_normal(nfeat).astype(np.float32) * amp
        acc = np.zeros(shape, np.float32)
        for i in range(nfeat):
            arg = ph[i]
            for d, g in enumerate(grids):
                arg = arg + w[i, d] * g
            acc += a[i] * np.sin(arg)
        out += acc
        amp *= 0.5
    return out


def hacc_like(n: int = 1 << 21, seed: int = 0) -> np.ndarray:
    """1D particle coordinates: sorted-by-cell positions => locally smooth
    with jumps (matches HACC X/VX compressibility profile)."""
    rng = np.random.default_rng(seed)
    ncell = max(1, n // 256)
    cell = np.repeat(np.sort(rng.uniform(0, 256.0, ncell)).astype(np.float32),
                     -(-n // ncell))[:n]
    jitter = rng.normal(0, 0.05, n).astype(np.float32)
    return cell + jitter


def cesm_like(shape: Tuple[int, int] = (450, 900), seed: int = 1,
              device: Optional[torch.device] = None):
    """2D climate field, smooth with zonal structure (CESM-ATM CLDHGH)."""
    rng = np.random.default_rng(seed)
    base = _smooth(shape, rng, octaves=5, scale=4.0, device=device)
    lat = np.cos(np.linspace(-np.pi / 2, np.pi / 2, shape[0],
                             dtype=np.float32))
    if device is not None:
        f = base * torch.from_numpy(lat).to(device)[:, None]
        return torch.sigmoid(f)
    f = base * lat[:, None]
    f = 1.0 / (1.0 + np.exp(-f))            # cloud-fraction-like in [0,1]
    return f.astype(np.float32)


def hurricane_like(shape: Tuple[int, int, int] = (50, 250, 250),
                   seed: int = 2, zero_concentrated: bool = False
                   ) -> np.ndarray:
    """3D storm field; `zero_concentrated=True` mimics CLOUDf48/QSNOWf48
    (~89% of points within eb of 0, paper Table 9)."""
    rng = np.random.default_rng(seed)
    f = _smooth(shape, rng, octaves=4, scale=3.0)
    if zero_concentrated:
        f = np.maximum(f - np.quantile(f, 0.89), 0.0) ** 2
        f = f / max(f.max(), 1e-9) * 2.05e-3      # CLOUDf48 range
    return f.astype(np.float32)


def nyx_like(shape: Tuple[int, int, int] = (128, 128, 128),
             seed: int = 3, log_density: bool = True,
             device: Optional[torch.device] = None):
    """3D cosmology baryon_density: lognormal with huge dynamic range and
    concentration near the minimum (paper Table 9)."""
    rng = np.random.default_rng(seed)
    g = _smooth(shape, rng, octaves=5, scale=4.0, device=device)
    if device is not None:
        return torch.exp(2.5 * g)
    f = np.exp(2.5 * g).astype(np.float32)        # heavy right tail
    return f


def qmcpack_like(shape: Tuple[int, int, int, int] = (48, 36, 36, 36),
                 seed: int = 4) -> np.ndarray:
    """4D einspline orbitals: smooth oscillatory per leading index."""
    out = np.stack([_smooth(shape[1:], np.random.default_rng(seed + i),
                            octaves=3, scale=2.0 + 0.25 * i)
                    for i in range(shape[0])])
    return out.astype(np.float32)


def all_fields(small: bool = True, seed: int = 0) -> Dict[str, np.ndarray]:
    """The five-dataset suite used across tests/benchmarks."""
    s = 1 if small else 4
    return {
        "hacc": hacc_like(n=(1 << 18) * s, seed=seed),
        "cesm": cesm_like((225 * s, 450 * s), seed=seed + 1),
        "hurricane": hurricane_like((25 * s, 125 * s, 125 * s), seed=seed + 2),
        "hurricane_cloud": hurricane_like((25 * s, 125 * s, 125 * s),
                                          seed=seed + 2,
                                          zero_concentrated=True),
        "nyx": nyx_like((64 * s,) * 3, seed=seed + 3),
        "qmcpack": qmcpack_like((12 * s, 24, 24, 24), seed=seed + 4),
    }
