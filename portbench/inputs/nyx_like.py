"""NYX-like baryon density snapshots, made on the device.

A frozen copy of the device path of `repro_torch.data.scidata.nyx_like`
(random Fourier features of a few octaves, then `exp(2.5 g)`: lognormal,
a heavy right tail and most values near the minimum).  It is copied so
that the benchmark's inputs do not move when the program's data module
does.

Snapshot `i` of the run of `seed` draws its features from the seed
sequence (seed, i), so every run compresses fields no run had before.
One difference from scidata: `g` is scaled to the standard deviation
`g_std` before the exponential.  Unscaled, its spread is a sum of a few
squared normal amplitudes and differs by a factor of two between draws,
and the value-relative bound, which follows the field's range, with it.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _smooth(shape, rng, octaves, scale, device):
    """Band-limited random field via random Fourier features."""
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


def log_field(shape: Sequence[int], rng, device) -> torch.Tensor:
    """`g` of `scidata.nyx_like`: the field is `exp(2.5 g)`."""
    return _smooth(tuple(shape), rng, octaves=5, scale=4.0, device=device)


def field(shape: Sequence[int], seed: int, i: int, g_std: float, device
          ) -> torch.Tensor:
    """Snapshot `i` of the run of `seed`."""
    g = log_field(shape, np.random.default_rng([seed, i]), device)
    g *= g_std / float(g.std())
    return torch.exp(2.5 * g)


def snapshots(config: dict, seed: int, device) -> List[torch.Tensor]:
    p = config["generator_params"]
    return [field(config["shape"], seed, i, p["g_std"], device)
            for i in range(p["snapshots"])]
