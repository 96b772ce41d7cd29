"""HACC-like particle coordinates, made on the device.

The construction of `repro_torch.data.scidata.hacc_like`: cell positions
drawn uniform in [0, 256), sorted and each repeated over its share of
the particles, plus N(0, 0.05) jitter, so the series is locally smooth
with jumps.  The draws come from a seeded `torch.Generator` on the
device, in float64 as numpy draws them, so the field is made in a few
large calls and never crosses the host.  Snapshot `i` of the run of
`seed` draws from the seed sequence (seed, i).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def construct(u: torch.Tensor, z: torch.Tensor, n: int) -> torch.Tensor:
    """The field from float64 draws: `u` uniform in [0, 1) (one per
    cell) and `z` standard normal (one per particle)."""
    ncell = u.numel()
    cell = torch.sort(u * 256.0).values.to(torch.float32)
    cell = cell.repeat_interleave(-(-n // ncell))[:n]
    return cell + (z * 0.05).to(torch.float32)


def field(n: int, seed: int, i: int, device) -> torch.Tensor:
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]))
    ncell = max(1, n // 256)
    u = torch.rand(ncell, dtype=torch.float64, generator=g, device=device)
    z = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    return construct(u, z, n)


def snapshots(config: dict, seed: int, device) -> List[torch.Tensor]:
    (n,) = config["shape"]
    return [field(n, seed, i, device)
            for i in range(config["generator_params"]["snapshots"])]
