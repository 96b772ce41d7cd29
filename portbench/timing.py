"""Timing helpers on the card."""
from __future__ import annotations

import torch


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copy_bytes_per_s(x: torch.Tensor, reps: int = 10) -> float:
    """The card's read + write rate on a copy of `x` (a field several
    times the L2): the bandwidth the card gives today, beside the
    published peak."""
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x), reps)
    return 2 * x.numel() * x.element_size() / (ms * 1e-3)
