"""Plain PyTorch version of the histogram kernel."""
from __future__ import annotations

import torch


def histogram_ref(codes: torch.Tensor, nbins: int) -> torch.Tensor:
    """int32 counts per bin; codes outside [0, nbins) are not counted."""
    flat = codes.reshape(-1).long()
    # out-of-range codes land in a spill bin that is cut off
    slot = torch.where((flat >= 0) & (flat < nbins), flat, nbins)
    counts = torch.zeros(nbins + 1, dtype=torch.int64, device=codes.device)
    counts.scatter_add_(0, slot, torch.ones_like(slot))
    return counts[:nbins].to(torch.int32)
