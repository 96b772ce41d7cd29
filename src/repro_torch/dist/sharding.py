"""Shard planning shared by the split-stable codecs and the checkpoint
writer (the port's copy of `even_shard_axis`)."""
from __future__ import annotations

from typing import Optional, Sequence


def even_shard_axis(shape: Sequence[int], nshards: int,
                    multiple_of: int = 1) -> Optional[int]:
    """Largest dim splittable into `nshards` equal slices whose lengths
    stay a multiple of `multiple_of` (codec block alignment), or None.
    The per-host checkpoint writer uses this to plan tensor splits."""
    if nshards <= 1:
        return None
    best = None
    for i, s in enumerate(shape):
        s = int(s)
        if s % nshards == 0 and (s // nshards) % multiple_of == 0 and s > 0:
            if best is None or s > int(shape[best]):
                best = i
    return best
