"""The assigned input-shape set (same 4 shapes for every LM arch).

``train_*`` lowers train_step; ``prefill_*`` lowers the prefill forward;
``decode_*`` / ``long_*`` lower serve_step (one new token against a KV
cache of seq_len).  ``long_500k`` runs only for sub-quadratic archs
(SSM/hybrid) — skips are recorded per arch in DESIGN.md §7.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    needs_sub_quadratic: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           needs_sub_quadratic=True),
}


def applicable(shape: ShapeSpec, cfg) -> bool:
    if shape.needs_sub_quadratic and not cfg.sub_quadratic:
        return False
    return True
