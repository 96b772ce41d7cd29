"""Deterministic synthetic LM data: the reference's noisy bigram stream.

Tokens follow a fixed random permutation table with ε-uniform noise, so
the stream is learnable (the loss falls) yet needs no disk or network.
A batch is a pure function of (seed, step), in numpy, bit for bit the
reference's (`repro.data.pipeline.host_batch`): restarts replay the same
data.  `global_batch` places it on a mesh: every rank builds the same
host batch and keeps only its own slice.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def _bigram_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(vocab).astype(np.int64)


def host_batch(vocab: int, batch: int, seq: int, step: int,
               seed: int = 0, noise: float = 0.2) -> np.ndarray:
    """[batch, seq] int32, deterministic in (seed, step)."""
    table = _bigram_table(vocab, seed)
    rng = np.random.default_rng((seed << 20) ^ step)
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    flips = rng.random((batch, seq)) < noise
    rand = rng.integers(0, vocab, (batch, seq))
    for t in range(1, seq):
        follow = table[toks[:, t - 1]]
        toks[:, t] = np.where(flips[:, t], rand[:, t], follow)
    return toks.astype(np.int32)


def global_batch(mesh, vocab: int, batch: int, seq: int, step: int,
                 seed: int = 0, podded: bool = False):
    """The global [B,S] batch (or [npods, B/npods, S] when `podded`) as a
    DTensor on `mesh`, placed by `sharding.batch_spec`: each rank keeps
    its slice of the deterministic host batch, nothing moves."""
    import torch

    from repro_torch.dist.sharding import NamedSharding, batch_spec, \
        mesh_shape

    full = host_batch(vocab, batch, seq, step, seed)
    if podded:
        npods = mesh_shape(mesh)["pod"]
        full = full.reshape(npods, batch // npods, seq)
    t = torch.from_numpy(full).to(mesh.device_type)
    return NamedSharding(mesh, batch_spec(mesh, podded)).place(t)
