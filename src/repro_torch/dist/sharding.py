"""Sharding rules: a tree of tensors -> a tree of specs, and specs ->
DTensor placements.

The reference's `repro.dist.sharding`.  One rule engine covers params,
optimizer moments (which mirror the param tree under ``AdamWState.m/.v``,
including int8 ``QTensor`` leaves whose ``q``/``scale`` inherit the parent
weight's rule) and gradients.  Rules are keyed on the nearest recognized
trailing name in the tree path plus the leaf shape, so trees that mirror
each other get identical specs.

The tensor-parallel axis is ``"model"`` (attention heads, MoE experts, MLP
ff); a dim that does not divide the mesh axis is left replicated.
``fsdp=True`` also shards the largest remaining dim over ``"data"`` (the
ZeRO-3 layout, which the int8 weight gather in `core.weights` keys off).

A spec is a `P` (the reference's ``PartitionSpec``): one element per
leading tensor dim, each an axis name, a tuple of axis names, or None;
missing trailing elements are None.  `placements` turns it into the
``Shard(d)`` / ``Replicate()`` list of a mesh, one entry per mesh dim,
and `NamedSharding` pairs the two, as ``jax.sharding.NamedSharding``
does.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Optional, Sequence, Tuple

from repro_torch.tree import leaves_with_path, rebuild, tree_map

# tiny / numerically sensitive leaves stay replicated
_SKIP_SUBSTR = ("norm",)

# preferred model-sharded dim per trailing param name (negative indices so
# the rule transfers to QTensor ``scale`` leaves whose last dim shrinks)
_MODEL_DIM = {
    # GQA/MQA attention: shard heads
    "wq": -2, "wk": -2, "wv": -2, "bq": -2, "bk": -2, "bv": -2, "wo": -3,
    # MLA: shard heads of the up-projections; latent projections replicate
    "wq_b": -2, "wk_b": -2, "wv_b": -2, "wq_a": -1, "wkv_a": None,
    # dense MLP: shard ff
    "w_up": -1, "w_gate": -1, "w_down": -2,
    # MoE router: shard experts
    "router": -1,
    # Mamba2: shard the expanded inner dim
    "in_proj": -1, "out_proj": -2,
    "conv_w": None, "conv_b": None, "A_log": None, "D": None,
    "dt_bias": None,
    # embeddings: shard vocab; lm_head shards vocab too
    "embed": 0, "lm_head": -1,
}
# 4D (stacked) MoE expert weights shard the expert dim over 'model' (EP)
_MOE_EXPERT_LEAVES = ("w_up", "w_gate", "w_down", "router")


def _norm_elem(e):
    """One spec element as JAX normalizes it: a list is a tuple, and a
    one-axis tuple is that axis."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: the reference's ``PartitionSpec``.  Not a tuple,
    so that the tree walkers take it as one leaf; it iterates, indexes
    and compares equal to the tuple of its elements."""

    __slots__ = ("_elems",)

    def __init__(self, *elems):
        self._elems = tuple(_norm_elem(e) for e in elems)

    def __iter__(self):
        return iter(self._elems)

    def __len__(self):
        return len(self._elems)

    def __getitem__(self, i):
        return self._elems[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._elems == other._elems
        if isinstance(other, tuple):
            return self._elems == other
        return NotImplemented

    def __hash__(self):
        return hash(self._elems)

    def __repr__(self):
        return f"P{self._elems!r}"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of a stand-in whose ``.shape``
    is already that dict (the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _key_name(k) -> str:
    """A path key as the reference names it: NamedTuple fields without
    the leading dot the port's tree keys carry."""
    k = str(k)
    return k[1:] if k.startswith(".") else k


def _axis_size(shape_of_mesh, axis) -> int:
    return int(shape_of_mesh.get(axis, 1))


def _model_dim(names: Sequence[str], ndim: int) -> Optional[int]:
    """Preferred 'model' dim for a leaf, or None (replicate)."""
    if any(s in n for n in names for s in _SKIP_SUBSTR):
        return None
    known = next((n for n in reversed(names) if n in _MODEL_DIM), None)
    if known is None:
        return None
    if known in _MOE_EXPERT_LEAVES and "moe" in names and \
            "shared" not in names and ndim >= 4:
        return 1                          # [nP, E, ...]: expert parallelism
    d = _MODEL_DIM[known]
    if d is None or not (-ndim <= d < ndim):
        return None
    return d % ndim


def _leaf_spec(path, leaf, shape_of_mesh, fsdp: bool) -> P:
    names = [_key_name(k) for k in path]
    shape = tuple(int(s) for s in leaf.shape)
    ndim = len(shape)
    if ndim == 0:
        return P()
    size = 1
    for s in shape:
        size *= s
    assign: list = [None] * ndim
    msz = _axis_size(shape_of_mesh, "model")
    md = _model_dim(names, ndim)
    if md is not None and shape[md] % msz == 0:
        assign[md] = "model"
    if fsdp and not any(s in n for n in names for s in _SKIP_SUBSTR):
        dsz = _axis_size(shape_of_mesh, "data")
        in_layers = "layers" in names
        cands = [j for j in range(ndim)
                 if assign[j] is None and shape[j] % dsz == 0
                 and shape[j] >= dsz and not (in_layers and j == 0)]
        if cands and size >= 4096:
            j = max(cands, key=lambda j: shape[j])
            assign[j] = "data"
    while assign and assign[-1] is None:
        assign.pop()
    return P(*assign)


#: int8 AdamW moments: values per f32 scale along the last dim
#: (`optim.adamw.QBLOCK`)
MOMENT_BLOCK = 128


def _axes(el) -> Tuple[str, ...]:
    if el is None:
        return ()
    return tuple(el) if isinstance(el, tuple) else (el,)


def quantized_moment_spec(spec, shape, shape_of_mesh) -> P:
    """Where the port keeps an int8 AdamW moment (`QTensor` ``q`` and
    ``scale`` alike) of a parameter placed by `spec`.

    Each rank quantizes its own shard in blocks of `MOMENT_BLOCK` along
    the last dim, which are the global array's blocks only when the
    shard's last dim is a whole number of blocks.  So the parameter's
    spec is kept unless it splits the last dim into shards that are not;
    then each axis of the last dim moves to the largest other dim that
    no axis shards yet and that it divides, or, with none, leaves the
    moment (it is then replicated over that axis).  The reference
    quantizes the global array and places ``q`` and ``scale`` by their
    own shapes; the codes and scales are the same, only where they live
    differs."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    elems = list(spec) + [None] * (ndim - len(spec))
    if ndim == 0:
        return P()
    last = _axes(elems[-1])
    k = math.prod(_axis_size(shape_of_mesh, a) for a in last)
    if not last or (shape[-1] // k) % MOMENT_BLOCK == 0:
        return P(*spec)
    elems[-1] = None
    for ax in last:
        size = _axis_size(shape_of_mesh, ax)
        free = [j for j in range(ndim - 1)
                if elems[j] is None and shape[j] % size == 0]
        if free:
            elems[max(free, key=lambda j: shape[j])] = ax
    while elems and elems[-1] is None:
        elems.pop()
    return P(*elems)


def _is_qtensor_field(path) -> bool:
    return bool(path) and str(path[-1]) in (".q", ".scale")


def param_specs(tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """A `P` tree mirroring `tree` (params, opt state, grads; meta
    tensors where only the shapes exist).  Only the mesh's axis sizes are
    read.  An int8 moment's ``q`` and ``scale`` both take
    `quantized_moment_spec` of its parameter's spec (the port's one
    departure from the reference's specs)."""
    shape_of_mesh = mesh_shape(mesh)
    specs = []
    for path, leaf in leaves_with_path(tree):
        if not _is_qtensor_field(path):
            specs.append(_leaf_spec(path, leaf, shape_of_mesh, fsdp))
            continue
        shape = tuple(int(s) for s in leaf.shape)
        if str(path[-1]) == ".scale":
            shape = shape[:-1] + (shape[-1] * MOMENT_BLOCK,)
        q = SimpleNamespace(shape=shape)
        specs.append(quantized_moment_spec(
            _leaf_spec(path[:-1], q, shape_of_mesh, fsdp), shape,
            shape_of_mesh))
    return rebuild(tree, iter(specs))


def spec_of(t) -> P:
    """The `P` of a DTensor's placements on its mesh (the inverse of
    `placements`); a plain tensor is `P()`."""
    from torch.distributed.tensor import Shard

    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return P()
    per_dim: list = [[] for _ in range(t.dim())]
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            per_dim[pl.dim].append(name)
    elems = [None if not a else (a[0] if len(a) == 1 else tuple(a))
             for a in per_dim]
    while elems and elems[-1] is None:
        elems.pop()
    return P(*elems)


def cache_spec(path, shape, shape_of_mesh, dp, long_ctx: bool) -> P:
    """The reference dry run's decode / prefill cache layout
    (``_cache_shard_rule``): batch over the data-parallel axes `dp`;
    GQA K/V [nP, B, S, KV, hd] and MLA latents [nP, B, S, R] with the
    sequence over "model" (over "data", batch unsplit, for a long
    context); a Mamba state [nP, B, H, N, P] with its heads and its
    conv tail [nP, B, K-1, C] with its channels over "model" where they
    divide.  The Mamba leaves are found by their names (``conv``, ``h``)
    in the path."""
    names = [_key_name(k) for k in path]
    ndim = len(shape)
    msz = _axis_size(shape_of_mesh, "model")
    rows = None if long_ctx else dp
    if "conv" in names:
        return P(None, rows, None,
                 "model" if shape[-1] % msz == 0 else None)
    if "h" in names:
        return P(None, rows, "model" if shape[2] % msz == 0 else None,
                 None, None)
    seq = "data" if long_ctx else "model"
    if ndim == 4:
        return P(None, rows, seq, None)
    return P(None, rows, seq, None, None)


def cache_specs(caches: Any, mesh, long_ctx: bool = False) -> Any:
    """`cache_spec` over a cache tree (a `DecodeCaches`, its QuantKV
    leaves included) on `mesh`."""
    shape_of_mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    specs = [cache_spec(path, tuple(int(s) for s in leaf.shape),
                        shape_of_mesh, dp, long_ctx)
             for path, leaf in leaves_with_path(caches)]
    return rebuild(caches, iter(specs))


def placements(spec, mesh, ndim: Optional[int] = None):
    """The DTensor placements of `spec` on `mesh`: one per mesh dim,
    ``Shard(d)`` where tensor dim d names that axis, else ``Replicate()``.
    A dim sharded over several axes names them in mesh order (the
    reference's major-to-minor order); an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    elems = tuple(spec)
    if ndim is not None and len(elems) > ndim:
        raise ValueError(f"spec {spec} has more elements than the "
                         f"tensor's {ndim} dims")
    for d, el in enumerate(elems):
        if el is None:
            continue
        axes = tuple(el) if isinstance(el, tuple) else (el,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec} names an axis the mesh "
                             f"{names} lacks")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of one dim must come "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


class NamedSharding:
    """A mesh and a spec: where a tensor lives (the reference's
    ``jax.sharding.NamedSharding``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def placements(self, ndim: Optional[int] = None):
        return placements(self.spec, self.mesh, ndim)

    def place(self, t):
        """`t` (the same whole tensor on every rank) as a DTensor with
        this sharding: each rank keeps its own slice, nothing moves.  A
        DTensor is redistributed instead."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        pl = self.placements(t.dim())
        if isinstance(t, DTensor):
            if t.device_mesh == self.mesh:
                return t.redistribute(self.mesh, pl)
            t = t.full_tensor()          # another mesh: gather, re-slice
        return distribute_tensor(t, self.mesh, pl, src_data_rank=None)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def param_shardings(tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """A `NamedSharding` tree for `place` (the reference's
    ``jax.device_put`` target)."""
    return tree_map(lambda sp: NamedSharding(mesh, sp),
                    param_specs(tree, mesh, fsdp=fsdp))


def place(tree: Any, shardings: Any) -> Any:
    """`tree`'s tensors as DTensors placed by the same-structured
    `shardings` tree."""
    return tree_map(lambda t, sh: sh.place(t), tree, shardings)


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


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry data parallelism for the batch dim."""
    shape_of_mesh = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape_of_mesh)


def batch_spec(mesh, podded: bool = False) -> P:
    """Global-batch spec: [B, S] over the dp axes, or the compressed-
    gradient layout [npods, B/npods, S]."""
    if podded:
        return P("pod", "data", None)
    axes = dp_axes(mesh)
    return P(axes if axes else None, None)


def place_extra(extra, mesh, podded: bool = False):
    """The modality inputs (``patch_embeds`` [B, P, D], ``frame_embeds``
    [B, S, D]) placed by rows as the reference's dry run places them:
    over the data-parallel axes, or, in the podded layout
    [npods, B/npods, ...], over ("pod", "data").  DTensors pass."""
    from torch.distributed.tensor import DTensor

    if not extra:
        return None
    spec = P("pod", "data") if podded else P(dp_axes(mesh) or None)
    return {k: a if isinstance(a, DTensor) else
            NamedSharding(mesh, spec).place(a) for k, a in extra.items()}
