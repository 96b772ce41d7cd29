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


def param_specs(tree: Any, mesh, *, fsdp: bool = False) -> Any:
    """A `P` tree mirroring `tree` (params, opt state, grads; meta
    tensors where only the shapes exist).  Only the mesh's axis sizes are
    read."""
    shape_of_mesh = mesh_shape(mesh)
    specs = [_leaf_spec(path, leaf, shape_of_mesh, fsdp)
             for path, leaf in leaves_with_path(tree)]
    return rebuild(tree, iter(specs))


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
