"""Mesh and spec context: sharding hints that are the identity off-mesh.

The reference's `repro.dist.context`.  Model, train and serve code call
``constrain(...)`` / ``constrain_like_params(...)`` unconditionally;
whether they redistribute or do nothing is decided by the dynamically
scoped context the launcher or a test installs:

    with use_mesh(mesh), use_param_specs(specs):
        loss, params, opt = step(params, opt, tokens)

On a mesh, tensors are DTensors: parameters placed by
`sharding.param_shardings`, activations derived from them.
``constrain(x, *spec)`` resolves the spec against the mesh and returns
``x.redistribute(mesh, placements)``: the values stay, only where they
live changes (the reference's ``with_sharding_constraint``).  Off-mesh it
returns `x`.

Spec mini-language: each element is a mesh axis name, a tuple of axis
names, None (replicated), or ``"dp"``, which expands to the current
data-parallel axes: ``("pod", "data")`` on a multi-pod mesh, or what
``dp_axes_override`` pins (the train step pins ``("data",)`` while a
pod's grads run on the sub-mesh ``mesh["data", "model"]``).  An axis the
mesh lacks is dropped, a dim whose size does not divide its axes is
replicated, and elements beyond the tensor's rank are replicated, as in
``sharding.param_specs``.

The compression hooks arm a codec by registry name.  The weight-gather
(``use_weight_compress``) and all-to-all (``use_a2a_compress``) hooks act
only on a mesh, as in the reference; the elastic-restore hook
(``use_restore_compress``) re-encodes raw leaves on the way into
``io.checkpoint.load_checkpoint``.  The serve hooks
(``use_kv_reshard_compress``, ``use_kv_evict_codec``) arm the
prefill->decode handoff wire and the paged pool's eviction codec.  Every
hook is validated when armed and scoped: the previous state returns on
exit, also on an exception, so contexts nest.  State is process-global,
one mesh program at a time.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.dist.sharding import (P, NamedSharding, mesh_shape,
                                       placements)
from repro_torch.dist.sharding import dp_axes as _mesh_dp_axes
from repro_torch.tree import tree_map

_mesh_stack: List[Any] = []
_spec_stack: List[Any] = []
_restore_compress_stack: List[Optional[str]] = []
_kv_reshard_stack: List[Optional[str]] = []
_a2a_compress_stack: List[Optional[str]] = []
_kv_evict_stack: List[Optional[str]] = []
_dp_override_stack: List[Tuple[str, ...]] = []
_weight_compress_stack: List[Optional[str]] = []

#: codec a bare ``True`` arms
_DEFAULT_WIRE_CODEC = "int8-block"
#: whole-slab wires the KV hooks accept besides blockwise codecs
_WHOLE_SLAB_WIRES = ("cusz", "fz", "lossless")


@contextmanager
def _pushed(stack: List[Any], value: Any):
    stack.append(value)
    try:
        yield value
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# mesh + param specs
# ---------------------------------------------------------------------------

def use_mesh(mesh):
    """Install `mesh` (a named ``DeviceMesh``) as the current mesh for the
    dynamic extent."""
    return _pushed(_mesh_stack, mesh)


def current_mesh():
    return _mesh_stack[-1] if _mesh_stack else None


def use_param_specs(specs):
    """Install the parameter spec tree (from ``sharding.param_specs``)
    read by ``constrain_like_params`` and the weight-gather hook."""
    return _pushed(_spec_stack, specs)


def current_param_specs():
    return _spec_stack[-1] if _spec_stack else None


def dp_axes_override(axes: Tuple[str, ...]):
    """Override what ``"dp"`` resolves to (the train step pins
    ``("data",)`` while one pod's grads run on the pod's sub-mesh)."""
    return _pushed(_dp_override_stack, tuple(axes))


def current_dp_axes() -> Optional[Tuple[str, ...]]:
    """The data-parallel axes: the innermost override, else the mesh's
    (None off-mesh)."""
    if _dp_override_stack:
        return _dp_override_stack[-1]
    mesh = current_mesh()
    return _mesh_dp_axes(mesh) if mesh is not None else None


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------

def _resolve_spec(spec_elems, shape, mesh) -> P:
    """A spec in the mini-language -> a `P` of the mesh's axes for a
    tensor of `shape`."""
    shape_of_mesh = mesh_shape(mesh)
    resolved: list = []
    for el in spec_elems:
        if el == "dp":
            axes = current_dp_axes() or ()
            axes = tuple(a for a in axes if a in shape_of_mesh)
            el = axes if axes else None
        resolved.append(el)
    for i, el in enumerate(resolved):
        if el is None:
            continue
        if i >= len(shape):
            resolved[i] = None            # over-rank element: replicate
            continue
        axes = tuple(a for a in (el if isinstance(el, (tuple, list))
                                 else (el,)) if a in shape_of_mesh)
        size = math.prod(int(shape_of_mesh[a]) for a in axes)
        if not axes or shape[i] % size != 0:
            resolved[i] = None            # divisibility fallback: replicate
        else:                             # axes absent from the mesh dropped
            resolved[i] = axes if isinstance(el, (tuple, list)) else el
    while resolved and resolved[-1] is None:
        resolved.pop()
    return P(*resolved)


def _redistribute(x, mesh, spec: P):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError("constrain under a mesh takes a DTensor (place the "
                        "tensor on the mesh first); got a "
                        f"{type(x).__name__}")
    if x.device_mesh != mesh:
        raise ValueError(f"the tensor lives on {x.device_mesh}, the current "
                         f"mesh is {mesh}")
    pl = placements(spec, mesh, x.dim())
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


_mesh_compute_depth = [0]


@contextmanager
def mesh_compute():
    """The context a mesh computation runs in: off-mesh none; on a mesh
    ``implicit_replication``, which takes a plain tensor met in a DTensor
    op as replicated.  Exact for the tensors the model makes from shapes
    alone (positions, masks, RoPE tables, zeros): every rank makes the
    same.  Nests (``implicit_replication`` itself turns off on any exit,
    also an inner one's)."""
    if current_mesh() is None or _mesh_compute_depth[0]:
        _mesh_compute_depth[0] += 1
        try:
            yield
        finally:
            _mesh_compute_depth[0] -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _mesh_compute_depth[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _mesh_compute_depth[0] -= 1


def constrain(x, *spec_elems):
    """`x` redistributed to the spec under the current mesh; `x` itself
    off-mesh.  `spec_elems` use the module's spec mini-language."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _redistribute(x, mesh, _resolve_spec(spec_elems, tuple(x.shape),
                                                mesh))


def constrain_like_params(tree, lead_axis: Optional[str] = None):
    """Constrain a param-shaped tree (gradients, accumulators) with the
    installed param specs.  `lead_axis` prepends a mesh axis for trees
    with one extra leading dim.  The identity when either the mesh or the
    specs are absent."""
    mesh = current_mesh()
    specs = current_param_specs()
    if mesh is None or specs is None:
        return tree

    def one(leaf, spec):
        elems = tuple(spec)
        if lead_axis is not None:
            elems = (lead_axis,) + elems
        return _redistribute(leaf, mesh, _resolve_spec(
            elems, tuple(leaf.shape), mesh))

    return tree_map(one, tree, specs)


def sum_over_group(x, group):
    """The sum over the process group `group` of every rank's `x`, with
    the identity as its gradient: the summed value is the same on every
    rank, so each rank's share of the loss gradient is the gradient
    itself (the row-parallel reduction of a sharded contraction, or of
    per-rank partial losses)."""
    return _SumOverGroup.apply(x, group)


class _SumOverGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def resolve_sharding(mesh, shape, *spec_elems) -> NamedSharding:
    """The spec mini-language resolved for host-side placement: the same
    rules as ``constrain`` (``"dp"`` expansion, absent axes dropped,
    divisibility fallback), returning the `NamedSharding` to place a
    tensor with.  The serve reshard places adopted cache payloads under
    the decode mesh with it."""
    return NamedSharding(mesh, _resolve_spec(spec_elems, tuple(shape), mesh))


def _drop_lead(spec: P) -> P:
    elems = tuple(spec)
    return P(*elems[1:]) if elems else P()


def weight_gather_info():
    """When weight compression is armed on a mesh with param specs
    installed: ``(specs_tuple, mesh)``, where ``specs_tuple`` aligns with
    ``tuple(params["layers"])`` as one period sees it (the leading period
    dim stripped from every leaf spec).  Otherwise None, and the model
    runs its plain path."""
    if weight_compress_codec() is None:
        return None
    mesh = current_mesh()
    specs = current_param_specs()
    if mesh is None or specs is None:
        return None
    try:
        layer_specs = specs["layers"]
    except (TypeError, KeyError):
        return None
    return tuple(tree_map(_drop_lead, ls) for ls in layer_specs), mesh


# ---------------------------------------------------------------------------
# compression hooks.  Each arms a codec by registry name: True selects the
# default wire codec, False/None/"none" disarm.
# ---------------------------------------------------------------------------

def _codec_name(active) -> Optional[str]:
    """A hook argument as a registry name: True arms the default wire
    codec, False/None/"none" disarm, the legacy mode "int8" means the
    blockwise codec, anything else must be a registered codec id."""
    if active is True:
        return _DEFAULT_WIRE_CODEC
    if not active or active == "none":
        return None
    if active == "int8":
        return _DEFAULT_WIRE_CODEC
    from repro_torch import codecs
    name = str(active)
    if name not in codecs.names():
        raise ValueError(f"unknown compression codec {name!r}; "
                         f"registered: {codecs.names()}")
    return name


def use_a2a_compress(active):
    """Arm compressed MoE dispatch/combine resharding (read via
    ``a2a_compress_active`` inside ``moe_forward``).  `active`: bool or a
    codec registry name, validated here."""
    return _pushed(_a2a_compress_stack, _codec_name(active))


def a2a_compress_active() -> bool:
    """True only when armed AND under a mesh (the reference's rule)."""
    return bool(_a2a_compress_stack and _a2a_compress_stack[-1]
                and current_mesh() is not None)


def a2a_codec() -> Optional[str]:
    """Registry name of the armed all-to-all wire codec (None = off)."""
    return _a2a_compress_stack[-1] if a2a_compress_active() else None


def use_weight_compress(active):
    """Arm the FSDP weight-gather compression hook.  `active`: bool or a
    codec registry name ("int8" = "int8-block"), validated here.  Off-mesh
    the hook is never consulted (``weight_gather_info`` is None)."""
    return _pushed(_weight_compress_stack, _codec_name(active))


def weight_compress_codec() -> Optional[str]:
    """Registry name of the armed weight-gather codec (None = off)."""
    if not (_weight_compress_stack and _weight_compress_stack[-1]):
        return None
    return _weight_compress_stack[-1]


def use_restore_compress(active):
    """Arm the elastic-restore wire codec: during ``load_checkpoint``, raw
    (lossless-stored) float leaves are re-encoded through this blockwise
    codec for the move onto their placement, the narrow payload the MoE
    all-to-all also moves.  Lossy (eb = scale/2); leaves stored
    compressed already move as containers and are never re-encoded.
    `active`: bool or a blockwise codec registry name, validated here."""
    name = _codec_name(active)
    if name is not None:
        from repro_torch import codecs
        codecs.get_block_codec(name, axis=0, block=8)
    return _pushed(_restore_compress_stack, name)


def restore_codec() -> Optional[str]:
    """Registry name of the armed elastic-restore wire codec (None = off,
    the default: a restore is bit-exact with the stored containers)."""
    return _restore_compress_stack[-1] if _restore_compress_stack else None


def _kv_hook_name(active) -> Optional[str]:
    """Arm-time validation shared by the two KV hooks: an id that is
    neither blockwise-configurable nor a whole-slab wire fails here, not
    mid-handoff or mid-eviction."""
    name = _codec_name(active)
    if name is not None and name not in _WHOLE_SLAB_WIRES:
        from repro_torch import codecs
        codecs.get_block_codec(name, axis=0, block=8)
    return name


def use_kv_reshard_compress(active):
    """Arm the prefill->decode KV-cache reshard wire codec read by
    ``serve.engine.encode_handoff``.  `active`: True (= "int8-block"),
    False/"none" (an explicit disarm, which resolves to the "lossless"
    raw-bytes wire) or a registry name: a blockwise codec
    ("int8-block") or a whole-slab wire ("cusz", "fz", "lossless")."""
    return _pushed(_kv_reshard_stack, _kv_hook_name(active))


def kv_reshard_codec() -> Optional[str]:
    """The armed reshard wire codec.  None = nothing armed (the handoff
    uses its "int8-block" default); an explicit disarm resolves to
    "lossless": the handoff always needs a wire, and "off" means raw
    bytes, never a silent fall-through to a lossy codec."""
    if not _kv_reshard_stack:
        return None
    return _kv_reshard_stack[-1] or "lossless"


def use_kv_evict_codec(active):
    """Arm the paged-pool eviction codec read by
    ``serve.pool.PagedKVPool``.  `active`: True (= "int8-block", payload
    pass-through, bit-exact restore), False/"none" (an explicit disarm,
    which resolves to "int8-block") or a registry name ("int8-block",
    "cusz", "fz", "lossless")."""
    return _pushed(_kv_evict_stack, _kv_hook_name(active))


def kv_evict_codec() -> Optional[str]:
    """The armed pool-eviction codec.  None = nothing armed (the pool
    uses its own default); an explicit disarm resolves to "int8-block":
    eviction always needs a host form, and "off" means the bit-exact
    payload pack."""
    if not _kv_evict_stack:
        return None
    return _kv_evict_stack[-1] or "int8-block"
