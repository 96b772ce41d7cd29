"""Distribution context: the single-process surface of the reference's
`repro.dist.context` that the model and serve modules consult.

The port has no meshes yet, so ``current_mesh()`` is always None,
``constrain`` is the identity, ``weight_gather_info()`` is None and the
MoE all-to-all compression hook (``use_a2a_compress``) never becomes
active: as in the reference, it acts only under a mesh.  The serve hooks
are whole: ``use_kv_reshard_compress`` arms the
prefill->decode handoff wire codec and ``use_kv_evict_codec`` the paged
pool's eviction codec, each validated when armed and each scoped (the
previous state returns on exit, also on an exception).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, List, Optional

_kv_reshard_stack: List[Optional[str]] = []
_a2a_compress_stack: List[Optional[str]] = []
_kv_evict_stack: List[Optional[str]] = []

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


def current_mesh():
    """The installed device mesh: always None until the port has meshes."""
    return None


def constrain(x, *spec_elems):
    """Sharding constraint under the current mesh; the identity off-mesh
    (the only case the port has)."""
    return x


def weight_gather_info():
    """The int8 weight-gather hook's (specs, mesh); None off-mesh, so the
    model runs its plain path."""
    return None


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
    """True only when armed AND under a mesh (the reference's rule), so
    never in the port until it has meshes."""
    return bool(_a2a_compress_stack and _a2a_compress_stack[-1]
                and current_mesh() is not None)


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
