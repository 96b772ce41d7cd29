"""Async, per-host-sharded, crash-safe checkpointing on `repro_torch.codecs`.

Saving is a two-phase pipeline:

  1. **encode** (caller thread, on the leaves' device): every leaf goes
     through the codec its `CheckpointPolicy` selects.  Split-stable
     codecs (lossless / int8 / int16 / int8-block — see
     `Codec.shard_axis`) split large leaves into one slice per host shard
     and encode each slice so it decodes bit-identically to a
     whole-tensor encode; chunked-transform codecs (cusz, zfp) keep the
     leaf whole and assign it to the least-loaded owner shard.  What
     leaves the device is the encoded payload, and only in the write
     phase.
  2. **write** (optionally async via `io.async_writer.AsyncWriter`):
     pack each container to its storage form, stream one
     ``shard_<host>.npz`` per shard, write ``manifest.json`` *last*, and
     commit atomically by renaming the temp dir over the final name —
     an interrupted save can never shadow the last complete checkpoint.

The manifest (format 3) records, per tensor, the codec id/version, the
split axis, and each shard part's self-describing container header — so
`load_checkpoint` reassembles from any shard count: parts are
concatenated in payload space when the codec supports it
(`Codec.payload_axes`), and the decode runs on the target `device`, so
what moves host->device is the stored containers, not decoded values.
Manifest format 2 (single ``arrays.npz``) stays loadable behind a format
gate.  Checkpoints are the reference package's format: either package
loads what the other wrote.

Trees are nested dicts / lists / tuples / NamedTuples of tensors (a
``state_dict`` is one; so is a train state ``(params, AdamWState)``).
Leaves are visited as the reference visits a pytree (dict keys sorted,
NamedTuple fields keyed ``.<field>``), a leaf's manifest key is its path
joined by ``::``, and `load_checkpoint` gives back the template's
container types.

Async semantics: pass ``writer=AsyncWriter(...)`` (or ``background=True``,
which uses a module-default writer).  ``submit`` blocks when the writer
falls behind (bounded queue), and write failures re-raise at the next
save / ``writer.wait()`` — never silently lost.

On a mesh (DTensor leaves) the reference's single controller holds:
every rank joins the ``full_tensor()`` gathers, rank 0 encodes and
writes every shard file and the manifest (the bytes of a mesh-less save
of the same tree), and all ranks pass a barrier.  With an async writer
the files are complete once rank 0's writer drains;
``load_checkpoint(shardings=)`` starts with a barrier, so a restore on
every rank after rank 0's ``wait`` reads whole files.  It decodes each
leaf on every rank and places it with the given `NamedSharding` tree:
the elastic restore onto a mesh of another shape.  With
``dist.context.use_restore_compress`` armed, raw (lossless-stored) float
leaves move to the device as the blockwise int8 wire codec's codes and
scales instead (lossy, scale/2), counted in ``LAST_RESTORE_STATS``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import codecs
from repro_torch.codecs.base import as_tensor, input_device
from repro_torch.io.async_writer import AsyncWriter
from repro_torch.tree import leaves_with_path as _leaves_with_path
from repro_torch.tree import rebuild as _rebuild

CUSZ_MIN_SIZE = 4096
WIRE_BLOCK = 128                 # restore-leg int8-block wire granularity
MANIFEST_FORMAT = 3
_SEP = "::"
_FIELD_MARK = "__c__"
_SHARD_FMT = "shard_{:05d}.npz"

#: telemetry of the most recent `load_checkpoint` call: step, manifest
#: format, saved shard count, the bytes of stored containers moved to the
#: device against the raw size, and — when corrupted steps were skipped —
#: a ``quarantine`` list of structured per-step corruption reports.
LAST_RESTORE_STATS: Dict[str, Any] = {}

_QUARANTINE_MARK = "QUARANTINE.json"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint step failed integrity verification (bad zip, payload
    checksum mismatch, missing/garbled manifest).  Carries the structured
    per-step ``reports`` that restore accumulated before giving up."""

    def __init__(self, msg: str, reports: List[Dict[str, Any]]):
        super().__init__(msg)
        self.reports = reports


#: error classes that mean "these bytes are damaged", as opposed to
#: "this checkpoint is from an incompatible writer" (format-gate
#: ValueErrors, which must propagate, not quarantine).
_CORRUPTION_ERRORS = (codecs.ChecksumError, zipfile.BadZipFile, zlib.error,
                      OSError, EOFError, KeyError,
                      json.JSONDecodeError)

_default_writer: Optional[AsyncWriter] = None


def default_writer() -> AsyncWriter:
    """The module-level writer `background=True` saves go through."""
    global _default_writer
    if _default_writer is None:
        _default_writer = AsyncWriter(max_pending=2)
    return _default_writer


def wait_for_writes() -> None:
    """Barrier on the default background writer; re-raises any captured
    write failure."""
    if _default_writer is not None:
        _default_writer.wait()


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Per-leaf codec selection from one config.

    `codec` applies to every eligible float leaf; `rules` overrides by
    key substring (first match wins, value is a registry name — use
    "lossless" to exempt a subtree).  Ineligible leaves (non-float,
    small, non-finite, zero-range) always store lossless.
    """
    codec: str = "lossless"                      # codec for eligible leaves
    eb_valrel: float = 1e-5                      # cusz-family valrel bound
    min_size: int = CUSZ_MIN_SIZE                # lossy-eligibility floor
    kernel_impl: Optional[str] = None            # cusz dispatch policy
    rules: Tuple[Tuple[str, str], ...] = ()      # (key substring, codec id)

    def codec_for(self, key: str, arr) -> str:
        name = self.lossy_candidate(key, arr.dtype, arr.numel())
        if name is None:
            return "lossless"
        # one device reduction; only the bool crosses to the host
        lo, hi = torch.aminmax(arr.to(torch.float32))
        return name if self.spans(torch.isfinite(arr).all(), lo, hi) \
            else "lossless"

    def lossy_candidate(self, key: str, dtype: torch.dtype,
                        numel: int) -> Optional[str]:
        """The codec that the config names for the leaf at `key` (the
        first matching rule's, else `codec`), or None when the leaf
        stores lossless whatever its values: the codec is lossless, or
        the leaf is not float or smaller than `min_size`."""
        name = self.codec
        for sub, override in self.rules:
            if sub in key:
                name = override
                break
        if name == "lossless" or not dtype.is_floating_point \
                or numel < self.min_size:
            return None
        return name

    @staticmethod
    def spans(finite: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> bool:
        """The values' half of a candidate's eligibility: all finite
        (`finite`, a bool tensor) and a range above zero (`lo`, `hi`,
        the f32 min and max)."""
        return bool(finite & (hi - lo > 0))

    def make_codec(self, name: str) -> codecs.Codec:
        if name in ("cusz", "cusz-i", "fz"):
            # the staged family shares the valrel bound discipline; the
            # new-stage codecs get full outlier capacity (packed storage
            # prices only the used prefix)
            extra = {} if name == "cusz" else {"outlier_frac": 1.0}
            return codecs.get(name, eb=self.eb_valrel, eb_mode="valrel",
                              use_tpu_blocks=True,
                              kernel_impl=self.kernel_impl, **extra)
        return codecs.get(name)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Trees: visited as a JAX pytree is (`repro_torch.tree`)
# ---------------------------------------------------------------------------

def _leaf_key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flatten(tree, device=None) -> Dict[str, Any]:
    """key -> leaf tensor; tensors stay where they are (no host gather),
    DTensors are gathered whole (every rank joins: only a one-rank mesh
    takes this path), arrays and scalars go to `device` (default
    CUDA)."""
    def one(leaf):
        if _is_dtensor(leaf):
            return leaf.full_tensor()
        if isinstance(leaf, torch.Tensor):
            return leaf
        return as_tensor(np.asarray(leaf), device)
    return {_leaf_key(path): one(leaf)
            for path, leaf in _leaves_with_path(tree)}


def _mesh_ranks(tree) -> Tuple[int, bool]:
    """(this rank, whether the tree has DTensor leaves under a process
    group of more than one rank)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, False
    on_mesh = any(_is_dtensor(x) for _, x in _leaves_with_path(tree))
    return dist.get_rank(), on_mesh and dist.get_world_size() > 1


# ---------------------------------------------------------------------------
# Phase 1: encode + shard planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LeafPlan:
    key: str
    codec: str                       # final codec id (post-fallback)
    version: int
    axis: Optional[int]              # split axis, None = owner-assigned
    parts: List[codecs.Container]    # device-form, one per shard slot
    shards: List[int]                # host shard id per part
    raw_nbytes: int


def _stored_size_estimate(codec: codecs.Codec, parts) -> int:
    """Storage bytes without packing: shape metadata plus (for the staged
    family) the per-chunk word counts, kept-plane counts and outlier
    count — scalar-sized host reads, never a payload gather."""
    if codec.name in ("cusz", "cusz-i"):
        from repro_torch.core import compressor as CZ
        return sum(CZ.compressed_bytes(
            CZ.CompressedBlob(**{f: p.payload.get(f)
                                 for f in CZ.CompressedBlob._fields}),
            int(p.header.param("nbins"))) for p in parts)
    if codec.name == "fz":
        # zero-plane elision happens at pack time: count the kept planes
        # instead of the dense device form
        total = 0
        for p in parts:
            kept = int(p.payload["plane_nz"].sum())
            n_out = int(p.payload["n_outliers"])
            nwords = int(p.payload["planes"].shape[2])
            bitmap = (p.payload["plane_nz"].numel() + 7) // 8
            total += kept * nwords * 4 + bitmap + n_out * 8 + 8
        return total
    if codec.name == "zfp":
        return sum(codec.stored_nbytes(p) for p in parts)
    return sum(_nbytes(v) for p in parts for v in p.payload.values())


def _aliases(v, leaf: torch.Tensor) -> bool:
    """Whether payload value `v` shares memory with the live leaf."""
    return isinstance(v, torch.Tensor) and v.device == leaf.device \
        and v.untyped_storage().data_ptr() \
        == leaf.untyped_storage().data_ptr()


def _lossless_parts(codec: codecs.Codec, leaf, axis, nshards: int):
    """The lossless parts of `leaf`: along `axis`, or along its own
    shard axis when there is none yet (whole when it has none)."""
    if axis is None or nshards == 1:
        axis = codec.shard_axis(leaf.shape, nshards)
    if axis is None:
        return None, [codec.encode(leaf)]
    return axis, codec.encode_parts(leaf, axis, nshards)


def _encode_parts(name: str, codec_cache, leaf, nshards: int):
    """Pass A for one leaf: its codec's parts (split along the codec's
    shard axis, or whole), or lossless ones when the codec cannot
    represent it (eb below f32 resolution, block-misaligned dims).
    Returns (name, axis, parts)."""
    codec = codec_cache[name]
    axis = codec.shard_axis(leaf.shape, nshards) if nshards > 1 else None
    try:
        if axis is not None:
            return name, axis, codec.encode_parts(leaf, axis, nshards)
        return name, None, [codec.encode(leaf)]
    except (ValueError, AssertionError):
        return ("lossless",) + _lossless_parts(codec_cache["lossless"],
                                               leaf, None, nshards)


def _verdict(codec: codecs.Codec, parts) -> Tuple[bool, int]:
    """Pass B's reads of some of a leaf's parts (scalar-sized only):
    whether they all decode faithfully and, if they do, their stored
    bytes."""
    ok = all(codec.valid(p) for p in parts)
    return ok, (_stored_size_estimate(codec, parts) if ok else 0)


def _keeps(verdicts, raw: int) -> bool:
    """Pass B: whether a codec's parts, read as `_verdict`s (one per
    rank that holds some, or one for them all), decode faithfully and
    store fewer bytes than the raw leaf."""
    return all(ok for ok, _ in verdicts) \
        and sum(n for _, n in verdicts) < raw


def _snapshot(parts, leaf):
    """Payloads that alias the live leaf buffer, copied (async mode: a
    mutation of the state during the overlapped write cannot corrupt the
    checkpoint)."""
    return [p.replace(payload={k: (v.clone() if _aliases(v, leaf) else v)
                               for k, v in p.payload.items()})
            for p in parts]


def _owner_shards(owner_load: List[int], axis, raw: int) -> List[int]:
    """The shard of each part: one per shard when split, else the
    least-loaded owner shard so far."""
    nshards = len(owner_load)
    if axis is not None:
        return list(range(nshards))
    h = int(np.argmin(owner_load)) if nshards > 1 else 0
    owner_load[h] += raw
    return [h]


def _codec_cache(policy: CheckpointPolicy):
    class _Cache(dict):
        def __missing__(self, name):
            self[name] = policy.make_codec(name)
            return self[name]
    return _Cache(lossless=codecs.get("lossless"))


def _encode_tree(flat: Dict[str, Any], policy: CheckpointPolicy,
                 nshards: int, snapshot: bool) -> List[_LeafPlan]:
    """Run every leaf's codec on its device and plan shard placement.

    `snapshot` (async mode): identity-encoded payloads that alias the
    live leaf buffer (the leaf itself or a view of it) are copied, so a
    mutation of the state during the overlapped write cannot corrupt the
    checkpoint.
    """
    codec_cache = _codec_cache(policy)
    owner_load = [0] * nshards
    # pass A: dispatch every encode
    staged = [(key, leaf) + _encode_parts(policy.codec_for(key, leaf),
                                          codec_cache, leaf, nshards)
              for key, leaf in flat.items()]
    # pass B: validity + does-it-win decisions, falling back to lossless
    # so the codec never expands a checkpoint
    plans: List[_LeafPlan] = []
    for key, leaf, name, axis, parts in staged:
        raw = _nbytes(leaf)
        if name != "lossless" and not _keeps(
                [_verdict(codec_cache[name], parts)], raw):
            name = "lossless"
            axis, parts = _lossless_parts(codec_cache[name], leaf, axis,
                                          nshards)
        if snapshot and name == "lossless":
            parts = _snapshot(parts, leaf)
        plans.append(_LeafPlan(key, name, codec_cache[name].version, axis,
                               parts, _owner_shards(owner_load, axis, raw),
                               raw))
    return plans


# ---------------------------------------------------------------------------
# Phase 1 on a mesh: each part encoded on one rank, payloads to rank 0
# ---------------------------------------------------------------------------

def _box_of(shape, sizes, coord, placements):
    """(offset, shape) of the shard that the rank at mesh coordinate
    `coord` holds of a tensor of global `shape` (DTensor's ``Shard``
    splits as `torch.chunk` does, mesh dims in order)."""
    from torch.distributed.tensor import Shard

    lo, size = [0] * len(shape), [int(s) for s in shape]
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n, k = pl.dim, size[pl.dim], int(sizes[i])
            c = -(-n // k)
            start = min(c * int(coord[i]), n)
            lo[d] += start
            size[d] = min(start + c, n) - start
    return lo, size


def _gather_box(leaf, lo, hi, dst: int):
    """The box ``[lo, hi)`` of the DTensor `leaf`, assembled on global
    rank `dst` (None on the other ranks): each element comes from the
    one rank that holds it at coordinate 0 of every mesh dim that
    replicates it, point to point.  No rank sees more of the leaf than
    its own shard and, on `dst`, the box."""
    import itertools

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    mesh = leaf.device_mesh
    sizes = tuple(mesh.shape)
    me = dist.get_rank()
    local = leaf.to_local()
    out = (torch.empty([h - l for l, h in zip(lo, hi)], dtype=leaf.dtype,
                       device=local.device) if me == dst else None)
    ops, recvs = [], []
    for coord in itertools.product(*(range(n) for n in sizes)):
        if any(isinstance(pl, Replicate) and c != 0
               for pl, c in zip(leaf.placements, coord)):
            continue
        src = int(mesh.mesh[coord])
        o, n = _box_of(leaf.shape, sizes, coord, leaf.placements)
        a = [max(x, y) for x, y in zip(o, lo)]
        b = [min(x + m, y) for x, m, y in zip(o, n, hi)]
        if any(x >= y for x, y in zip(a, b)):
            continue
        if src == me:
            piece = local[tuple(slice(x - y, z - y)
                                for x, z, y in zip(a, b, o))]
        if src == me == dst:
            out[tuple(slice(x - y, z - y) for x, z, y in zip(a, b, lo))] \
                = piece
        elif src == me:
            ops.append(dist.isend(piece.contiguous(), dst))
        elif me == dst:
            buf = torch.empty([z - x for x, z in zip(a, b)],
                              dtype=leaf.dtype, device=local.device)
            ops.append(dist.irecv(buf, src))
            recvs.append((a, b, buf))
    for op in ops:
        op.wait()
    for a, b, buf in recvs:
        out[tuple(slice(x - y, z - y) for x, z, y in zip(a, b, lo))] = buf
    return out


def _all_reduce(vals, op):
    import torch.distributed as dist

    t = torch.tensor(vals, dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=op)
    return t.cpu().tolist()


def _mesh_codec_for(policy: CheckpointPolicy, key: str, leaf) -> str:
    """`policy.codec_for` of a DTensor leaf without gathering it: the
    finiteness and range of the whole leaf by all-reduce over the
    ranks' shards."""
    import torch.distributed as dist

    name = policy.lossy_candidate(key, leaf.dtype, leaf.numel())
    if name is None:
        return "lossless"
    local = leaf.to_local()
    if local.numel():
        lo, hi = torch.aminmax(local.to(torch.float32))
        vals = [-float(lo), float(hi), float(torch.isfinite(local).all())]
    else:
        vals = [-math.inf, -math.inf, 1.0]
    neg_lo, hi = _all_reduce(vals[:2], dist.ReduceOp.MAX)
    finite = _all_reduce(vals[2:], dist.ReduceOp.MIN)[0]
    # f32 extremes cross exactly as f64
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    return name if policy.spans(torch.tensor(finite == 1.0), f32(-neg_lo),
                                f32(hi)) else "lossless"


def _encode_held(codec_cache, name: str, leaf, held, raw: int):
    """Passes A and B of `_encode_tree` for a split-stable DTensor leaf
    whose parts lie on several ranks (`held`: this rank's, part index ->
    tensor), every rank joining: an int8 / int16 part takes the scale
    pinned by the whole leaf's max, and the verdict on the parts of all
    ranks is one.  Returns (name, this rank's encoded parts), or
    ("lossless", None) when the codec cannot represent a part: the leaf
    then stores lossless along that codec's own axis, as
    `_encode_parts` stores it."""
    import torch.distributed as dist

    from repro_torch.codecs.int8 import Int8Codec

    codec = codec_cache[name]
    pin = None
    if isinstance(codec, Int8Codec):
        local = leaf.to_local()
        amax = float(local.to(torch.float32).abs().amax()) \
            if local.numel() else 0.0
        pin = _all_reduce([amax], dist.ReduceOp.MAX)[0]
    try:
        enc = {i: (codec.encode_slice(t, pin) if pin is not None
                   else codec.encode(t)) for i, t in held.items()}
        verdict = _verdict(codec, enc.values())
    except (ValueError, AssertionError):
        enc, verdict = None, None
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, verdict)
    if any(v is None for v in got):
        return "lossless", None
    if name == "lossless" or _keeps(got, raw):
        return name, enc
    # `_lossless_parts` along the same axis: each part on its own
    lossless = codec_cache["lossless"]
    return "lossless", {i: lossless.encode(t) for i, t in held.items()}


def _mesh_encode_tree(tree, policy: CheckpointPolicy, nshards: int,
                      device) -> Optional[List[_LeafPlan]]:
    """Phase 1 of a save of a tree of DTensors on a mesh, every rank
    joining: the plans of `_encode_tree`, with packed parts, on rank 0
    (None on the others).

    A split-stable leaf (its codec has a shard axis) is cut into one part
    per shard file; each part is assembled on one rank (round robin) from
    the ranks that hold it, and encoded there; an int8 / int16 part takes
    the scale pinned by the whole leaf's max (one all-reduce).  Any other
    leaf goes whole to one rank only, which runs `_encode_tree`'s steps on
    it.  Only the packed parts travel to rank 0.  Plain tensor leaves
    (the same on every rank) are encoded on rank 0."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    me, world = dist.get_rank(), dist.get_world_size()
    codec_cache = _codec_cache(policy)
    owner_load = [0] * nshards
    plans: List[_LeafPlan] = []
    turn = 0
    for path, leaf in _leaves_with_path(tree):
        key = _leaf_key(path)
        if not isinstance(leaf, DTensor):
            if me == 0:
                plan = _encode_tree(_flatten({key: leaf}, device), policy,
                                    nshards, False)[0]
                plan.shards = _owner_shards(owner_load, plan.axis,
                                            plan.raw_nbytes)
                plan.parts = [codec_cache[plan.codec].pack(p)
                              for p in plan.parts]
                plans.append(plan)
            continue
        raw = leaf.numel() * leaf.element_size()
        name = _mesh_codec_for(policy, key, leaf)
        while True:
            codec = codec_cache[name]
            axis = codec.shard_axis(leaf.shape, nshards) if nshards > 1 \
                else None
            if axis is None:
                owner = turn % world
                turn += 1
                whole = _gather_box(leaf, [0] * leaf.dim(),
                                    list(leaf.shape), owner)
                mine, info = {}, None     # part index -> packed container
                if me == owner:
                    name, axis, parts = _encode_parts(name, codec_cache,
                                                      whole, nshards)
                    if name != "lossless" and not _keeps(
                            [_verdict(codec_cache[name], parts)], raw):
                        name = "lossless"
                        axis, parts = _lossless_parts(codec_cache[name],
                                                      whole, axis, nshards)
                    mine = {i: codec_cache[name].pack(p)
                            for i, p in enumerate(parts)}
                    info = (name, axis, len(parts))
                del whole
                got = [None] * world
                dist.all_gather_object(got, info)
                name, axis, nparts = got[owner]
                break
            step = leaf.shape[axis] // nshards
            held = {}
            for i in range(nshards):
                lo = [0] * leaf.dim()
                hi = list(leaf.shape)
                lo[axis], hi[axis] = i * step, (i + 1) * step
                owner = turn % world
                turn += 1
                part = _gather_box(leaf, lo, hi, owner)
                if part is not None:
                    held[i] = part
            name, enc = _encode_held(codec_cache, name, leaf, held, raw)
            del held
            if enc is not None:
                mine = {i: codec_cache[name].pack(p) for i, p in enc.items()}
                nparts = nshards
                break
            # a part the codec cannot represent: lossless, from the top
        got = [None] * world if me == 0 else None
        dist.gather_object(mine, got, dst=0)
        if me == 0:
            parts = {i: c for g in got for i, c in g.items()}
            plans.append(_LeafPlan(
                key, name, codec_cache[name].version, axis,
                [parts[i] for i in range(nparts)],
                _owner_shards(owner_load, axis, raw), raw))
    return plans if me == 0 else None


# ---------------------------------------------------------------------------
# Phase 2: pack + shard files + manifest + atomic commit
# ---------------------------------------------------------------------------

def _write_shard(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """One host's shard file.  Module-level so crash-consistency tests
    can inject failures mid-save.  Consults the ambient chaos monkey
    (`dist.chaos`): armed write faults raise here (retried or surfaced by
    the writer) or silently damage the file after the write (caught by
    the container checksums at restore)."""
    from repro_torch.dist import chaos
    monkey = chaos.current()
    if monkey is not None:
        monkey.pre_write(path)
    np.savez(path, **arrays)
    if monkey is not None:
        # np.savez appends .npz when the target has no extension
        monkey.post_write(path if os.path.exists(path) else path + ".npz")


def _write_step(ckpt_dir: str, step: int, plans: Sequence[_LeafPlan],
                policy_codec: str, nshards: int) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    shutil.rmtree(tmp, ignore_errors=True)       # stale crashed attempt
    os.makedirs(tmp, exist_ok=True)
    codec_cache: Dict[str, codecs.Codec] = {}
    shard_arrays: List[Dict[str, np.ndarray]] = [{} for _ in range(nshards)]
    manifest: Dict[str, Any] = {"step": step, "format": MANIFEST_FORMAT,
                                "nshards": nshards, "policy": policy_codec,
                                "tensors": {}}
    for plan in plans:
        if plan.codec not in codec_cache:
            codec_cache[plan.codec] = codecs.get(plan.codec)
        codec = codec_cache[plan.codec]
        entry: Dict[str, Any] = {"codec": plan.codec, "version": plan.version,
                                 "axis": plan.axis, "shards": []}
        stored = 0
        for i, (part, h) in enumerate(zip(plan.parts, plan.shards)):
            header, fields = codecs.to_arrays(codec.pack(part))
            stored += sum(v.nbytes for v in fields.values())
            for f, v in fields.items():
                shard_arrays[h][_SEP.join((plan.key, _FIELD_MARK,
                                           str(i), f))] = v
            entry["shards"].append({"shard": h, "header": header})
        if plan.codec != "lossless":
            entry["ratio"] = plan.raw_nbytes / max(1, stored)
        manifest["tensors"][plan.key] = entry
    for h in range(nshards):
        _write_shard(os.path.join(tmp, _SHARD_FMT.format(h)),
                     shard_arrays[h])
    # manifest last: its presence marks the step complete inside the tmp
    # dir; the rename below makes completeness atomic from the outside
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    policy: Optional[CheckpointPolicy] = None,
                    nshards: int = 1,
                    writer: Optional[AsyncWriter] = None,
                    background: bool = False,
                    device: Optional[str] = None):
    """Write `tree` under `ckpt_dir/step_<step>` via the codec registry.

    `policy` selects codecs per leaf (default: lossless).  `nshards`
    splits the write into per-host shard files.  `writer` makes the write
    phase asynchronous: the call returns after the encode, the file I/O
    runs on the writer thread, and errors re-raise at the next
    `submit`/`wait`; `background=True` uses the module-default writer.
    Tensor leaves encode on their own device; array leaves go to `device`
    (default CUDA).  Returns the final step dir (sync) or the writer
    (async)."""
    policy = policy or CheckpointPolicy()
    if writer is None and background:
        writer = default_writer()
    rank, multi = _mesh_ranks(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if multi:
        plans = _mesh_encode_tree(tree, policy, int(nshards), device)
    elif rank == 0:
        plans = _encode_tree(_flatten(tree, device), policy, int(nshards),
                             snapshot=writer is not None)
    if rank == 0:                     # the single controller writes
        os.makedirs(ckpt_dir, exist_ok=True)
        if writer is not None:
            writer.submit(_write_step, ckpt_dir, step, plans, policy.codec,
                          int(nshards))
        else:
            final = _write_step(ckpt_dir, step, plans, policy.codec,
                                int(nshards))
    if multi:
        import torch.distributed as dist
        dist.barrier()
    return writer if writer is not None else final


def available_steps(ckpt_dir: str) -> List[int]:
    """Complete, non-quarantined steps, ascending.  In-flight
    ``.tmp_step_*`` dirs and steps carrying a ``QUARANTINE.json`` marker
    (written when restore hit corruption there) are excluded."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, _QUARANTINE_MARK)):
            continue
        steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete, non-quarantined step."""
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _mark_quarantined(step_dir: str, report: Dict[str, Any]) -> None:
    """Drop the quarantine marker (best-effort: a read-only checkpoint
    store still falls back correctly, it just re-detects next time)."""
    try:
        with open(os.path.join(step_dir, _QUARANTINE_MARK), "w") as f:
            json.dump(report, f, indent=2)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _container_fields(arrays, prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: arrays[k] for k in arrays.files
            if k.startswith(prefix)}


def _assemble_v3(key: str, entry, shard_files, verify: bool, device):
    """Read a tensor's shard parts and merge them into one container, or
    (when the codec has no payload-space concat) a decoded tensor on
    `device`.  With ``verify`` each part's payload is checked against its
    header crc32 *before* merge/decode, so corruption surfaces as
    `ChecksumError` at the damaged part, not as garbage weights."""
    parts = []
    for i, sh in enumerate(entry["shards"]):
        arrays = shard_files(int(sh["shard"]))
        prefix = _SEP.join((key, _FIELD_MARK, str(i), ""))
        part = codecs.from_arrays(sh["header"],
                                  _container_fields(arrays, prefix))
        if verify:
            codecs.check_container(part)
        parts.append(part)
    if len(parts) == 1:
        return parts[0]
    codec = codecs.get(entry["codec"])
    axes = codec.payload_axes(int(entry["axis"]))
    if axes is not None:
        return codecs.concat_containers(parts, int(entry["axis"]), axes)
    return torch.cat([codecs.decode(p, device=device) for p in parts],
                     dim=int(entry["axis"]))


def _lossless_host_view(c: codecs.Container) -> np.ndarray:
    """The raw values of a packed lossless container, staying on the host
    (the bf16 storage bitcast undone)."""
    arr = np.asarray(c.payload["data"])
    want = np.dtype(c.header.dtype) if c.header.dtype != "bfloat16" \
        else None
    if want is None:                  # bf16: stored as its 16-bit pattern
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(c.header.shape)
    if arr.dtype != want and arr.dtype.itemsize == want.itemsize:
        arr = arr.view(want)
    return arr.reshape(c.header.shape)


def _recodable(got, codec_name: str) -> bool:
    """A raw (lossless-stored) float leaf big enough for the restore-leg
    wire."""
    if not isinstance(got, codecs.Container) or codec_name != "lossless":
        return False
    dt = got.header.dtype
    floating = dt == "bfloat16" or np.dtype(dt).kind == "f"
    shape = tuple(got.header.shape)
    return floating and bool(shape) and int(np.prod(shape)) >= CUSZ_MIN_SIZE


def _wire_recode(raw: np.ndarray, wire_name: str):
    """Re-encode a raw leaf over the blockwise wire codec for the move to
    the device (the armed `use_restore_compress` leg), quantized with
    host numpy so that only codes and scales cross: the reference's
    payload and header layout, which the registry codec decodes.  Returns
    (codec, container, n_valid); the decode slices the edge padding
    off."""
    wire = codecs.get_block_codec(wire_name, axis=0, block=WIRE_BLOCK)
    flat = np.asarray(raw, np.float32).reshape(-1)
    pad = (-flat.size) % WIRE_BLOCK
    if pad:
        flat = np.pad(flat, (0, pad), mode="edge")
    xb = flat.reshape(-1, WIRE_BLOCK)
    scale = np.maximum(np.abs(xb).max(axis=1, keepdims=True) / 127.0,
                       1e-30).astype(np.float32)
    q = np.clip(np.rint(xb / scale), -127, 127).astype(np.int8)
    cont = codecs.Container(
        codecs.make_header(wire.name, wire.version, flat,
                           axis=0, block=WIRE_BLOCK),
        {"q": torch.from_numpy(q.reshape(-1)),
         "scale": torch.from_numpy(scale.reshape(-1))})
    return wire, cont, flat.size - pad


def _load_step(d: str, step: int, template, device: torch.device,
               kernel_impl: Optional[str], verify: bool, shardings=None):
    """Load one specific step dir; returns ``(tree, stats)``.  Raises one
    of `_CORRUPTION_ERRORS` when the bytes are damaged (the caller's
    quarantine loop handles those) or ValueError for format-gate
    mismatches (which must propagate)."""
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = manifest.get("format", 1)
    if fmt == 1:
        raise ValueError(
            f"checkpoint {d} uses manifest format 1, which predates the "
            f"codecs API — re-save from a checkout that wrote it.")
    if fmt not in (2, MANIFEST_FORMAT):
        raise ValueError(
            f"checkpoint {d} uses manifest format {fmt}; this reader "
            f"supports formats 2 (single-file containers) and "
            f"{MANIFEST_FORMAT} (sharded containers).")

    file_cache: Dict[Any, Any] = {}

    def shard_files(h: int):
        if h not in file_cache:
            file_cache[h] = np.load(os.path.join(d, _SHARD_FMT.format(h)))
        return file_cache[h]

    def v2_arrays():
        if "v2" not in file_cache:
            file_cache["v2"] = np.load(os.path.join(d, "arrays.npz"))
        return file_cache["v2"]

    from repro_torch.dist import context as dist_ctx

    stats = {"step": step, "format": fmt,
             "saved_nshards": int(manifest.get("nshards", 1)),
             "leaves": 0, "wire_leaves": 0, "recoded_leaves": 0,
             "wire_bytes": 0, "raw_bytes": 0}
    wire_name = dist_ctx.restore_codec()

    def assemble(key, entry):
        if fmt == 2:
            prefix = _SEP.join((key, _FIELD_MARK, ""))
            cont = codecs.from_arrays(
                entry["header"], _container_fields(v2_arrays(), prefix))
            if verify:
                codecs.check_container(cont)
            return cont
        return _assemble_v3(key, entry, shard_files, verify, device)

    def place(key, entry, leaf, sharding):
        got = restore(key, entry, leaf)
        return sharding.place(got) if sharding is not None else got

    def restore(key, entry, leaf):
        got = assemble(key, entry)
        stats["leaves"] += 1
        stats["raw_bytes"] += _nbytes(leaf)
        if wire_name is not None and _recodable(got, entry["codec"]):
            # the restore-leg wire: codes and scales cross, not raw values
            wire, cont, n = _wire_recode(_lossless_host_view(got), wire_name)
            stats["recoded_leaves"] += 1
            stats["wire_leaves"] += 1
            stats["wire_bytes"] += cont.nbytes
            out = wire.decode(cont, device=device)[:n]
            return out.to(leaf.dtype).reshape(leaf.shape)
        if isinstance(got, codecs.Container):
            # the stored container moves to the device and decodes there
            kw = {"kernel_impl": kernel_impl} \
                if entry["codec"] in ("cusz", "cusz-i", "fz") \
                and kernel_impl is not None else {}
            stats["wire_leaves"] += 1
            stats["wire_bytes"] += got.nbytes
            got = codecs.decode(got, device=device, **kw)
        return got.to(device=device, dtype=leaf.dtype).reshape(leaf.shape)

    flat_sh = ([sh for _, sh in _leaves_with_path(shardings)]
               if shardings is not None else None)
    out = [place(_leaf_key(path), manifest["tensors"][_leaf_key(path)],
                 leaf, flat_sh[i] if flat_sh is not None else None)
           for i, (path, leaf) in enumerate(_leaves_with_path(template))]
    return _rebuild(template, iter(out)), stats


def load_checkpoint(ckpt_dir: str, template, step: Optional[int] = None,
                    device: Optional[str] = None,
                    kernel_impl: Optional[str] = None,
                    verify: bool = True, quarantine: bool = True,
                    shardings=None):
    """Restore the step `step` (default: the newest) into `template`'s
    structure: a tree of tensors that gives each leaf's shape and dtype.
    Returns ``(tree, step)``.

    The stored containers move to `device` (default CUDA; without CUDA
    the caller must pass ``device="cpu"``) and decode there.
    `shardings` (a `dist.sharding.NamedSharding` tree shaped like
    `template`) places every leaf on its mesh instead, on the mesh's
    device: the elastic restore.
    `kernel_impl` configures the staged codecs' kernel dispatch.

    ``verify`` (default on) checks every stored container payload
    against its header crc32.  ``quarantine`` (default on) makes
    corruption non-fatal: the damaged step dir gets a ``QUARANTINE.json``
    marker with a structured report, restore falls back to the newest
    older good step, and the per-step reports land in
    ``LAST_RESTORE_STATS["quarantine"]``.  With ``quarantine=False``
    corruption raises `CheckpointCorruptionError` immediately."""
    ranks = False
    if shardings is not None:
        import torch.distributed as dist

        from repro_torch.tree import leaves
        first = next(iter(leaves(shardings)), None)
        if first is not None:
            device = first.mesh.device_type
        ranks = dist.is_initialized() and dist.get_world_size() > 1
        if ranks:
            dist.barrier()            # rank 0's writes are complete
    dev = input_device(None, device)
    candidates = available_steps(ckpt_dir)
    if ranks:
        # every rank has listed the steps before any rank marks one
        # quarantined: all try (and report) the same steps
        dist.barrier()
    if step is not None:
        candidates = [s for s in candidates if s <= step]
        if step not in candidates:
            candidates.append(step)      # explicit step: always tried first
    else:
        assert candidates, f"no checkpoints under {ckpt_dir}"
    reports: List[Dict[str, Any]] = []
    for s in sorted(set(candidates), reverse=True):
        d = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            tree, stats = _load_step(d, s, template, dev, kernel_impl,
                                     verify, shardings)
        except _CORRUPTION_ERRORS as e:
            report = {"step": int(s), "dir": d,
                      "error_type": type(e).__name__, "error": str(e)}
            reports.append(report)
            if not quarantine:
                LAST_RESTORE_STATS.clear()
                LAST_RESTORE_STATS.update({"quarantine": reports})
                raise CheckpointCorruptionError(
                    f"checkpoint step {s} under {ckpt_dir} is corrupted: "
                    f"{type(e).__name__}: {e}", reports) from e
            _mark_quarantined(d, report)
            continue
        if reports:
            stats["quarantine"] = reports
        LAST_RESTORE_STATS.clear()
        LAST_RESTORE_STATS.update(stats)
        return tree, s
    LAST_RESTORE_STATS.clear()
    LAST_RESTORE_STATS.update({"quarantine": reports})
    raise CheckpointCorruptionError(
        f"no loadable checkpoint under {ckpt_dir}: "
        f"{len(reports)} candidate step(s) all failed integrity checks "
        f"({[r['step'] for r in reports]})", reports)
