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
import json
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
        name = self.codec
        for sub, override in self.rules:
            if sub in key:
                name = override
                break
        if name == "lossless" or not self._eligible(arr):
            return "lossless"
        return name

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

    def _eligible(self, arr: torch.Tensor) -> bool:
        if not arr.dtype.is_floating_point or arr.numel() < self.min_size:
            return False
        # one device reduction; only the bool crosses to the host
        lo, hi = torch.aminmax(arr.to(torch.float32))
        return bool(torch.isfinite(arr).all() & (hi - lo > 0))


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
    DTensors are gathered whole (every rank joins), arrays and scalars go
    to `device` (default CUDA)."""
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


def _encode_tree(flat: Dict[str, Any], policy: CheckpointPolicy,
                 nshards: int, snapshot: bool) -> List[_LeafPlan]:
    """Run every leaf's codec on its device and plan shard placement.

    `snapshot` (async mode): identity-encoded payloads that alias the
    live leaf buffer (the leaf itself or a view of it) are copied, so a
    mutation of the state during the overlapped write cannot corrupt the
    checkpoint.
    """
    codec_cache: Dict[str, codecs.Codec] = {"lossless": codecs.get("lossless")}
    plans: List[_LeafPlan] = []
    owner_load = [0] * nshards

    def lossless_parts(leaf, axis):
        codec = codec_cache["lossless"]
        if axis is None or nshards == 1:
            axis = codec.shard_axis(leaf.shape, nshards)
        if axis is None:
            return None, [codec.encode(leaf)]
        return axis, codec.encode_parts(leaf, axis, nshards)

    # pass A: dispatch every encode
    staged = []
    for key, leaf in flat.items():
        name = policy.codec_for(key, leaf)
        if name not in codec_cache:
            codec_cache[name] = policy.make_codec(name)
        codec = codec_cache[name]
        axis = codec.shard_axis(leaf.shape, nshards) if nshards > 1 else None
        try:
            if axis is not None:
                parts = codec.encode_parts(leaf, axis, nshards)
            else:
                parts = [codec.encode(leaf)]
        except (ValueError, AssertionError):
            # codec cannot represent the leaf (eb below f32 resolution,
            # block-misaligned dims): store raw
            name, codec = "lossless", codec_cache["lossless"]
            axis, parts = lossless_parts(leaf, None)
        staged.append((key, leaf, name, axis, parts))

    # pass B: validity + does-it-win decisions (scalar-sized reads only),
    # falling back to lossless so the codec never expands a checkpoint
    for key, leaf, name, axis, parts in staged:
        raw = _nbytes(leaf)
        codec = codec_cache[name]
        if name != "lossless":
            ok = all(codec.valid(p) for p in parts)
            if not ok or _stored_size_estimate(codec, parts) >= raw:
                name, codec = "lossless", codec_cache["lossless"]
                axis, parts = lossless_parts(leaf, axis)
        if snapshot and name == "lossless":
            parts = [p.replace(payload={
                k: (v.clone() if _aliases(v, leaf) else v)
                for k, v in p.payload.items()}) for p in parts]
        if axis is not None:
            shards = list(range(nshards))
        else:                         # owner shard: least-loaded so far
            h = int(np.argmin(owner_load)) if nshards > 1 else 0
            shards = [h]
            owner_load[h] += raw
        plans.append(_LeafPlan(key, name, codec.version, axis, parts,
                               shards, raw))
    return plans


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
    flat = _flatten(tree, device)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if rank == 0:                     # the single controller writes
        os.makedirs(ckpt_dir, exist_ok=True)
        plans = _encode_tree(flat, policy, int(nshards),
                             snapshot=writer is not None)
        if writer is not None:
            writer.submit(_write_step, ckpt_dir, step, plans, policy.codec,
                          int(nshards))
        else:
            final = _write_step(ckpt_dir, step, plans, policy.codec,
                                int(nshards))
    del flat
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
    if shardings is not None:
        import torch.distributed as dist

        from repro_torch.tree import leaves
        first = next(iter(leaves(shardings)), None)
        if first is not None:
            device = first.mesh.device_type
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()            # rank 0's writes are complete
    dev = input_device(None, device)
    candidates = available_steps(ckpt_dir)
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
