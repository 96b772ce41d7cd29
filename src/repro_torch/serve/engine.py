"""Serving engine: prefill + batched synchronized decode with optional
compressed KV cache, split into disaggregation-ready phases:

  1. **prefill** — run the prompt through the parallel forward and build
     the decode caches (optionally already in the in-memory QuantKV
     compressed format).
  2. **handoff** — ``encode_handoff`` turns every cache tensor into
     per-SEQ_BLOCK-slab registry Containers (`int8-block` wire by
     default; `cusz`, `fz` or `lossless`); the packed Containers — never
     decoded f32 — are what crosses the prefill->decode boundary.
  3. **reshard** — ``reshard_caches`` adopts the containers on the decode
     side: int8-block payloads become the in-memory QuantKV cache
     directly (no re-quantization round trip), other wires decode (on
     the card: the codecs' CUDA kernels) and re-quantize.
  4. **decode** — ``decode_tokens`` runs the one-token step in a loop.

``generate`` composes 1+4.  GQA K/V and MLA latents cross the handoff
as per-slab wire containers, Mamba/SSD state as lossless whole tensors.

Under a mesh (``dist.context.use_mesh``) prefill runs the DTensor forward
(params placed by ``sharding.param_shardings``, the prompt by
``resolve_sharding(mesh, shape, "data")``, modality inputs by rows) and
places the caches by the decode cache rule (`place_caches`: batch over
the data-parallel axes, sequence over "model", Mamba heads over
"model"); the handoff gathers each cache tensor and encodes it whole (the
containers are what crosses to the other mesh); ``reshard_caches`` places
the arriving caches on the decode mesh by the same rule; and
``decode_tokens`` runs `models.model.mesh_decode_step` on each rank's own
rows, the weights gathered one layer at a time inside the step, and
returns the tokens placed by rows.

Sampling: greedy (``temperature=0``) is the reference's, token for token.
Temperature sampling draws from ``softmax(logits / T)`` with a
``torch.Generator``; it matches the reference's ``jax.random.categorical``
in distribution only, not draw for draw.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import codecs
from repro_torch.codecs.base import input_device
from repro_torch.core import kvcache as KVC
from repro_torch.debug import guards
from repro_torch.dist import context as dist_ctx
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    s_max: int = 2048
    compressed_kv: bool = False
    kv_codec: str = "int8-block"     # registry id of the in-memory KV codec
    temperature: float = 0.0         # 0 = greedy
    compute_dtype: torch.dtype = torch.bfloat16


#: seq axis of every prefill cache entry ([n_periods, B, S, ...])
HANDOFF_SEQ_AXIS = 2


# ---------------------------------------------------------------------------
# Phase 1: prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, scfg: ServeConfig,
            extra=None):
    """Run the prompt through the parallel forward, build decode caches.
    `tokens` ([B, S] integers) go to the parameters' device.
    Returns (last_logits [B,V], DecodeCaches, prompt_len)."""
    params = M.cast_params(params, scfg.compute_dtype)
    dev = params["embed"].device
    mesh = dist_ctx.current_mesh()
    tokens = torch.as_tensor(tokens, device=dev)
    if mesh is not None and not _is_dtensor(tokens):
        tokens = dist_ctx.resolve_sharding(mesh, tokens.shape,
                                           "data").place(tokens)
    if mesh is not None and extra:
        from repro_torch.dist.sharding import place_extra
        extra = place_extra(extra, mesh)
    logits, caches = M.forward(params, cfg, tokens, extra,
                               compute_dtype=scfg.compute_dtype,
                               collect_caches=True)
    B, S = tokens.shape
    S_total = S + cfg.n_prepend_embeds
    kv_codec = (codecs.get_block_codec(scfg.kv_codec,
                                       axis=HANDOFF_SEQ_AXIS,
                                       block=KVC.SEQ_BLOCK)
                if scfg.compressed_kv else None)

    def extend(x):
        """Pad the seq axis to s_max; under compressed_kv the full buffer
        becomes the registry codec's payload, kept as the in-memory
        QuantKV format the decode step indexes directly.  A DTensor is
        padded and encoded shard by shard (its seq axis kept whole)."""
        if _is_dtensor(x):
            return _seq_local(extend, x)
        ext = torch.zeros(x.shape[:2] + (scfg.s_max - S_total,)
                          + x.shape[3:], dtype=x.dtype, device=x.device)
        full = torch.cat([x, ext], dim=HANDOFF_SEQ_AXIS)
        if kv_codec is not None:
            cont = kv_codec.encode(full)
            return KVC.QuantKV(cont.payload["q"], cont.payload["scale"])
        return full

    entries = []
    for kind, c in zip(cfg.pattern, caches):
        if not kind.startswith("attn"):
            entries.append(c)        # MambaState carries over directly
        elif cfg.mla:
            # the MLA latent cache goes through the same block codec as
            # GQA K/V: compressed_kv is honored, not ignored
            entries.append(extend(c))
        else:
            entries.append((extend(c[0]), extend(c[1])))
    caches = M.DecodeCaches(tuple(entries))
    if mesh is not None:
        caches = place_caches(caches, mesh, _long_ctx(mesh, B))
    return logits[:, -1, :], caches, S_total


def _long_ctx(mesh, batch: int) -> bool:
    """Whether a batch on `mesh` runs as one long context: its rows do
    not split over the data-parallel axes, so the caches' sequence
    does."""
    from repro_torch.dist.sharding import dp_axes, mesh_shape

    sizes = mesh_shape(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= int(sizes[a])
    return batch % n != 0


def place_caches(caches: M.DecodeCaches, mesh, long_ctx: bool = False):
    """`caches` placed on `mesh` by the decode cache rule
    (``sharding.cache_spec``), a dim that does not divide its axes
    replicated; a QuantKV's codes follow its scales, so each rank's
    slice of the sequence is a whole number of scale blocks."""
    from repro_torch.dist.sharding import (cache_spec, dp_axes, mesh_shape,
                                           P)
    from repro_torch.tree import leaves_with_path, rebuild

    sizes, dp = mesh_shape(mesh), dp_axes(mesh)

    def sharding(path, shape):
        return dist_ctx.resolve_sharding(mesh, shape, *cache_spec(
            path, shape, sizes, dp, long_ctx))

    out = []
    flat = list(leaves_with_path(caches))
    scales = {path[:-1]: leaf for path, leaf in flat
              if str(path[-1]) == ".scale"}
    for path, leaf in flat:
        if str(path[-1]) == ".q" and path[:-1] in scales:
            sh = sharding(path, tuple(scales[path[:-1]].shape))
            sh = type(sh)(mesh, P(*sh.spec))
        else:
            sh = sharding(path, tuple(leaf.shape))
        out.append(sh.place(leaf))
    return rebuild(caches, iter(out))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _seq_local(fn, x):
    """`fn` on the local shard of the DTensor `x` with its seq axis whole
    (gathered first if it is split); the tensor, or each QuantKV field, it
    returns is placed as x is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim == HANDOFF_SEQ_AXIS
          else p for p in x.placements]
    if list(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    out = fn(x.to_local())

    def wrap(t):
        return DTensor.from_local(t, x.device_mesh, pl, run_check=False)
    return KVC.QuantKV(*map(wrap, out)) if isinstance(out, KVC.QuantKV) \
        else wrap(out)


def _gather(x):
    """A cache tensor (or QuantKV) whole on this rank: DTensors are
    gathered, anything else passes."""
    if isinstance(x, KVC.QuantKV):
        return KVC.QuantKV(*map(_gather, x))
    return x.full_tensor() if _is_dtensor(x) else x


def _rows_local(x, batch_dim: int):
    """This rank's rows of the DTensor `x` (split along `batch_dim` over
    the data-parallel axes, whole elsewhere) as a plain tensor."""
    mesh = x.device_mesh
    spec = [None] * x.dim()
    spec[batch_dim] = "dp"
    sh = dist_ctx.resolve_sharding(mesh, x.shape, *spec)
    return x.redistribute(mesh, sh.placements(x.dim())).to_local()


# ---------------------------------------------------------------------------
# Phase 4: decode
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, scfg: ServeConfig):
    """One-token decode for a synchronized batch: (params, token [B,1],
    caches, cache_len) -> (logits [B,1,V], caches), caches written in
    place."""

    def step(params, token, caches, cache_len):
        return M.decode_step(params, cfg, token, caches, cache_len,
                             compute_dtype=scfg.compute_dtype,
                             compressed_kv=scfg.compressed_kv)

    return step


#: builds per (cfg, scfg) key: `generate` reuses the step across calls
#: (``debug.no_recompiles`` counts the same builds as "step")
STEP_TRACES: Dict[Any, int] = {}


@functools.lru_cache(maxsize=None)
def get_serve_step(cfg: ModelConfig, scfg: ServeConfig):
    """The serve step for `(cfg, scfg)`, built once per key (configs are
    frozen dataclasses, so the key is a stable hash)."""
    STEP_TRACES[(cfg, scfg)] = STEP_TRACES.get((cfg, scfg), 0) + 1
    guards.note_build("step")
    return make_serve_step(cfg, scfg)


def pick_token(logits: torch.Tensor, gen: Optional[torch.Generator],
               scfg: ServeConfig) -> torch.Tensor:
    """Greedy / temperature sampling from [B, V] logits -> [B] int32.
    Greedy is `argmax` (the first index on ties, as in the reference);
    temperature draws from `gen` and matches the reference in
    distribution only."""
    if scfg.temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / scfg.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def decode_tokens(params, cfg: ModelConfig, scfg: ServeConfig,
                  last_logits: torch.Tensor, caches: M.DecodeCaches,
                  plen: int, n_new: int,
                  generator: Optional[torch.Generator] = None):
    """Synchronized-batch decode loop from prefilled (or resharded)
    caches.  Works on a copy of `caches` (the step writes in place; the
    caller's stay as they were).  The position lives on the device and
    advances in place, so no host scalar crosses to the card per step.
    Returns [B, n_new] int32 (on a mesh a DTensor placed by rows: each
    rank decodes its own rows, see the module docstring)."""
    mesh = dist_ctx.current_mesh()
    if mesh is not None:
        return _mesh_decode_tokens(mesh, params, cfg, scfg, last_logits,
                                   caches, plen, n_new, generator)
    params = M.cast_params(params, scfg.compute_dtype)
    step_fn = get_serve_step(cfg, scfg)
    caches = M.clone_caches(caches)
    tok = pick_token(last_logits, generator, scfg)[:, None]
    pos = device_position(plen, last_logits.device)
    outs = []
    for _ in range(n_new):
        outs.append(tok[:, 0])
        logits, caches = step_fn(params, tok, caches, pos)
        pos += 1
        tok = pick_token(logits[:, 0, :], generator, scfg)[:, None]
    return torch.stack(outs, dim=1)


def device_position(plen: int, device) -> torch.Tensor:
    """The decode position as a 0-d int64 tensor on `device`, made by a
    fill (the value rides as a kernel argument, no host copy); the loop
    advances it in place."""
    return torch.full((), int(plen), dtype=torch.int64, device=device)


def _mesh_decode_tokens(mesh, params, cfg, scfg, last_logits, caches,
                        plen, n_new, generator):
    """`decode_tokens` on `mesh` with `M.mesh_decode_step`: the weights
    stay placed (gathered a layer at a time inside the step), the caches
    are placed by the decode cache rule (`place_caches`), each rank
    picks its own rows' tokens from logits gathered over the
    vocabulary, and the tokens come back placed by rows."""
    from torch.distributed.tensor import DTensor

    B = last_logits.shape[0]
    rows = dist_ctx.resolve_sharding(mesh, (B, 1), "dp")
    if not _is_dtensor(last_logits):
        last_logits = dist_ctx.resolve_sharding(
            mesh, last_logits.shape, "dp").place(last_logits)
    params = M.cast_params(params, scfg.compute_dtype)
    caches = M.clone_caches(place_caches(caches, mesh,
                                         _long_ctx(mesh, B)))
    tok = pick_token(_rows_local(last_logits, 0), generator, scfg)
    pos = device_position(plen, tok.device)
    outs = []
    for _ in range(n_new):
        outs.append(tok)
        tok_d = DTensor.from_local(tok[:, None], mesh, rows.placements(2),
                                   run_check=False)
        logits, caches = M.decode_step(params, cfg, tok_d, caches, pos,
                                       compute_dtype=scfg.compute_dtype,
                                       compressed_kv=scfg.compressed_kv)
        pos += 1
        tok = pick_token(_rows_local(logits, 0)[:, 0, :], generator, scfg)
    return DTensor.from_local(torch.stack(outs, dim=1), mesh,
                              rows.placements(2), run_check=False)


def generate(params, cfg: ModelConfig, prompt, n_new: int,
             scfg: ServeConfig, extra=None,
             generator: Optional[torch.Generator] = None):
    """Greedy/temperature generation for a batch of equal-length prompts
    (prefill and decode on one device).  Returns [B, n_new] int32."""
    params = M.cast_params(params, scfg.compute_dtype)
    last_logits, caches, plen = prefill(params, cfg, prompt, scfg, extra)
    return decode_tokens(params, cfg, scfg, last_logits, caches, plen,
                         n_new, generator=generator)


# ---------------------------------------------------------------------------
# Phases 2+3: compressed prefill->decode handoff
# ---------------------------------------------------------------------------

class KVHandoff(NamedTuple):
    """Everything that crosses the prefill->decode boundary: per pattern
    entry, a tuple of per-tensor Container tuples (attn K/V and MLA
    latents as per-seq-slab wire containers; Mamba/SSD state as lossless
    containers).  No decoded f32 rides here."""
    kinds: Tuple[str, ...]           # per entry: "kv" | "mla" | "state"
    entries: Tuple[Any, ...]
    plen: int
    wire: str


#: telemetry of the most recent encode_handoff / reshard_caches call
LAST_HANDOFF_STATS: Dict[str, Any] = {}
LAST_RESHARD_STATS: Dict[str, Any] = {}


def encode_handoff(caches: M.DecodeCaches, cfg: ModelConfig,
                   scfg: ServeConfig, *, plen: int,
                   wire: Optional[str] = None,
                   nslabs: Optional[int] = None,
                   wire_cfg: Optional[dict] = None) -> KVHandoff:
    """Phase 2: encode the prefill caches into packed wire Containers.

    `plen` (the prefill length, as returned by ``prefill``) rides in the
    handoff so the decode side resumes from the right position.  `wire`
    resolution: explicit arg > the armed
    ``dist.context.use_kv_reshard_compress`` hook (an explicit disarm
    resolves to "lossless") > "int8-block".  Cache tensors are sliced
    into per-SEQ_BLOCK seq slabs (`nslabs` overrides the slab count) and
    each slab is packed to its host storage form — the container
    payloads are the bytes that move.  Updates ``LAST_HANDOFF_STATS``
    with the wire accounting."""
    wire = wire or dist_ctx.kv_reshard_codec() or "int8-block"
    item = torch.bfloat16.itemsize
    # reset at call START, not return: back-to-back sessions must never
    # read the previous call's wire accounting, and a failed handoff
    # leaves partial (not stale-successful) stats behind
    LAST_HANDOFF_STATS.clear()
    LAST_HANDOFF_STATS.update(
        {"wire": wire, "tensors": 0, "containers": 0,
         "wire_bytes": 0, "raw_bf16_bytes": 0, "lossless_fallback": 0})
    stats = LAST_HANDOFF_STATS

    def account(parts, raw_bytes):
        stats["tensors"] += 1
        stats["containers"] += len(parts)
        stats["wire_bytes"] += KVC.kv_wire_nbytes(parts)
        stats["raw_bf16_bytes"] += raw_bytes
        return parts

    def ship(x):
        x = _gather(x)
        n = x.q.numel() if isinstance(x, KVC.QuantKV) else x.numel()
        parts = KVC.kv_wire_encode(
            x, HANDOFF_SEQ_AXIS, wire=wire, nslabs=nslabs,
            source_dtype=scfg.compute_dtype, wire_cfg=wire_cfg)
        if wire != "lossless":
            # slabs the wire codec could not represent faithfully were
            # re-encoded raw by kv_wire_encode (graceful degradation)
            stats["lossless_fallback"] += sum(
                1 for p in parts if p.header.codec == "lossless")
        return account(parts, n * item)

    lossless = codecs.get("lossless")

    def ship_state(x):
        # recurrent state has no seq axis and stays lossless; its raw
        # baseline is its actual bytes, not the bf16 K/V equivalent
        x = _gather(x)
        return account((lossless.pack(lossless.encode(x)),),
                       x.numel() * x.element_size())

    kinds, entries = [], []
    for kind, c in zip(cfg.pattern, caches.entries):
        if not kind.startswith("attn"):
            kinds.append("state")
            entries.append(tuple(ship_state(x) for x in c))
        elif cfg.mla:
            kinds.append("mla")
            entries.append((ship(c),))
        else:
            kinds.append("kv")
            entries.append((ship(c[0]), ship(c[1])))
    return KVHandoff(tuple(kinds), tuple(entries), int(plen), wire)


def reshard_caches(handoff: KVHandoff, cfg: ModelConfig, scfg: ServeConfig,
                   *, mesh=None, device=None) -> M.DecodeCaches:
    """Phase 3: adopt the handoff Containers as decode caches under the
    decode mesh (default: the current ``dist.context`` mesh), placed by
    the decode cache rule (`place_caches`), or on `device` without a
    mesh (default CUDA).

    int8-block wire + compressed decode target: the payload (q + block
    scales) IS the in-memory QuantKV format — it is concatenated in
    payload space and placed directly, with **no f32 round trip and no
    re-quantization**.  Any other combination decodes (and, for a
    compressed target, re-quantizes).  Updates ``LAST_RESHARD_STATS``."""
    mesh = mesh if mesh is not None else dist_ctx.current_mesh()
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, got "
                            f"{type(mesh).__name__}")
        if device is not None and torch.device(device).type \
                != mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        device = mesh.device_type
    dev = input_device(None, device)

    # reset at call start (same contract as LAST_HANDOFF_STATS)
    LAST_RESHARD_STATS.clear()
    LAST_RESHARD_STATS.update({"tensors": 0, "adopted_quantkv": 0,
                               "decoded": 0})
    stats = LAST_RESHARD_STATS

    def arrive(parts):
        """One cache tensor's wire containers -> its decode-side form
        (placed on the decode mesh with the others, below)."""
        return restore(parts)

    def restore(parts):
        stats["tensors"] += 1
        # a slab that failed wire-codec validation arrives as "lossless";
        # adoption/payload-concat need a homogeneous wire, so any mix
        # routes through the per-part decode path (kv_wire_restore reads
        # each part's own header)
        part_codecs = {p.header.codec for p in parts}
        wire_name = (parts[0].header.codec if len(part_codecs) == 1
                     else "mixed")
        if scfg.compressed_kv:
            if wire_name == "int8-block":
                stats["adopted_quantkv"] += 1
                return KVC.kv_wire_adopt(parts, HANDOFF_SEQ_AXIS,
                                         device=dev)
            full = KVC.kv_wire_restore(parts, HANDOFF_SEQ_AXIS,
                                       dtype=scfg.compute_dtype, device=dev)
            stats["decoded"] += 1
            return KVC.kv_quantize(full, HANDOFF_SEQ_AXIS, reciprocal=True)
        # dense decode target
        stats["decoded"] += 1
        if wire_name == "int8-block":
            codec = codecs.get_block_codec("int8-block",
                                           axis=HANDOFF_SEQ_AXIS,
                                           block=KVC.SEQ_BLOCK)
            unpacked = [codec.unpack(p, dev) for p in parts]
            merged = (unpacked[0] if len(unpacked) == 1 else
                      codecs.concat_containers(
                          unpacked, HANDOFF_SEQ_AXIS,
                          codec.payload_axes(HANDOFF_SEQ_AXIS)))
            return codec.decode(merged, like=SimpleNamespace(
                shape=merged.header.shape, dtype=scfg.compute_dtype))
        return KVC.kv_wire_restore(parts, HANDOFF_SEQ_AXIS,
                                   dtype=scfg.compute_dtype, device=dev)

    entries = []
    for kind, entry in zip(handoff.kinds, handoff.entries):
        if kind == "kv":
            entries.append((arrive(entry[0]), arrive(entry[1])))
        elif kind == "mla":
            entries.append(arrive(entry[0]))
        else:                        # "state": lossless whole tensors
            vals = []
            for parts in entry:
                stats["tensors"] += 1
                stats["decoded"] += 1
                vals.append(codecs.decode(parts[0], device=dev))
            entries.append(ssm_mod.MambaState(*vals))
    caches = M.DecodeCaches(tuple(entries))
    if mesh is None:
        return caches
    from repro_torch.tree import leaves
    batch = leaves(caches)[0].shape[1]           # every leaf [nP, B, ...]
    return place_caches(caches, mesh, _long_ctx(mesh, batch))
