"""The LM: embedding -> loop over layer periods -> norm -> logits.

The reference's `repro.models.model`: one implementation covers all ten
architectures through the config's layer-kind `pattern` (dense GQA,
MoE, MLA, Mamba2 and the hybrid), with the reference's parameter tree:
``params["layers"][i]`` holds pattern position i's leaves stacked over
periods (leading ``[n_periods]`` axis), and the reference's ``lax.scan``
over periods is a Python loop over that index.  Decode caches (GQA K/V,
MLA latents, Mamba states) are stacked the same way and are written in
place.

On a mesh (``dist.context.use_mesh``) `forward` takes DTensors (params
placed by ``sharding.param_shardings``, tokens by the batch spec) and
runs under ``implicit_replication``: the tensors it makes from shapes
alone (positions, masks, RoPE tables, zeros) are the same on every rank,
so taking them as replicated is exact.  With the weight-gather hook
armed, each period's FSDP-sharded weights are gathered as int8 inside the
period loop (and again in the backward's recompute), as the reference
does inside its scan.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.codecs.base import input_device
from repro_torch.core import kvcache as KVC
from repro_torch.core import weights as WQ
from repro_torch.dist.context import (constrain, mesh_compute,
                                      weight_gather_info)
from repro_torch.tree import tree_map

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import Split, dense_init, rms_norm, swiglu


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_position(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   device) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"pre_norm": torch.ones((d,), device=device)}
    if kind.startswith("attn"):
        p["attn"] = (attn.init_mla_params(gen, cfg, device) if cfg.mla else
                     attn.init_gqa_params(gen, cfg, device))
    else:
        p["mamba"] = ssm_mod.init_mamba_params(gen, cfg, device)
    if kind.endswith("+mlp"):
        p["mlp_norm"] = torch.ones((d,), device=device)
        p["mlp"] = {"w_up": dense_init(gen, (d, cfg.d_ff), device=device),
                    "w_down": dense_init(gen, (cfg.d_ff, d), device=device)}
        if cfg.mlp_gated:
            p["mlp"]["w_gate"] = dense_init(gen, (d, cfg.d_ff),
                                            device=device)
    elif kind.endswith("+moe"):
        p["mlp_norm"] = torch.ones((d,), device=device)
        p["moe"] = moe_mod.init_moe_params(gen, cfg, device)
    return p


def _stack(trees):
    """Stack a list of same-structured trees leaf by leaf (axis 0).  The
    leaves leave the input trees as they are stacked, so at most one
    leaf is held twice (a period-stacked MoE layer at full width is tens
    of GB)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return torch.stack(trees)


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Dict[str, Any]:
    """Random f32 parameters in the reference's tree layout, drawn from
    `gen` (default: seed 0 on `device`; none on the meta device).
    `device` defaults to CUDA (and raises without it); pass
    ``device="cpu"`` for the CPU.  The values are not the reference's
    (torch and JAX draw differently); carry the reference's weights over
    with `params_from_numpy`."""
    device = input_device(None, device)
    if gen is None and device.type != "meta":
        gen = torch.Generator(device).manual_seed(0)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), device=device,
                            std=0.02),
        "out_norm": torch.ones((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       device=device)
    params["layers"] = [_stack([_init_position(gen, cfg, kind, device)
                                for _ in range(cfg.n_periods)])
                        for kind in cfg.pattern]
    return params


def param_shapes(cfg: ModelConfig):
    """The parameter tree with `torch.Size` leaves and no allocation (drawn
    on the meta device)."""
    return tree_map(lambda t: t.shape, init_params(None, cfg, device="meta"))


def params_from_numpy(tree, device=None):
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's tree: the same
    leaf names and period-stacked layout, tensors on `device` (default
    CUDA).  bfloat16 arrays (ml_dtypes) keep their bits."""
    device = input_device(None, device)

    def leaf(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:        # jax hands out read-only views
            a = a.copy()
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return tree_map(leaf, tree)


#: leaves the reference reads in f32 whatever the compute dtype: the
#: Mamba decay, skip and step bias meet an f32 `dt`
_F32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


def cast_params(params, dtype: torch.dtype):
    """The tree with every matrix, embedding and bias in `dtype`, once.
    The reference casts weights inside each product (``w.astype(dt)``);
    casting the tree once gives the same numbers (a cast is
    deterministic) without re-reading the f32 weights every step.  Norm
    weights (``*norm``) and the Mamba leaves ``A_log``, ``D`` and
    ``dt_bias`` stay f32: the reference reads them in f32.  Leaves
    already in `dtype` are shared, not copied."""
    def go(t, key=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, key) for v in t)
        if key.endswith("norm") or key in _F32_LEAVES \
                or not t.is_floating_point():
            return t
        return t.to(dtype)

    return go(params)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _mlp(m, cfg: ModelConfig, h):
    if cfg.mlp_gated:
        return swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    u = h @ m["w_up"].to(h.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(u, approximate="tanh") @ m["w_down"].to(h.dtype)


def _period(layer, i: int):
    """Period `i`'s parameters of one pattern position (a view)."""
    return tree_map(lambda t: t[i], layer)


def _position_forward(p, cfg: ModelConfig, kind: str, x, pos):
    """One layer.  Returns (x, cache entry)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind.startswith("attn"):
        if cfg.mla:
            a, cache = attn.mla_forward(p["attn"], cfg, h, pos)
        else:
            a, cache = attn.gqa_forward(p["attn"], cfg, h, pos)
    else:
        a, cache = ssm_mod.mamba_forward(p["mamba"], cfg, h)
    x = x + a
    return _ffn(p, cfg, kind, x), cache


def _ffn(p, cfg: ModelConfig, kind: str, x):
    """The position's MLP or MoE half, with its residual."""
    if kind.endswith("+mlp"):
        return x + _mlp(p["mlp"], cfg, rms_norm(x, p["mlp_norm"],
                                                cfg.norm_eps))
    if kind.endswith("+moe"):
        return x + moe_mod.moe_forward(p["moe"], cfg,
                                       rms_norm(x, p["mlp_norm"],
                                                cfg.norm_eps))
    return x


def _unbind_periods(layer):
    """One pattern position's stacked parameters as a list of per-period
    trees (views)."""
    if isinstance(layer, dict):
        parts = {k: _unbind_periods(v) for k, v in layer.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(layer.unbind(0))


def _gathered(period_params, wg):
    """One period's per-position parameter trees with the int8 weight
    gather applied when the hook is armed on a mesh (`wg` is
    ``weight_gather_info()``)."""
    if wg is None:
        return period_params
    specs_tuple, mesh = wg
    return tuple(WQ.gather_dequant_tree(pp, sp, mesh)
                 for pp, sp in zip(period_params, specs_tuple))


def _period_forward(period_params, cfg: ModelConfig, x, pos, wg=None):
    """One period of every pattern position from its per-position
    parameter trees, without caches (the unit the training forward
    recomputes, the weight gather included)."""
    with mesh_compute():             # also when the backward recomputes
        for kind, p in zip(cfg.pattern, _gathered(period_params, wg)):
            x, _ = _position_forward(p, cfg, kind, x, pos)
        return constrain(x, "dp", None, None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_embed(embed, tokens):
    """``embed[tokens]`` of DTensors, rank by rank: each rank looks its
    own rows up in its own slice of the vocabulary (tokens outside it
    give zeros) and the slices' rows add across the axes that split the
    vocabulary.  The table is first gathered over any axis that splits
    the rows (FSDP).  At one rank it is the plain lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.context import sum_over_group

    mesh = embed.device_mesh
    tokens = constrain(tokens, "dp", None)
    rows = tokens.placements
    split_rows = [isinstance(r, Shard) for r in rows]
    pl = [Replicate() if sr else p for sr, p in zip(split_rows, embed.placements)]
    if list(embed.placements) != pl:
        embed = embed.redistribute(mesh, pl)
    # its gradient from these rows: partial over the row axes
    table = embed.to_local(grad_placements=[
        Partial() if sr else p for sr, p in zip(split_rows, pl)])
    vocab_dims = [i for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == 0]
    t = tokens.to_local()
    n = table.shape[0]
    offset = 0
    for i in vocab_dims:
        offset = offset * mesh.shape[i] + mesh.get_coordinate()[i]
    offset *= n
    inside = (t >= offset) & (t < offset + n)
    x = torch.where(inside[..., None], table[(t - offset).clamp(0, n - 1)],
                    torch.zeros((), dtype=table.dtype, device=t.device))
    for i in vocab_dims:
        x = sum_over_group(x, mesh.get_group(i))
    out = [Shard(0) if sr else (Shard(2) if isinstance(p, Shard)
                                and p.dim == 1 else Replicate())
           for sr, p in zip(split_rows, pl)]
    return DTensor.from_local(x, mesh, out, run_check=False)


def _stack_caches(per_period):
    """Per-period cache entries of one position -> stacked over periods
    (a (k, v) pair, an MLA latent or a MambaState)."""
    first = per_period[0]
    if not isinstance(first, tuple):
        return torch.stack(per_period)
    stacked = [torch.stack(c) for c in zip(*per_period)]
    return type(first)(*stacked) if hasattr(first, "_fields") \
        else tuple(stacked)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            compute_dtype=torch.bfloat16, collect_caches: bool = False,
            return_hidden: bool = False):
    """tokens: [B,S] integer.  extra: modality stubs (patch/frame embeds).
    Returns (logits [B,S_total,V] f32, caches or None); with
    return_hidden=True returns the post-norm hidden [B,S_total,D] instead
    of logits.  Caches, when collected, are per pattern position stacked
    over periods: a GQA (k, v) pair of [n_periods, B, S_total, KV, hd],
    an MLA latent [n_periods, B, S_total, kv_lora + rope] or a
    MambaState of [n_periods, B, ...].  With autograd recording and no
    caches collected, each period runs under activation checkpointing:
    the values are the same, the backward recomputes the period."""
    with mesh_compute():
        return _forward(params, cfg, tokens, extra, compute_dtype,
                        collect_caches, return_hidden)


def _forward(params, cfg: ModelConfig, tokens, extra, compute_dtype,
             collect_caches: bool, return_hidden: bool):
    wg = weight_gather_info()
    B, S = tokens.shape
    x = (_mesh_embed(params["embed"], tokens) if _is_dtensor(tokens)
         else params["embed"][tokens]).to(compute_dtype)
    if cfg.add_frame_embeds and extra and "frame_embeds" in extra:
        x = x + extra["frame_embeds"].to(compute_dtype)
    if cfg.n_prepend_embeds and extra and "patch_embeds" in extra:
        x = torch.cat([extra["patch_embeds"].to(compute_dtype), x], dim=1)
    S_total = x.shape[1]
    x = constrain(x, "dp", None, None)
    pos = torch.arange(S_total, device=x.device)[None, :].expand(B, S_total)

    caches = [[] for _ in cfg.pattern]
    # each period's views come from one unbind per stacked leaf, whose
    # backward stacks the periods' grads once (indexing per period would
    # add a zero-filled full-size grad per period and leaf)
    per_period = zip(*(_unbind_periods(layer) for layer in params["layers"]))
    # training: each period's activations are recomputed in the backward
    # (the reference's jax.checkpoint(period_body, nothing_saveable));
    # under no_grad (prefill) the forward runs as it is
    remat = torch.is_grad_enabled() and not collect_caches
    for period_params in per_period:
        if remat:
            x = checkpoint(_period_forward, period_params, cfg, x, pos, wg,
                           use_reentrant=False)
            continue
        period_params = _gathered(period_params, wg)
        for i, (kind, p) in enumerate(zip(cfg.pattern, period_params)):
            x, c = _position_forward(p, cfg, kind, x, pos)
            if collect_caches:
                caches[i].append(c)
        x = constrain(x, "dp", None, None)

    stacked = (tuple(_stack_caches(c) for c in caches)
               if collect_caches else None)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    if return_hidden:
        return x, stacked
    logits = x @ lm_head_of(params, cfg).to(compute_dtype)
    logits = constrain(logits, "dp", None, "model")
    return logits.float(), stacked


def lm_head_of(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeCaches(NamedTuple):
    """Tuple-aligned with cfg.pattern; each entry stacked over periods."""
    entries: Tuple[Any, ...]


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, compressed_kv: bool = False,
                device=None) -> DecodeCaches:
    """Empty decode caches, per pattern position stacked over periods: a
    GQA (k, v) pair of [n_periods, batch, s_max, KV, hd] buffers, an MLA
    latent [n_periods, batch, s_max, kv_lora + rope] (dense in `dtype` or
    as QuantKV: zeros, block scales at the floor) or a MambaState (f32
    SSM state, conv tail in `dtype`).  `device` defaults to CUDA."""
    device = input_device(None, device)
    nP = cfg.n_periods

    def buffer(shape):
        if compressed_kv:
            sc_shape = shape[:2] + (s_max // KVC.SEQ_BLOCK,) + shape[3:]
            return KVC.QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.full(sc_shape, KVC.SCALE_FLOOR, dtype=torch.float32,
                           device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    entries = []
    for kind in cfg.pattern:
        if kind.startswith("attn"):
            if cfg.mla:
                m = cfg.mla
                entries.append(buffer(
                    (nP, batch, s_max, m.kv_lora_rank + m.qk_rope_dim)))
            else:
                # K and V are separate buffers: the decode step writes in
                # place
                shape = (nP, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
                entries.append((buffer(shape), buffer(shape)))
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            H = d_in // s.head_dim
            entries.append(ssm_mod.MambaState(
                torch.zeros((nP, batch, H, s.d_state, s.head_dim),
                            dtype=torch.float32, device=device),
                torch.zeros((nP, batch, s.conv_kernel - 1,
                             d_in + 2 * s.d_state), dtype=dtype,
                            device=device)))
    return DecodeCaches(tuple(entries))


def clone_caches(caches: DecodeCaches) -> DecodeCaches:
    """A deep copy of the cache buffers (the decode step writes in
    place)."""
    return DecodeCaches(tree_map(lambda t: t.clone(), caches.entries))


def _period_cache(c, i: int):
    """Period `i`'s view of one stacked cache tensor, QuantKV or
    MambaState."""
    if isinstance(c, tuple):
        return type(c)(*(t[i] for t in c))
    return c[i]


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: DecodeCaches, cache_len,
                compute_dtype=torch.bfloat16, compressed_kv: bool = False):
    """token: [B,1] integer; caches as from init_caches/prefill.
    `cache_len`: the new token's position, an int or a 0-d or [B]
    integer tensor (one per row); a tensor on the device goes in as it
    is, with no host round trip.  Writes the new K/V, latents and Mamba
    states into `caches` IN PLACE.  Returns (logits [B,1,V] f32, caches).  A DTensor
    `token` takes the mesh decode (`mesh_decode_step`)."""
    if _is_dtensor(token):
        return mesh_decode_step(params, cfg, token, caches, cache_len,
                                compute_dtype, compressed_kv)
    x = params["embed"][token].to(compute_dtype)
    # an int position goes to the device once per step, not once per
    # layer; a device tensor is used as it is
    lens = torch.as_tensor(cache_len, device=x.device)
    for period in range(cfg.n_periods):
        for kind, layer, entry in zip(cfg.pattern, params["layers"],
                                      caches.entries):
            p = _period(layer, period)
            h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
            if not kind.startswith("attn"):
                st = _period_cache(entry, period)
                a, new = ssm_mod.mamba_decode(p["mamba"], cfg, h, st)
                st.h.copy_(new.h)
                st.conv.copy_(new.conv)
            elif cfg.mla:
                a, _ = attn.mla_decode(p["attn"], cfg, h,
                                       _period_cache(entry, period), lens,
                                       compressed=compressed_kv)
            else:
                ck, cv = entry
                a, _, _ = attn.gqa_decode(
                    p["attn"], cfg, h, _period_cache(ck, period),
                    _period_cache(cv, period), lens,
                    compressed=compressed_kv)
            x = _ffn(p, cfg, kind, x + a)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = x @ lm_head_of(params, cfg).to(compute_dtype)
    return logits.float(), caches


# ---------------------------------------------------------------------------
# decode on a mesh
# ---------------------------------------------------------------------------

def _gather_period(t, i: int):
    """Period `i` of the stacked DTensor `t` (its period dim is never
    split), gathered whole on this rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = t.device_mesh
    if all(n == 1 or not isinstance(p, Shard)
           for n, p in zip(mesh.shape, t.placements)):
        return t.to_local()[i]                # whole here already
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    one = DTensor.from_local(t.to_local()[i], t.device_mesh, pl,
                             run_check=False)
    return one.redistribute(t.device_mesh,
                            [Replicate()] * t.device_mesh.ndim).to_local()


def _split_of(t, dim: int) -> Optional[Split]:
    """This rank's slice of the DTensor `t` along `dim` when a mesh dim
    of more than one rank splits it, else None (the dim is whole
    here)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    on = [i for i, p in enumerate(t.placements)
          if isinstance(p, Shard) and p.dim == dim and mesh.shape[i] > 1]
    if not on:
        return None
    assert len(on) == 1, t.placements
    i = on[0]
    n = t.to_local().shape[dim]
    return Split(mesh.get_coordinate()[i] * n, mesh.get_group(i))


def mesh_decode_step(params, cfg: ModelConfig, token, caches: DecodeCaches,
                     cache_len, compute_dtype=torch.bfloat16,
                     compressed_kv: bool = False):
    """`decode_step` on a mesh, with the parameters placed FSDP
    (``sharding.param_shardings(fsdp=True)``) and the caches placed by
    ``sharding.cache_specs``; `token` [B, 1] is a DTensor placed by rows
    over the data-parallel axes (or replicated, for one long sequence).

    Each rank decodes its own rows.  The weights are gathered one layer
    at a time (the FSDP forward), never all at once; the caches stay
    where they are and are written IN PLACE: attention (GQA K/V, MLA
    latents) runs against each rank's slice of the sequence and
    completes its softmax across the ranks that split it, a Mamba state
    updates its own heads and conv channels.  Where no mesh dim splits
    a cache, its decode is the off-mesh one.  Returns (logits [B, 1, V]
    f32 placed by rows and, when the head splits it, vocabulary over
    "model", caches)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.context import use_mesh

    mesh = token.device_mesh
    params = cast_params(params, compute_dtype)
    rows = [isinstance(p, Shard) for p in token.placements]
    x = _mesh_embed(params["embed"], token).redistribute(
        mesh, [Shard(0) if r else Replicate() for r in rows])
    x = x.to_local().to(compute_dtype)
    lens = torch.as_tensor(cache_len, device=x.device)
    with use_mesh(None):
        for period in range(cfg.n_periods):
            for kind, layer, entry in zip(cfg.pattern, params["layers"],
                                          caches.entries):
                p = tree_map(lambda t: _gather_period(t, period), layer)
                h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
                a = _mesh_decode_mixer(p, cfg, kind, h, entry, period, lens,
                                       compressed_kv)
                x = _ffn(p, cfg, kind, x + a)
                del p
        norm = params["out_norm"].redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
        x = rms_norm(x, norm, cfg.norm_eps)
    return mesh_logits(params, cfg, x, rows, compute_dtype), caches


def mesh_logits(params, cfg: ModelConfig, x, rows, compute_dtype):
    """f32 logits of this rank's rows `x` [b, ..., D] (a plain tensor;
    `rows`: per mesh dim, whether it splits the rows) against the head
    gathered over every axis but the "model" axis that splits its
    vocabulary; placed by rows and, where the head splits it, vocabulary
    over "model" (the reference's ``(dp, "model")`` logits)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    head = lm_head_of(params, cfg)
    mesh = head.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim == 1
            and n == "model" else Replicate()
            for n, p in zip(mesh.mesh_dim_names, head.placements)]
    head = head.redistribute(mesh, keep).to_local()
    logits = (x @ head.to(compute_dtype)).float()
    out = [Shard(logits.dim() - 1) if isinstance(k, Shard) else
           (Shard(0) if r else Replicate()) for k, r in zip(keep, rows)]
    return DTensor.from_local(logits, mesh, out, run_check=False)


def _local_period(c, i: int):
    """Period `i`'s view of this rank's shard of a stacked cache DTensor
    (a QuantKV or MambaState field by field); writes land in the
    DTensor."""
    if isinstance(c, tuple):
        return type(c)(*(t.to_local()[i] for t in c))
    return c.to_local()[i]


def _mesh_decode_mixer(p, cfg: ModelConfig, kind: str, h, entry, period,
                       lens, compressed_kv: bool):
    """One position's attention or Mamba step of `mesh_decode_step`
    against its cache entry (DTensors placed by the cache rule)."""
    if not kind.startswith("attn"):
        st = _local_period(entry, period)
        a, new = ssm_mod.mamba_decode(p["mamba"], cfg, h, st,
                                      heads=_split_of(entry.h, 2),
                                      channels=_split_of(entry.conv, 3))
        st.h.copy_(new.h)
        st.conv.copy_(new.conv)
        return a
    first = entry if cfg.mla else entry[0]
    split = _split_of(first.q if compressed_kv else first, 2)
    if cfg.mla:
        return attn.mla_decode(p["attn"], cfg, h,
                               _local_period(entry, period), lens,
                               compressed=compressed_kv, split=split)[0]
    ck, cv = (_local_period(t, period) for t in entry)
    return attn.gqa_decode(p["attn"], cfg, h, ck, cv, lens,
                           compressed=compressed_kv, split=split)[0]
