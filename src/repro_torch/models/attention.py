"""Attention: GQA/MQA (+qk_norm, +qkv bias), MLA (deepseek-v2), with a
flash-style blocked implementation for long sequences and a decode path
against (optionally int8-compressed) KV caches.

As in the reference, the blocked "flash-scan" is plain tensor code: a
loop over KV blocks with an online softmax, no attention kernel.  The
score and probability-times-value products take bf16 operands and keep
f32 results (the reference's ``preferred_element_type=float32``): the
operands are upcast to f32 for those products, which is exact, since a
bf16 x bf16 product is representable in f32.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from repro_torch.core import kvcache as KVC

from .config import ModelConfig
from .layers import apply_rope, dense_init, rms_norm

Q_BLOCK = 1024
KV_BLOCK = 1024


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_gqa_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    device = device if device is not None else gen.device
    p = {
        "wq": dense_init(gen, (d, h, hd), device=device),
        "wk": dense_init(gen, (d, kv, hd), device=device),
        "wv": dense_init(gen, (d, kv, hd), device=device),
        "wo": dense_init(gen, (h, hd, d), in_axis=(0, 1), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((kv, hd), device=device)
        p["bv"] = torch.zeros((kv, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def init_mla_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    device = device if device is not None else gen.device
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), device=device),
        "wq_b": dense_init(gen, (m.q_lora_rank, h,
                                 m.qk_nope_dim + m.qk_rope_dim),
                           device=device),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_dim),
                            device=device),
        "wk_b": dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_dim),
                           device=device),
        "wv_b": dense_init(gen, (m.kv_lora_rank, h, m.v_head_dim),
                           device=device),
        "wo": dense_init(gen, (h, m.v_head_dim, d), in_axis=(0, 1),
                         device=device),
    }


# ---------------------------------------------------------------------------
# flash-scan core
# ---------------------------------------------------------------------------

def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           q_offset: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention.

    q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] (KV divides H).  Returns
    [B, Sq, H, hd].  Memory is O(Sq·KV_BLOCK) per step instead of
    O(Sq·Sk).  A query row whose every key is masked gets zeros."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    vd = v.shape[-1]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    nkb = -(-Sk // KV_BLOCK)
    dev = q.device
    qh = q.reshape(B, Sq, KV, g, hd).float()
    q_pos = torch.arange(Sq, device=dev) + q_offset             # [Sq]
    acc = torch.zeros((B, Sq, KV, g, vd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KV, g), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, KV, g), dtype=torch.float32, device=dev)
    for bi in range(nkb):
        # the reference zero-pads K/V to whole blocks; the padded keys
        # are masked, so the last block is simply the shorter slice here
        # with the same mask arithmetic over the full block width
        kblk = k[:, bi * KV_BLOCK:(bi + 1) * KV_BLOCK]
        vblk = v[:, bi * KV_BLOCK:(bi + 1) * KV_BLOCK]
        c = kblk.shape[1]
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, kblk.float()) * scale
        k_pos = bi * KV_BLOCK + torch.arange(c, device=dev)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, c), dtype=torch.bool, device=dev)
        s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(B, Sq, H, vd).to(q.dtype)


def _flash_qblocked(q, k, v, causal):
    """Outer loop over query blocks keeps the online-softmax state small
    for very long prefill (32k+).  A last partial block is simply
    shorter (the reference pads it and slices the padding off).  On a
    mesh (DTensor q, k, v) each rank attends its own rows and heads."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _mesh_flash(q, k, v, causal)
    Sq = q.shape[1]
    if Sq <= Q_BLOCK:
        return _flash(q, k, v, causal)
    return torch.cat([_flash(q[:, i:i + Q_BLOCK], k, v, causal, q_offset=i)
                      for i in range(0, Sq, Q_BLOCK)], dim=1)


def _mesh_flash(q, k, v, causal):
    """Attention of DTensors, rank by rank: batch rows over the
    data-parallel axes, query and key heads over "model" when both head
    counts divide it (else whole on every rank), so every rank holds
    whole (row, key-head group) problems and the blocked loop runs on its
    local shards, exactly as off-mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.context import constrain, current_mesh
    from repro_torch.dist.sharding import mesh_shape

    msz = mesh_shape(current_mesh()).get("model", 1)
    heads = "model" if q.shape[2] % msz == 0 and k.shape[2] % msz == 0 \
        else None
    q, k, v = (constrain(t, "dp", None, heads, None) for t in (q, k, v))
    out = _flash_qblocked(q.to_local(), k.to_local(), v.to_local(), causal)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


# ---------------------------------------------------------------------------
# GQA/MQA
# ---------------------------------------------------------------------------

def _qkv(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor):
    """Projections, bias, qk-norm and RoPE shared by prefill and decode."""
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dke->bske", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dke->bske", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta), v)


def _out_proj(p, o: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(o, DTensor):
        return _mesh_out_proj(o, p["wo"].to(o.dtype))
    return torch.einsum("bshe,hed->bsd", o, p["wo"].to(o.dtype))


def _mesh_out_proj(o, wo):
    """The output projection of DTensors: each rank contracts its own rows
    and heads with the local einsum (the off-mesh arithmetic), and the
    per-rank partial sums over head groups add across "model".  DTensor's
    own einsum would flatten a head dim it cannot flatten sharded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.context import (constrain, current_mesh,
                                          sum_over_group)
    from repro_torch.dist.sharding import P, mesh_shape, placements

    mesh = current_mesh()
    msz = mesh_shape(mesh).get("model", 1)
    heads = "model" if o.shape[2] % msz == 0 and msz > 1 else None
    o = constrain(o, "dp", None, heads, None)
    wo = wo.redistribute(mesh, placements(P(heads), mesh, wo.dim()))
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in o.placements]
    # wo's gradient from this rank's rows: partial over the row axes
    wo_l = wo.to_local(grad_placements=[
        Partial() if isinstance(r, Shard) else pl
        for r, pl in zip(rows, wo.placements)])
    o_l = o.to_local()
    if heads is None:
        y = torch.einsum("bshe,hed->bsd", o_l, wo_l)
    else:
        # partial sums in f32 (exact products of the operands), summed
        # across the head groups, rounded to the compute dtype once
        y = torch.einsum("bshe,hed->bsd", o_l.float(), wo_l.float())
        y = sum_over_group(y, mesh.get_group("model")).to(o.dtype)
    return DTensor.from_local(y, mesh, rows, run_check=False)


def gqa_forward(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill.  x: [B,S,D].  Returns (out, (k, v)) with k/v in
    cache layout [B, S, KV, hd]."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _mesh_gqa_forward(p, cfg, x, pos)
    q, k, v = _qkv(p, cfg, x, pos)
    o = _flash_qblocked(q, k, v, causal=True)
    return _out_proj(p, o), (k, v)


def _mesh_gqa_forward(p, cfg: ModelConfig, x, pos):
    """The GQA block of a DTensor x, rank by rank (the column- then
    row-parallel layout): each rank takes its own rows of x and, when both
    head counts divide "model", its own query and key heads of the
    weights; projects, attends and projects back with the off-mesh code on
    local tensors; the output's partial sums over head groups add across
    "model".  At one rank the arithmetic is the off-mesh one, kernel for
    kernel.  Returns the output placed by rows and K / V placed by rows
    and heads."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.context import constrain, current_mesh, \
        sum_over_group
    from repro_torch.dist.sharding import _model_dim

    mesh = current_mesh()
    names = mesh.mesh_dim_names
    msz = dict(zip(names, mesh.shape)).get("model", 1)
    split = msz > 1 and cfg.n_heads % msz == 0 and cfg.n_kv_heads % msz == 0
    x = constrain(x, "dp", None, None)
    rows = [Shard(0) if isinstance(pl, Shard) else Replicate()
            for pl in x.placements]
    on_model = [split and n == "model" for n in names]

    def local(name, t):
        """This rank's heads of one weight leaf (its head dim is the one
        the sharding rules put on "model"); its gradient from these rows
        is a partial sum over the row axes."""
        hd = _model_dim([name], t.dim())
        pl = [Shard(hd) if m and hd is not None else Replicate()
              for m in on_model]
        t = t.redistribute(mesh, pl)
        return t.to_local(grad_placements=[
            Partial() if isinstance(r, Shard) else q for r, q in zip(rows,
                                                                     pl)])

    w = {k: local(k, v) for k, v in p.items()}
    # x's gradient from this rank's heads: partial over "model"
    xl = x.to_local(grad_placements=[Partial() if m else r
                                     for m, r in zip(on_model, rows)])
    pl_ = pos.to_local() if isinstance(pos, DTensor) else pos[:xl.shape[0]]
    q, k, v = _qkv(w, cfg, xl, pl_)
    o = _flash_qblocked(q, k, v, causal=True)
    if split:
        # partial sums in f32 (exact products of the operands), summed
        # across the head groups, rounded to the compute dtype once
        y = torch.einsum("bshe,hed->bsd", o.float(), w["wo"].to(o.dtype)
                         .float())
        y = sum_over_group(y, mesh.get_group("model")).to(o.dtype)
    else:
        y = _out_proj(w, o)
    by_heads = [Shard(2) if m else r for m, r in zip(on_model, rows)]
    return (DTensor.from_local(y, mesh, rows, run_check=False),
            tuple(DTensor.from_local(t, mesh, by_heads, run_check=False)
                  for t in (k, v)))


def gqa_decode(p, cfg: ModelConfig, x: torch.Tensor, cache_k, cache_v,
               cache_len: Union[int, torch.Tensor], compressed: bool = False):
    """One-token decode.  x: [B,1,D]; cache_k/v: [B,Smax,KV,hd] (or QuantKV
    when compressed).  `cache_len` is the position of the new token: an
    int for the whole batch or a [B] tensor, one per row (the
    continuous-batching scheduler's ragged slots).  The caches are
    written IN PLACE and returned: (out, cache_k, cache_v)."""
    dt = x.dtype
    B = x.shape[0]
    lens = torch.as_tensor(cache_len, device=x.device).to(torch.long)
    lens = lens.expand(B) if lens.dim() == 0 else lens
    q, k, v = _qkv(p, cfg, x, lens[:, None])
    rows = torch.arange(B, device=x.device)
    if compressed:
        KVC.kv_update_block_(cache_k, k, lens, seq_axis=1)
        KVC.kv_update_block_(cache_v, v, lens, seq_axis=1)
        kf = KVC.kv_dequantize(cache_k, seq_axis=1, dtype=dt)
        vf = KVC.kv_dequantize(cache_v, seq_axis=1, dtype=dt)
    else:
        cache_k[rows, lens] = k[:, 0]
        cache_v[rows, lens] = v[:, 0]
        kf, vf = cache_k, cache_v

    Smax, KV = kf.shape[1], kf.shape[2]
    g = cfg.n_heads // KV
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qh = q.reshape(B, 1, KV, g, cfg.head_dim)
    s = torch.einsum("bqkgd,bskd->bqkgs", qh.float(), kf.float()) * scale
    valid = torch.arange(Smax, device=x.device)[None, :] <= lens[:, None]
    s = s.masked_fill(~valid[:, None, None, None, :], -math.inf)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", pattn.to(dt).float(), vf.float())
    o = o.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(dt)
    return _out_proj(p, o), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): the latent IS the cache
# ---------------------------------------------------------------------------

def _mla_q_entry(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor):
    """Queries (nope and RoPE'd rope parts) and the cache entry
    ``[latent, RoPE'd k_rope]`` [B, S, kv_lora + rope] of x [B,S,D]."""
    m = cfg.mla
    dt = x.dtype
    ql = x @ p["wq_a"].to(dt)
    q = torch.einsum("bsr,rhe->bshe", ql, p["wq_b"].to(dt))
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    kv_a = x @ p["wkv_a"].to(dt)
    latent, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, torch.cat([latent, k_rope], dim=-1)


def mla_forward(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor):
    """Training / prefill.  Returns (out, latent cache [B, S, kv_lora +
    rope])."""
    m = cfg.mla
    dt = x.dtype
    B, S, _ = x.shape
    q_nope, q_rope, entry = _mla_q_entry(p, cfg, x, pos)
    latent, k_rope = entry.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    k_nope = torch.einsum("bsr,rhe->bshe", latent, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhe->bshe", latent, p["wv_b"].to(dt))
    k_rope_b = k_rope[:, :, None, :].expand(B, S, cfg.n_heads,
                                            m.qk_rope_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope_b], dim=-1)
    o = _flash_qblocked(qf, kf, v, causal=True)
    return _out_proj(p, o), entry


def mla_decode(p, cfg: ModelConfig, x: torch.Tensor, cache,
               cache_len: Union[int, torch.Tensor], compressed: bool = False):
    """One-token decode.  x: [B,1,D]; cache: the [B, Smax, kv_lora+rope]
    latent cache (MLA's whole point: ~576 values per token), or its
    QuantKV form when `compressed` — the blockwise-int8 codec of the GQA
    cache, layered on the latent.  `cache_len` is the new token's
    position: an int or a [B] tensor, one per row.  The cache is written
    IN PLACE and returned: (out, cache)."""
    m = cfg.mla
    dt = x.dtype
    B = x.shape[0]
    lens = torch.as_tensor(cache_len, device=x.device).to(torch.long)
    lens = lens.expand(B) if lens.dim() == 0 else lens
    q_nope, q_rope, entry = _mla_q_entry(p, cfg, x, lens[:, None])
    if compressed:
        KVC.kv_update_block_(cache, entry, lens, seq_axis=1)
        cache_f = KVC.kv_dequantize(cache, seq_axis=1, dtype=dt)
    else:
        cache[torch.arange(B, device=x.device), lens] = entry[:, 0]
        cache_f = cache

    lat_c = cache_f[..., :m.kv_lora_rank]
    kr_c = cache_f[..., m.kv_lora_rank:]
    k_nope = torch.einsum("bsr,rhe->bshe", lat_c, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhe->bshe", lat_c, p["wv_b"].to(dt))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    s = torch.einsum("bqhe,bshe->bqhs", q_nope.float(), k_nope.float())
    s = s + torch.einsum("bqhe,bse->bqhs", q_rope.float(), kr_c.float())
    s = s * scale
    Smax = cache_f.shape[1]
    valid = torch.arange(Smax, device=x.device)[None, :] <= lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhs,bshe->bqhe", pattn.to(dt).float(), v.float())
    return _out_proj(p, o.to(dt)), cache
