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
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import kvcache as KVC

from .config import ModelConfig
from .layers import Split, apply_rope, dense_init, rms_norm

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
    shorter (the reference pads it and slices the padding off)."""
    Sq = q.shape[1]
    if Sq <= Q_BLOCK:
        return _flash(q, k, v, causal)
    return torch.cat([_flash(q[:, i:i + Q_BLOCK], k, v, causal, q_offset=i)
                      for i in range(0, Sq, Q_BLOCK)], dim=1)


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
    return torch.einsum("bshe,hed->bsd", o, p["wo"].to(o.dtype))


def _heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether a mesh block splits the query (and GQA key) heads over
    "model": only when every head count divides it."""
    from repro_torch.dist.sharding import mesh_shape

    msz = mesh_shape(mesh).get("model", 1)
    kv = cfg.n_kv_heads if cfg.mla is None else cfg.n_heads
    return msz > 1 and cfg.n_heads % msz == 0 and kv % msz == 0


def _head_dim(name: str, t) -> int:
    """The head dim of an attention weight (the one the sharding rules
    put on "model"), or None; an MLA low-rank projection has none."""
    from repro_torch.dist.sharding import _model_dim

    if name in ("wq_a", "wkv_a"):
        return None
    return _model_dim([name], t.dim())


def _mesh_block(p, cfg: ModelConfig, x, body):
    """An attention block of a DTensor x, rank by rank (the column- then
    row-parallel layout): each rank takes its own rows of x and, when
    `_heads_split`, its own heads of the weights (`local_weights`), runs
    ``body(weights, local x, split)`` (the off-mesh code on local
    tensors), which returns the output projection's operands ``(o,
    wo)`` and the cache entries; the output's partial sums over head
    groups add across "model".  At one rank the arithmetic is the
    off-mesh one, kernel for kernel.  Returns the output placed by rows
    and the cache entries placed by rows (and by heads when they have
    them and are split)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.context import (constrain, current_mesh,
                                          sum_over_group)

    from .layers import local_weights

    mesh = current_mesh()
    split = _heads_split(cfg, mesh)
    x = constrain(x, "dp", None, None)
    rows = [isinstance(pl, Shard) for pl in x.placements]
    on_model = [split and n == "model" for n in mesh.mesh_dim_names]
    w = local_weights(p, mesh, rows, on_model, _head_dim)
    # x's gradient from this rank's heads: partial over "model"
    xl = x.to_local(grad_placements=[
        Partial() if m else (Shard(0) if r else Replicate())
        for m, r in zip(on_model, rows)])
    (o, wo), entries = body(w, xl, split)
    if split:
        # partial sums in f32 (exact products of the operands), summed
        # across the head groups, rounded to the compute dtype once
        y = torch.einsum("bshe,hed->bsd", o.float(), wo.to(o.dtype).float())
        y = sum_over_group(y, mesh.get_group("model")).to(o.dtype)
    else:
        y = torch.einsum("bshe,hed->bsd", o, wo.to(o.dtype))
    by_rows = [Shard(0) if r else Replicate() for r in rows]

    def place(t):
        heads = split and t.dim() == 4
        return DTensor.from_local(t, mesh, [
            Shard(2) if heads and m else r
            for m, r in zip(on_model, by_rows)], run_check=False)

    return (DTensor.from_local(y, mesh, by_rows, run_check=False),
            tuple(place(t) for t in entries))


def gqa_forward(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill.  x: [B,S,D].  Returns (out, (k, v)) with k/v in
    cache layout [B, S, KV, hd]."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        def body(w, xl, split):
            q, k, v = _qkv(w, cfg, xl, pos[:xl.shape[0]])
            return (_flash_qblocked(q, k, v, causal=True), w["wo"]), (k, v)
        y, kv = _mesh_block(p, cfg, x, body)
        return y, kv
    q, k, v = _qkv(p, cfg, x, pos)
    o = _flash_qblocked(q, k, v, causal=True)
    return _out_proj(p, o), (k, v)


def gqa_decode(p, cfg: ModelConfig, x: torch.Tensor, cache_k, cache_v,
               cache_len: Union[int, torch.Tensor], compressed: bool = False,
               split: Optional[Split] = None):
    """One-token decode.  x: [B,1,D]; cache_k/v: [B,Smax,KV,hd] (or QuantKV
    when compressed).  `cache_len` is the position of the new token: an
    int for the whole batch or a [B] tensor, one per row (the
    continuous-batching scheduler's ragged slots).  The caches are
    written IN PLACE and returned: (out, cache_k, cache_v).

    `split` (the mesh decode): the caches are this rank's slice of a
    sequence split over ``split.group``, from position ``split.first``
    on.  The rank whose slice holds a row's position writes its K/V; the
    softmax and the probability-times-value sum are completed across
    the group."""
    dt = x.dtype
    B = x.shape[0]
    lens = torch.as_tensor(cache_len, device=x.device).to(torch.long)
    lens = lens.expand(B) if lens.dim() == 0 else lens
    q, k, v = _qkv(p, cfg, x, lens[:, None])
    _write_rows_(cache_k, k, lens, compressed, split)
    _write_rows_(cache_v, v, lens, compressed, split)
    if compressed:
        kf = KVC.kv_dequantize(cache_k, seq_axis=1, dtype=dt)
        vf = KVC.kv_dequantize(cache_v, seq_axis=1, dtype=dt)
    else:
        kf, vf = cache_k, cache_v

    Smax, KV = kf.shape[1], kf.shape[2]
    g = cfg.n_heads // KV
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qh = q.reshape(B, 1, KV, g, cfg.head_dim)
    s = torch.einsum("bqkgd,bskd->bqkgs", qh.float(), kf.float()) * scale
    valid = _valid(lens, Smax, split)[:, None, None, None, :]
    pattn = _softmax(s, valid, split)
    o = torch.einsum("bqkgs,bskd->bqkgd", pattn.to(dt).float(), vf.float())
    o = _summed(o, split)
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
    rope]).  On a mesh rank by rank (`_mesh_block`): the low-rank
    projections whole, the heads of the up-projections split."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        def body(w, xl, split):
            o, entry = _mla_attend(w, cfg, xl, pos[:xl.shape[0]])
            return (o, w["wo"]), (entry,)
        y, (entry,) = _mesh_block(p, cfg, x, body)
        return y, entry
    o, entry = _mla_attend(p, cfg, x, pos)
    return _out_proj(p, o), entry


def _mla_attend(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor):
    """MLA's attention output (before the output projection) over the
    heads of `p`, and the latent cache entry."""
    m = cfg.mla
    dt = x.dtype
    B, S, _ = x.shape
    q_nope, q_rope, entry = _mla_q_entry(p, cfg, x, pos)
    latent, k_rope = entry.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    k_nope = torch.einsum("bsr,rhe->bshe", latent, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhe->bshe", latent, p["wv_b"].to(dt))
    k_rope_b = k_rope[:, :, None, :].expand(B, S, q_nope.shape[2],
                                            m.qk_rope_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope_b], dim=-1)
    return _flash_qblocked(qf, kf, v, causal=True), entry


def mla_decode(p, cfg: ModelConfig, x: torch.Tensor, cache,
               cache_len: Union[int, torch.Tensor], compressed: bool = False,
               split: Optional[Split] = None):
    """One-token decode.  x: [B,1,D]; cache: the [B, Smax, kv_lora+rope]
    latent cache (MLA's whole point: ~576 values per token), or its
    QuantKV form when `compressed` — the blockwise-int8 codec of the GQA
    cache, layered on the latent.  `cache_len` is the new token's
    position: an int or a [B] tensor, one per row.  The cache is written
    IN PLACE and returned: (out, cache).  `split`: a sequence-split
    latent cache, as in `gqa_decode`."""
    m = cfg.mla
    dt = x.dtype
    B = x.shape[0]
    lens = torch.as_tensor(cache_len, device=x.device).to(torch.long)
    lens = lens.expand(B) if lens.dim() == 0 else lens
    q_nope, q_rope, entry = _mla_q_entry(p, cfg, x, lens[:, None])
    _write_rows_(cache, entry, lens, compressed, split)
    cache_f = (KVC.kv_dequantize(cache, seq_axis=1, dtype=dt) if compressed
               else cache)

    lat_c = cache_f[..., :m.kv_lora_rank]
    kr_c = cache_f[..., m.kv_lora_rank:]
    k_nope = torch.einsum("bsr,rhe->bshe", lat_c, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhe->bshe", lat_c, p["wv_b"].to(dt))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    s = torch.einsum("bqhe,bshe->bqhs", q_nope.float(), k_nope.float())
    s = s + torch.einsum("bqhe,bse->bqhs", q_rope.float(), kr_c.float())
    s = s * scale
    valid = _valid(lens, cache_f.shape[1], split)[:, None, None, :]
    pattn = _softmax(s, valid, split)
    o = torch.einsum("bqhs,bshe->bqhe", pattn.to(dt).float(), v.float())
    o = _summed(o, split)
    return _out_proj(p, o.to(dt)), cache


# ---------------------------------------------------------------------------
# decode: the cache write and the softmax, whole or sequence-split
# ---------------------------------------------------------------------------

def _write_rows_(cache, new, lens, compressed: bool, split: Optional[Split]):
    """Write `new` [B, 1, ...] at each row's position `lens` into the
    cache, IN PLACE.  Under `split` the cache is this rank's slice and
    only the rank whose slice holds a row's position changes that row;
    the other ranks keep theirs (the same shapes on every rank, no
    data-dependent indexing)."""
    B = new.shape[0]
    rows = torch.arange(B, device=new.device)
    if split is None:
        if compressed:
            KVC.kv_update_block_(cache, new, lens, seq_axis=1)
        else:
            cache[rows, lens] = new[:, 0]
        return
    S_l = (cache.q if compressed else cache).shape[1]
    local = lens - split.first
    mine = (local >= 0) & (local < S_l)
    pos = local.clamp(0, S_l - 1)
    if not compressed:
        old = cache[rows, pos]
        keep = (~mine).reshape((B,) + (1,) * (old.dim() - 1))
        cache[rows, pos] = torch.where(keep, old, new[:, 0].to(cache.dtype))
        return
    q, scale = cache.q, cache.scale
    blk = pos // KVC.SEQ_BLOCK
    qb = q.unflatten(1, (S_l // KVC.SEQ_BLOCK, KVC.SEQ_BLOCK))
    old_q, old_s = qb[rows, blk].clone(), scale[rows, blk].clone()
    KVC.kv_update_block_(cache, new, pos, seq_axis=1)
    keep_s = (~mine).reshape((B,) + (1,) * (old_s.dim() - 1))
    qb[rows, blk] = torch.where(keep_s[:, None], old_q, qb[rows, blk])
    scale[rows, blk] = torch.where(keep_s, old_s, scale[rows, blk])


def _valid(lens, S: int, split: Optional[Split]):
    """[B, S]: which of the cache's S positions (from ``split.first``
    on, under `split`) each row attends to."""
    pos = torch.arange(S, device=lens.device)
    if split is not None:
        pos = split.first + pos
    return pos[None, :] <= lens[:, None]


def _softmax(s, valid, split: Optional[Split]):
    """softmax over the last dim of the scores `s` at the `valid` keys.
    Under `split` each rank of ``split.group`` holds its own slice of
    the keys: the global max and sum by all-reduce, then this slice's
    probabilities."""
    import torch.distributed as dist

    s = s.masked_fill(~valid, -math.inf)
    if split is None:
        return torch.softmax(s, dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=split.group)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    dist.all_reduce(denom, group=split.group)
    return p / denom


def _summed(t, split: Optional[Split]):
    """`t` summed over ``split.group`` (in place), or `t` itself."""
    import torch.distributed as dist

    if split is not None:
        dist.all_reduce(t, group=split.group)
    return t
