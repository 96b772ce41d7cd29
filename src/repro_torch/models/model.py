"""The LM: embedding -> loop over layer periods -> norm -> logits.

The reference's `repro.models.model`: one implementation covers all ten
architectures through the config's layer-kind `pattern` (dense GQA,
MoE, MLA, Mamba2 and the hybrid), with the reference's parameter tree:
``params["layers"][i]`` holds pattern position i's leaves stacked over
periods (leading ``[n_periods]`` axis), and the reference's ``lax.scan``
over periods is a Python loop over that index.  Decode caches (GQA K/V,
MLA latents, Mamba states) are stacked the same way and are written in
place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.codecs.base import input_device
from repro_torch.core import kvcache as KVC
from repro_torch.dist.context import constrain, weight_gather_info

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import dense_init, rms_norm, swiglu


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
    return _map(lambda t: t.shape, init_params(None, cfg, device="meta"))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))      # NamedTuple
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


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

    return _map(leaf, tree)


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
    return _map(lambda t: t[i], layer)


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
    MambaState of [n_periods, B, ...]."""
    if weight_gather_info() is not None:
        raise NotImplementedError("weight-gather compression needs a mesh: "
                                  "the distribution slice of the port "
                                  "(ROADMAP §1.3)")
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    if cfg.add_frame_embeds and extra and "frame_embeds" in extra:
        x = x + extra["frame_embeds"].to(compute_dtype)
    if cfg.n_prepend_embeds and extra and "patch_embeds" in extra:
        x = torch.cat([extra["patch_embeds"].to(compute_dtype), x], dim=1)
    S_total = x.shape[1]
    x = constrain(x, "dp", None, None)
    pos = torch.arange(S_total, device=x.device)[None, :].expand(B, S_total)

    caches = [[] for _ in cfg.pattern]
    for period in range(cfg.n_periods):
        for i, (kind, layer) in enumerate(zip(cfg.pattern,
                                              params["layers"])):
            x, c = _position_forward(_period(layer, period), cfg, kind, x,
                                     pos)
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
    return DecodeCaches(_map(lambda t: t.clone(), caches.entries))


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
    `cache_len`: the new token's position, an int or a [B] tensor (one
    per row).  Writes the new K/V, latents and Mamba states into
    `caches` IN PLACE.  Returns (logits [B,1,V] f32, caches)."""
    x = params["embed"][token].to(compute_dtype)
    # the positions go to the device once per step, not once per layer
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
