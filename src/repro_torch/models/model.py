"""The LM: embedding -> loop over layer periods -> norm -> logits.

The dense GQA path of the reference's `repro.models.model` (the
``attn+mlp`` pattern: qwen, granite, phi-3-vision and musicgen
backbones), with the reference's parameter tree: ``params["layers"][i]``
holds pattern position i's leaves stacked over periods (leading
``[n_periods]`` axis), and the reference's ``lax.scan`` over periods is a
Python loop over that index.  Decode caches are stacked the same way and
are written in place.

MoE, MLA and Mamba/SSM layers are the next slice of the port: a config
that needs them raises `NotImplementedError` at every entry point here.
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
from .config import ModelConfig
from .layers import dense_init, rms_norm, swiglu


def require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: MoE, MLA and Mamba/SSM
    layers are the next slice (ROADMAP §1)."""
    kinds = set(cfg.pattern)
    if cfg.mla is not None or cfg.moe is not None \
            or kinds - {"attn+mlp"}:
        raise NotImplementedError(
            f"{cfg.name}: MoE, MLA and Mamba/SSM layers (pattern "
            f"{cfg.pattern}) are the next slice of the PyTorch port; this "
            f"slice runs dense GQA models ('attn+mlp' layers only)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_position(gen: torch.Generator, cfg: ModelConfig, device
                   ) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {
        "pre_norm": torch.ones((d,), device=device),
        "attn": attn.init_gqa_params(gen, cfg, device),
        "mlp_norm": torch.ones((d,), device=device),
        "mlp": {"w_up": dense_init(gen, (d, cfg.d_ff), device=device),
                "w_down": dense_init(gen, (cfg.d_ff, d), device=device)},
    }
    if cfg.mlp_gated:
        p["mlp"]["w_gate"] = dense_init(gen, (d, cfg.d_ff), device=device)
    return p


def _stack(trees):
    """Stack a list of same-structured trees leaf by leaf (axis 0)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Dict[str, Any]:
    """Random f32 parameters in the reference's tree layout, drawn from
    `gen` (default: seed 0 on `device`; none on the meta device).
    `device` defaults to CUDA (and raises without it); pass
    ``device="cpu"`` for the CPU.  The values are not the reference's
    (torch and JAX draw differently); carry the reference's weights over
    with `params_from_numpy`."""
    require_dense(cfg)
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
    params["layers"] = [_stack([_init_position(gen, cfg, device)
                                for _ in range(cfg.n_periods)])
                        for _ in cfg.pattern]
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


def cast_params(params, dtype: torch.dtype):
    """The tree with every matrix, embedding and bias in `dtype`, once.
    The reference casts weights inside each product (``w.astype(dt)``);
    casting the tree once gives the same numbers (a cast is
    deterministic) without re-reading the f32 weights every step.  Norm
    weights (``*norm``) stay f32: `rms_norm` reads them in f32.  Leaves
    already in `dtype` are shared, not copied."""
    def go(t, key=""):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, key) for v in t)
        if key.endswith("norm") or not t.is_floating_point():
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


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            compute_dtype=torch.bfloat16, collect_caches: bool = False,
            return_hidden: bool = False):
    """tokens: [B,S] integer.  extra: modality stubs (patch/frame embeds).
    Returns (logits [B,S_total,V] f32, caches or None); with
    return_hidden=True returns the post-norm hidden [B,S_total,D] instead
    of logits.  Caches, when collected, are per pattern position a (k, v)
    pair stacked over periods: [n_periods, B, S_total, KV, hd]."""
    require_dense(cfg)
    if weight_gather_info() is not None:
        raise NotImplementedError("weight-gather compression needs a mesh")
    B, S = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    if cfg.add_frame_embeds and extra and "frame_embeds" in extra:
        x = x + extra["frame_embeds"].to(compute_dtype)
    if cfg.n_prepend_embeds and extra and "patch_embeds" in extra:
        x = torch.cat([extra["patch_embeds"].to(compute_dtype), x], dim=1)
    S_total = x.shape[1]
    x = constrain(x, "dp", None, None)
    pos = torch.arange(S_total, device=x.device)[None, :].expand(B, S_total)

    caches = [([], []) for _ in cfg.pattern]
    for period in range(cfg.n_periods):
        for i, layer in enumerate(params["layers"]):
            p = _period(layer, period)
            h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
            a, (k, v) = attn.gqa_forward(p["attn"], cfg, h, pos)
            if collect_caches:
                caches[i][0].append(k)
                caches[i][1].append(v)
            x = x + a
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            x = x + _mlp(p["mlp"], cfg, h)
        x = constrain(x, "dp", None, None)

    stacked = (tuple((torch.stack(ks), torch.stack(vs)) for ks, vs in caches)
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
    """Empty decode caches: per pattern position a (k, v) pair of
    [n_periods, batch, s_max, KV, hd] buffers, dense in `dtype` or as
    QuantKV (zeros, block scales at the floor).  `device` defaults to
    CUDA."""
    require_dense(cfg)
    device = input_device(None, device)
    shape = (cfg.n_periods, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    entries = []
    for _ in cfg.pattern:
        if compressed_kv:
            sc_shape = shape[:2] + (s_max // KVC.SEQ_BLOCK,) + shape[3:]

            def one():
                return KVC.QuantKV(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.full(sc_shape, KVC.SCALE_FLOOR,
                               dtype=torch.float32, device=device))
        else:
            def one():
                return torch.zeros(shape, dtype=dtype, device=device)
        # K and V are separate buffers: the decode step writes in place
        entries.append((one(), one()))
    return DecodeCaches(tuple(entries))


def clone_caches(caches: DecodeCaches) -> DecodeCaches:
    """A deep copy of the cache buffers (the decode step writes in
    place)."""
    return DecodeCaches(_map(lambda t: t.clone(), caches.entries))


def _period_cache(c, i: int):
    if isinstance(c, KVC.QuantKV):
        return KVC.QuantKV(c.q[i], c.scale[i])
    return c[i]


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: DecodeCaches, cache_len,
                compute_dtype=torch.bfloat16, compressed_kv: bool = False):
    """token: [B,1] integer; caches as from init_caches/prefill.
    `cache_len`: the new token's position, an int or a [B] tensor (one
    per row).  Writes the new K/V into `caches` IN PLACE.  Returns
    (logits [B,1,V] f32, caches)."""
    require_dense(cfg)
    x = params["embed"][token].to(compute_dtype)
    # the positions go to the device once per step, not once per layer
    lens = torch.as_tensor(cache_len, device=x.device)
    for period in range(cfg.n_periods):
        for i, layer in enumerate(params["layers"]):
            p = _period(layer, period)
            ck, cv = caches.entries[i]
            h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
            a, _, _ = attn.gqa_decode(
                p["attn"], cfg, h, _period_cache(ck, period),
                _period_cache(cv, period), lens,
                compressed=compressed_kv)
            x = x + a
            hm = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            x = x + _mlp(p["mlp"], cfg, hm)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = x @ lm_head_of(params, cfg).to(compute_dtype)
    return logits.float(), caches
