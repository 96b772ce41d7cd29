"""Train step: chunked CE loss -> (microbatched) grads -> optional
PREQUANT-compressed cross-pod gradient mean -> AdamW, on one device.

The reference's `repro.train.train_step` without a mesh: its off-mesh
branches (the `current_mesh() is None` path) on the port's model stack.
In compressed mode the batch keeps a leading pod axis [npods, B/npods, S];
the reference computes per-pod grads with `jax.vmap` over it, the port
with a loop over the pods, and both reduce them with
`core.gradient.compressed_psum_mean`.  The AdamW update writes params and
moments in place, so `step` returns the trees it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import gradient as G
from repro_torch.core import weights as W
from repro_torch.dist.context import (constrain_like_params, current_mesh,
                                      dp_axes_override, use_a2a_compress,
                                      use_weight_compress)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaves, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_compress: str = "none"      # 'none' | 'int8' | 'int16'
    weight_compress: str = "none"    # 'none' | 'int8' (FSDP gather path)
    a2a_compress: str = "none"       # 'none' | 'int8' (MoE dispatch/combine)
    npods: int = 1
    accum_dtype: Any = torch.float32  # bf16 for the 300B+ configs
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()


CE_CHUNK = 1024      # sequence positions per CE chunk


def _ce_chunk(xi, head, ti, vi):
    """One chunk's summed cross-entropy: lse minus the target logit (a
    gather: the reference's one-hot contraction has one non-zero term)."""
    lg = (xi @ head).float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt_logit = lg.gather(-1, ti[..., None]).squeeze(-1)
    return torch.sum((lse - tgt_logit) * vi)


def loss_fn(params, cfg: ModelConfig, tokens, extra=None):
    """Chunked cross-entropy: the [B,S,V] logits are never materialized.
    Positions are padded to whole CE_CHUNKs, each chunk projects and
    reduces under activation checkpointing (recomputed in the backward),
    and the chunk sums add in order, as in the reference."""
    hidden, _ = M.forward(params, cfg, tokens, extra, return_hidden=True)
    hidden = hidden[:, cfg.n_prepend_embeds:, :]
    head = M.lm_head_of(params, cfg).to(hidden.dtype)
    B, S, D = hidden.shape
    n = S - 1
    nchunks = max(1, -(-n // CE_CHUNK))
    pad = nchunks * CE_CHUNK - n
    x = F.pad(hidden[:, :-1, :], (0, 0, 0, pad))
    tgt = F.pad(tokens[:, 1:].long(), (0, pad))
    valid = F.pad(torch.ones((B, n), dtype=torch.float32,
                             device=hidden.device), (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nchunks):
        sl = slice(c * CE_CHUNK, (c + 1) * CE_CHUNK)
        args = (x[:, sl], head, tgt[:, sl], valid[:, sl])
        part = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _ce_chunk(*args))
        tot = tot + part
    return tot / (B * n)


def _value_and_grad(params, cfg: ModelConfig, tokens, extra):
    """(loss, grads) of `loss_fn` with respect to every floating leaf of
    `params` (zeros for a leaf the loss does not reach, as JAX gives)."""
    flat = leaves(params)
    req = [p.detach().requires_grad_() if p.is_floating_point() else p
           for p in flat]
    loss = loss_fn(rebuild(params, iter(req)), cfg, tokens, extra)
    wrt = [r for r in req if r.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, materialize_grads=True))
    grads = [next(got) if r.requires_grad else torch.zeros_like(r)
             for r in req]
    return loss.detach(), rebuild(params, iter(grads))


def _split_extra(extra, nmb: int, i: int):
    if not extra:
        return None
    return {k: a.reshape(nmb, a.shape[0] // nmb, *a.shape[1:])[i]
            for k, a in extra.items()}


def _microbatched_grads(params, cfg: ModelConfig, tcfg: TrainConfig,
                        tokens, extra):
    """Returns (loss, grads) averaged over microbatches; the grads sum in
    `tcfg.accum_dtype`."""
    nmb = tcfg.microbatches
    if nmb == 1:
        loss, g = _value_and_grad(params, cfg, tokens, extra)
        return loss, constrain_like_params(g)
    B = tokens.shape[0]
    assert B % nmb == 0, (B, nmb)
    tmb = tokens.reshape(nmb, B // nmb, *tokens.shape[1:])
    acc_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    acc_g = constrain_like_params(tree_map(
        lambda p: torch.zeros(p.shape, dtype=tcfg.accum_dtype,
                              device=p.device), params))
    for i in range(nmb):
        l, g = _value_and_grad(params, cfg, tmb[i],
                               _split_extra(extra, nmb, i))
        for a, b in zip(leaves(acc_g), leaves(constrain_like_params(g))):
            a.add_(b.to(tcfg.accum_dtype))
        acc_loss = acc_loss + l
        del g
    inv = 1.0 / nmb
    for a in leaves(acc_g):
        a.mul_(inv)
    return acc_loss * inv, acc_g


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(params, opt_state, tokens[, extra]) -> (loss, params,
    opt_state), updating params and opt_state's moments in place.  In
    compressed mode tokens has shape [npods, B/npods, S]."""

    def step(params, opt_state, tokens, extra=None):
        on_mesh = current_mesh() is not None
        if tcfg.weight_compress == "int8" and not on_mesh:
            # single-device: the additive-STE variant (numerics only)
            use_params = W.compress_for_gather(params)
        else:
            use_params = params
        wc_ctx = use_weight_compress(tcfg.weight_compress if on_mesh
                                     else False)
        a2a_ctx = use_a2a_compress(tcfg.a2a_compress if on_mesh else False)

        if tcfg.grad_compress != "none" and tcfg.npods > 1:
            # per-pod grads over the leading pod axis (the reference's
            # vmap), then the narrow-integer pod mean
            losses, per_pod = [], []
            with wc_ctx, a2a_ctx, dp_axes_override(("data",)):
                for i in range(tokens.shape[0]):
                    e = ({k: a[i] for k, a in extra.items()}
                         if extra else None)
                    l, g = _microbatched_grads(use_params, cfg, tcfg,
                                               tokens[i], e)
                    losses.append(l)
                    per_pod.append(g)
            loss = torch.stack(losses).mean()
            podded = tree_map(lambda *gs: torch.stack(gs), *per_pod)
            del per_pod
            grads = G.compressed_psum_mean(podded, tcfg.grad_compress,
                                           tcfg.npods)
            del podded
        else:
            if tokens.dim() == 3:                # podded layout, no compress
                tokens = tokens.reshape(-1, tokens.shape[-1])
                if extra:
                    extra = {k: a.reshape(-1, *a.shape[2:])
                             for k, a in extra.items()}
            with wc_ctx, a2a_ctx:
                loss, grads = _microbatched_grads(use_params, cfg, tcfg,
                                                  tokens, extra)
        del use_params
        params, opt_state = adamw.update(grads, opt_state, params,
                                         tcfg.adamw)
        return loss, params, opt_state

    return step

