"""Mixture-of-Experts with sort-based dropped-token dispatch.

The reference's `repro.models.moe`: routing, sorting and capacity are
PER BATCH ROW (GShard/Switch-style groups).  Each [S] row sorts its own
S·top_k assignments by expert and keeps the first
``cap = min(max(8, int(S·top_k / E · cf)), S·top_k)`` per expert; the
kept tokens go through a dense ``[B, E, cap, D]`` dispatch, the
per-expert SwiGLU products and a weighted combine back to their tokens.

Three orders are the reference's, so that f32 results (and greedy
tokens) agree:
  * top-k: `jax.lax.top_k` puts the lower expert index first on ties
    (common among bf16 router logits); a stable descending sort does
    the same, `torch.topk` on CUDA gives no order for ties;
  * the dispatch sort is stable (`jnp.argsort` defaults to stable,
    `torch.argsort` does not), so the kept set is the reference's when
    tokens are dropped;
  * the combine adds a token's contributions in the stable sort's order
    (ascending expert id) into zeros in the compute dtype, as the
    reference's ``.at[t].add`` does; `index_add_` on CUDA uses atomics
    and has no fixed order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.context import a2a_compress_active, constrain

from .config import ModelConfig
from .layers import dense_init, swiglu


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    m = cfg.moe
    d = cfg.d_model
    device = device if device is not None else gen.device
    p = {
        "router": dense_init(gen, (d, m.n_experts), device=device),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_ff), device=device)
        / (cfg.n_layers ** 0.5),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_ff), device=device),
        "w_down": dense_init(gen, (m.n_experts, m.d_ff, d), in_axis=(0, 1),
                             device=device),
    }
    if m.n_shared:
        f = m.d_ff * m.n_shared
        p["shared"] = {"w_gate": dense_init(gen, (d, f), device=device),
                       "w_up": dense_init(gen, (d, f), device=device),
                       "w_down": dense_init(gen, (f, d), device=device)}
    return p


class Routing(NamedTuple):
    """One call's row-local routing, in the stable sort's order."""
    se: torch.Tensor        # [B, A] expert of each sorted assignment
    st: torch.Tensor        # [B, A] its token
    sg: torch.Tensor        # [B, A] its gate (f32)
    keep: torch.Tensor      # [B, A] within the expert's capacity
    slot: torch.Tensor      # [B, A] dispatch slot, E·cap when dropped
    order: torch.Tensor     # [B, A] sorted position -> flat (token, k)
    eidx: torch.Tensor      # [B, S, k] top-k experts, best first
    cap: int


def route(p, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Top-k routing of x [B,S,D] and the capacity-limited dispatch
    slots, per row."""
    m = cfg.moe
    B, S, _ = x.shape
    E, k = m.n_experts, m.top_k
    A = S * k
    dev = x.device
    logits = (x @ p["router"].to(x.dtype)).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k], dim=-1)              # [B,S,k]
    eidx = idx[..., :k]
    flat_e = eidx.reshape(B, A)
    flat_g = gates.reshape(B, A)

    order = torch.argsort(flat_e, dim=1, stable=True)         # by expert
    se = flat_e.gather(1, order)
    st = order // k                                           # its token
    sg = flat_g.gather(1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(A, device=dev)[None, :] - starts.gather(1, se)

    cap = min(max(8, int(A / E * m.capacity_factor)), A)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, E * cap)
    return Routing(se, st, sg, keep, slot, order, eidx, cap)


def moe_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D].  Row-local dropped-token top-k routing."""
    if a2a_compress_active():
        raise NotImplementedError(
            "the compressed all-to-all dispatch needs a device mesh: the "
            "distribution slice of the port (ROADMAP §1.3)")
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    E, k = m.n_experts, m.top_k
    r = route(p, cfg, x)
    cap = r.cap

    # dispatch: the kept assignments' tokens into [B, E, cap, D]; the
    # dropped ones all land in the spare row E·cap, cut off below
    zero = torch.zeros((), dtype=dt, device=x.device)
    gathered = torch.where(r.keep[..., None],
                           x.gather(1, r.st[..., None].expand(-1, -1, D)),
                           zero)
    disp = torch.zeros((B, E * cap + 1, D), dtype=dt, device=x.device)
    disp.scatter_(1, r.slot[..., None].expand(-1, -1, D), gathered)
    disp = disp[:, :E * cap].reshape(B, E, cap, D)
    disp = constrain(disp, "dp", "model", None, None)

    h_g = torch.einsum("becd,edf->becf", disp, p["w_gate"].to(dt))
    h_u = torch.einsum("becd,edf->becf", disp, p["w_up"].to(dt))
    eo = torch.einsum("becf,efd->becd", F.silu(h_g) * h_u,
                      p["w_down"].to(dt))
    eo = constrain(eo, "dp", None, None, None).reshape(B, E * cap, D)

    # combine: each kept slot's output, weighted by its gate
    vals = eo.gather(1, r.slot.clamp_max(E * cap - 1)[..., None]
                     .expand(-1, -1, D))
    contrib = torch.where(r.keep[..., None], vals * r.sg[..., None].to(dt),
                          zero)
    # add each token's k contributions in the sorted order, which is
    # ascending expert id: sorted position j goes to (its token, the
    # rank of its expert among the token's k experts)
    rank_in_token = (r.eidx[..., None, :] < r.eidx[..., :, None]).sum(-1)
    dest = r.st * k + rank_in_token.reshape(B, S * k).gather(1, r.order)
    by_token = torch.empty_like(contrib).scatter_(
        1, dest[..., None].expand(-1, -1, D), contrib).reshape(B, S, k, D)
    out = torch.zeros((B, S, D), dtype=dt, device=x.device)
    for j in range(k):
        out = out + by_token[:, :, j]

    if m.n_shared:
        sp = p["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out

