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

On a mesh x is a DTensor.  Nothing but the expert products crosses rows,
so the routing, the dispatch scatter and the combine run on each rank's
own rows (the local shard of x placed ``("dp", None, None)``: rows over
the data-parallel axes, replicated over "model"), and the dispatch
``[B, E, cap, D]`` goes onto the mesh placed by rows, then is
redistributed to experts over "model" for the products (the
dispatch all-to-all) and back by rows (the combine all-to-all).  With
``use_a2a_compress`` armed, both all-to-alls move the codec's int8 codes
and f32 block scales instead (`_compressed_reshard`), in the forward and
for the cotangent in the backward.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.context import (_resolve_spec, a2a_codec,
                                      a2a_compress_active, constrain,
                                      current_mesh)
from repro_torch.dist.sharding import placements

from .config import ModelConfig
from .layers import dense_init, swiglu


def _qblock(d: int) -> int:
    """Largest power-of-two block (16..128) dividing d; 0 if none."""
    for b in (128, 64, 32, 16):
        if d % b == 0:
            return b
    return 0


def _wire_move(codec, v, mesh, dst):
    """The DTensor `v` moved to placements `dst` with the codec's
    payload on the wire: encode the local shard, redistribute the codes
    and the block scales (same rank as v, last dim in blocks), decode."""
    from torch.distributed.tensor import DTensor

    cont = codec.encode(v.to_local())
    moved = {k: DTensor.from_local(t, mesh, v.placements, run_check=False)
             .redistribute(mesh, dst).to_local()
             for k, t in cont.payload.items()}
    like = SimpleNamespace(shape=moved["q"].shape, dtype=v.dtype)
    out = codec.decode(cont.replace(payload=moved), like=like)
    return DTensor.from_local(out, mesh, dst, run_check=False)


class _CompressedReshard(torch.autograd.Function):
    """Forward: pin `v` on `src`, then move it to `dst` as the codec's
    payload.  Backward: the cotangent moves back from `dst` to `src` the
    same way (error-bounded both ways: the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, v, codec, mesh, dst, src):
        ctx.codec, ctx.mesh, ctx.dst, ctx.src = codec, mesh, dst, src
        if tuple(v.placements) != tuple(src):
            v = v.redistribute(mesh, src)
        return _wire_move(codec, v, mesh, dst)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.dst):
            g = g.redistribute(ctx.mesh, ctx.dst)
        return _wire_move(ctx.codec, g, ctx.mesh, ctx.src), None, None, \
            None, None


def _compressed_reshard(x, to_spec, from_spec):
    """`x` resharded from `from_spec` to `to_spec` with the armed wire
    codec's representation on the wire, both directions (the paper's
    PREQUANT on the expert-parallel dispatch and combine).  The codec
    comes from the ``use_a2a_compress`` hook via the registry.  Without a
    mesh, or when the last dim has no block, a plain constrain."""
    from repro_torch import codecs

    mesh = current_mesh()
    blk = _qblock(x.shape[-1])
    if mesh is None or blk == 0:
        return constrain(x, *to_spec)
    codec = codecs.get_block_codec(a2a_codec() or "int8-block",
                                   axis=-1, block=blk)
    shape = tuple(x.shape)
    dst = placements(_resolve_spec(to_spec, shape, mesh), mesh, x.dim())
    src = placements(_resolve_spec(from_spec, shape, mesh), mesh, x.dim())
    return _CompressedReshard.apply(x, codec, mesh, dst, src)


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


_ROW_SPEC = ("dp", None, None, None)
_EP_SPEC = ("dp", "model", None, None)


def moe_forward(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D].  Row-local dropped-token top-k routing."""
    if current_mesh() is None:
        out = _routed(p, cfg, x, p["router"], lambda d: d, lambda e: e)
    else:
        out = _mesh_routed(p, cfg, x)
    if cfg.moe.n_shared:
        sp = p["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


def _move(d, to_spec, from_spec):
    """The dispatch's crossing: compressed when the hook is armed."""
    if a2a_compress_active():
        return _compressed_reshard(d, to_spec, from_spec)
    return constrain(d, *to_spec)


def _mesh_routed(p, cfg: ModelConfig, x):
    """The routed experts of the DTensor `x` on the current mesh: each
    rank routes, dispatches and combines its own rows (x placed by rows,
    the router replicated); the dispatch goes onto the mesh by rows and
    crosses to the experts' placement and back."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = current_mesh()
    x = constrain(x, "dp", None, None)
    rows = x.placements
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim)
    # each rank's router gradient covers its own rows: partial sums over
    # the axes the rows are split on
    router = router.to_local(grad_placements=[
        Partial() if isinstance(pl, Shard) else Replicate() for pl in rows])
    xl = x.to_local()

    def to_experts(d):
        d = DTensor.from_local(d, mesh, rows, run_check=False)
        return _move(d, _EP_SPEC, _ROW_SPEC)

    def to_rows(e):
        return _move(e, _ROW_SPEC, _EP_SPEC).to_local()

    out = _routed(p, cfg, xl, router, to_experts, to_rows)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _expert_products(disp, w_gate, w_up, w_down):
    """The per-expert SwiGLU of the dispatch [B, E, cap, D]."""
    dt = disp.dtype
    h_g = torch.einsum("becd,edf->becf", disp, w_gate.to(dt))
    h_u = torch.einsum("becd,edf->becf", disp, w_up.to(dt))
    return torch.einsum("becf,efd->becd", F.silu(h_g) * h_u, w_down.to(dt))


def _experts(disp, w_gate, w_up, w_down):
    """`_expert_products`; on a mesh rank by rank: each rank multiplies
    its own rows and experts of the dispatch (placed rows over the
    data-parallel axes, experts over "model") with its experts' weights
    gathered whole over every other axis, by the off-mesh einsums on
    local tensors.  DTensor's einsum would view a non-contiguous
    operand it cannot view at full width (deepseek-v2-236b's 10 local
    experts of 160)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(disp, DTensor):
        return _expert_products(disp, w_gate, w_up, w_down)
    mesh = disp.device_mesh
    # the weights' expert dim (0) as the dispatch's (1) is placed
    on = [Shard(0) if isinstance(pl, Shard) and pl.dim == 1 else Replicate()
          for pl in disp.placements]
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in disp.placements]

    def local(w):
        w = w.redistribute(mesh, on)
        # its gradient from this rank's rows: partial over the row axes
        return w.to_local(grad_placements=[
            Partial() if r else pl for r, pl in zip(rows, on)])

    out = _expert_products(disp.to_local(), local(w_gate), local(w_up),
                           local(w_down))
    return DTensor.from_local(out, mesh, disp.placements, run_check=False)


def _routed(p, cfg: ModelConfig, x, router, to_experts, to_rows):
    """Route x [B,S,D] (a plain tensor: all of x off-mesh, the rank's own
    rows on a mesh) with `router`, dispatch, run the experts of `p`,
    combine.  `to_experts` moves the [B, E, cap, D] dispatch onto the
    experts' placement, `to_rows` brings their output back as a plain
    tensor of the same rows."""
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    E, k = m.n_experts, m.top_k
    r = route({"router": router}, cfg, x)
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
    disp = to_experts(disp)                           # dispatch all-to-all

    eo = _experts(disp, p["w_gate"], p["w_up"], p["w_down"])
    eo = to_rows(eo).reshape(B, E * cap, D)           # combine all-to-all

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
    return out

