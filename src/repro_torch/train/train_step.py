"""Train step: chunked CE loss -> (microbatched) grads -> optional
PREQUANT-compressed cross-pod gradient mean -> AdamW, on one device.

The reference's `repro.train.train_step` on the port's model stack.
Off-mesh, in compressed mode the batch keeps a leading pod axis
[npods, B/npods, S]; the reference computes per-pod grads with `jax.vmap`
over it, the port with a loop over the pods, and both reduce them with
`core.gradient.compressed_psum_mean`.

On a mesh (``dist.context.use_mesh``) params, moments and tokens are
DTensors and the weight-gather and all-to-all hooks are armed with
`TrainConfig`'s codecs; modality inputs go by rows
(`sharding.place_extra`).  With a "pod" axis, each rank runs its own pod's
microbatched grads on the sub-mesh ``mesh["data", "model"]`` under
``dp_axes_override(("data",))`` (the reference's
``vmap(..., spmd_axis_name="pod")``), and the pod mean is an explicit
collective over the pod group: the narrow-integer all-reduce of
`core.gradient.pod_mean` in compressed mode, an f32 one otherwise.
Microbatch i is each rank's i-th slice of its own rows.

The AdamW update writes params and moments in place, so `step` returns
the trees it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import gradient as G
from repro_torch.core import weights as W
from repro_torch.dist.context import (constrain, constrain_like_params,
                                      current_mesh, current_param_specs,
                                      dp_axes_override, mesh_compute,
                                      sum_over_group, use_a2a_compress,
                                      use_mesh, use_param_specs,
                                      use_weight_compress)
from repro_torch.dist.sharding import (NamedSharding, P, batch_spec,
                                       place_extra)
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
    and the chunk sums add in order, as in the reference.

    On a mesh the forward is the DTensor one; the cross-entropy then runs
    on each rank's own rows with the head gathered whole (the off-mesh
    arithmetic on local tensors), and the per-rank sums add across the
    data-parallel axes.  The loss is a plain tensor, the same on every
    rank."""
    with mesh_compute():
        hidden, _ = M.forward(params, cfg, tokens, extra,
                              return_hidden=True)
        head = M.lm_head_of(params, cfg).to(hidden.dtype)
        if current_mesh() is None:
            return _ce_sum(hidden, head, tokens, cfg) / (
                tokens.shape[0] * (hidden.shape[1]
                                   - cfg.n_prepend_embeds - 1))
        return _mesh_ce(hidden, head, tokens, cfg)


def _ce_sum(hidden, head, tokens, cfg: ModelConfig):
    """The summed cross-entropy of plain tensors (hidden [B, S_total, D],
    head [D, V], tokens [B, S])."""
    hidden = hidden[:, cfg.n_prepend_embeds:, :]
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
    return tot


def _mesh_ce(hidden, head, tokens, cfg: ModelConfig):
    """`loss_fn`'s cross-entropy on a mesh: `_ce_sum` of this rank's rows
    (hidden and tokens placed by rows over the data-parallel axes, the
    head replicated; its gradient from these rows is a partial sum over
    those axes), summed across the row axes, over the global count."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = current_mesh()
    hidden = constrain(hidden, "dp", None, None)
    tokens = constrain(tokens, "dp", None)
    rows = hidden.placements
    head = head.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(pl, Shard) else Replicate()
                         for pl in rows])
    tot = _ce_sum(hidden.to_local(), head, tokens.to_local(), cfg)
    for i, pl in enumerate(rows):
        if isinstance(pl, Shard):
            tot = sum_over_group(tot, mesh.get_group(i))
    B, S = tokens.shape
    return tot / (B * (S - 1))


def _value_and_grad(params, cfg: ModelConfig, tokens, extra):
    """(loss, grads) of `loss_fn` with respect to every floating leaf of
    `params` (zeros for a leaf the loss does not reach, as JAX gives)."""
    flat = leaves(params)
    req = [p.detach().requires_grad_() if p.is_floating_point() else p
           for p in flat]
    wrt = [r for r in req if r.requires_grad]
    # on a mesh the backward meets the forward's replicated plain tensors
    with mesh_compute():
        loss = loss_fn(rebuild(params, iter(req)), cfg, tokens, extra)
        got = iter(torch.autograd.grad(loss, wrt, materialize_grads=True))
    grads = [next(got) if r.requires_grad else torch.zeros_like(r)
             for r in req]
    return loss.detach(), rebuild(params, iter(grads))


def _split_extra(extra, nmb: int, i: int):
    if not extra:
        return None
    return {k: _split_rows(a, nmb)[i] for k, a in extra.items()}


def _split_rows(tokens, nmb: int):
    """[B, ...] -> nmb microbatches of B/nmb rows.  A DTensor splits each
    rank's own rows (microbatch i is every rank's i-th slice), so no
    microbatch changes its placement."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tokens, DTensor):
        return tokens.reshape(nmb, tokens.shape[0] // nmb,
                              *tokens.shape[1:])
    local = tokens.to_local()
    local = local.reshape(nmb, local.shape[0] // nmb, *local.shape[1:])
    return [DTensor.from_local(t, tokens.device_mesh, tokens.placements,
                               run_check=False) for t in local]


def _plain_loss(loss):
    from torch.distributed.tensor import DTensor

    return loss.full_tensor() if isinstance(loss, DTensor) else loss


def _mesh_grads(cfg: ModelConfig, tcfg: TrainConfig, params, tokens,
                extra):
    """(loss, grads) of the on-mesh step (see the module docstring): the
    loss a plain tensor, the grads placed as `params` are."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    mesh = current_mesh()
    names = tuple(mesh.mesh_dim_names)
    podded = tokens.dim() == 3
    if not isinstance(tokens, DTensor):
        tokens = NamedSharding(mesh, batch_spec(mesh, podded)).place(tokens)
    extra = place_extra(extra, mesh, podded)
    if "pod" not in names:
        if podded:                               # podded layout, no pods
            tokens = tokens.reshape(-1, tokens.shape[-1])
            extra = extra and {k: a.reshape(-1, *a.shape[2:])
                               for k, a in extra.items()}
        with use_weight_compress(tcfg.weight_compress), \
                use_a2a_compress(tcfg.a2a_compress):
            loss, grads = _microbatched_grads(params, cfg, tcfg, tokens,
                                              extra)
        return _plain_loss(loss), grads
    # one pod's grads on the sub-mesh, then the mean across pods
    ip = names.index("pod")
    sub = mesh[tuple(n for n in names if n != "pod")]

    def to_sub(t):
        pl = t.placements[:ip] + t.placements[ip + 1:]
        return DTensor.from_local(t.to_local(), sub, pl, run_check=False)

    def to_full(t):
        pl = t.placements[:ip] + (Replicate(),) + t.placements[ip:]
        return DTensor.from_local(t.to_local(), mesh, pl, run_check=False)

    def to_pod(t):
        """Our pod's rows of `t`, placed by rows on the sub-mesh."""
        local = t.to_local()
        if podded:                               # [1, rows, ...]: our pod's
            local = local[0]
        return DTensor.from_local(
            local, sub, NamedSharding(sub, P("data")).placements(
                local.dim()), run_check=False)

    with use_mesh(sub), use_param_specs(current_param_specs()), \
            dp_axes_override(("data",)), \
            use_weight_compress(tcfg.weight_compress), \
            use_a2a_compress(tcfg.a2a_compress):
        loss, grads = _microbatched_grads(
            tree_map(to_sub, params), cfg, tcfg, to_pod(tokens),
            extra and {k: to_pod(a) for k, a in extra.items()})
    loss = _plain_loss(loss).clone()
    dist.all_reduce(loss, group=mesh.get_group("pod"))
    loss = loss * (1.0 / mesh.shape[ip])
    grads = G.compressed_psum_mean(grads, tcfg.grad_compress,
                                   mesh.shape[ip])
    return loss, tree_map(to_full, grads)


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
    tmb = _split_rows(tokens, nmb)
    acc_loss = None
    acc_g = constrain_like_params(tree_map(
        lambda p: torch.zeros_like(p, dtype=tcfg.accum_dtype), params))
    for i in range(nmb):
        l, g = _value_and_grad(params, cfg, tmb[i],
                               _split_extra(extra, nmb, i))
        for a, b in zip(leaves(acc_g), leaves(constrain_like_params(g))):
            a.add_(b.to(tcfg.accum_dtype))
        acc_loss = l if acc_loss is None else acc_loss + l
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
        if current_mesh() is not None:
            loss, grads = _mesh_grads(cfg, tcfg, params, tokens, extra)
            params, opt_state = adamw.update(grads, opt_state, params,
                                             tcfg.adamw)
            return loss, params, opt_state
        if tcfg.weight_compress == "int8":
            # single-device: the additive-STE variant (numerics only)
            use_params = W.compress_for_gather(params)
        else:
            use_params = params
        # off-mesh the weight-gather and all-to-all hooks stay disarmed,
        # as in the reference

        if tcfg.grad_compress != "none" and tcfg.npods > 1:
            # per-pod grads over the leading pod axis (the reference's
            # vmap), then the narrow-integer pod mean
            losses, per_pod = [], []
            with dp_axes_override(("data",)):
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
            loss, grads = _microbatched_grads(use_params, cfg, tcfg,
                                              tokens, extra)
        del use_params
        params, opt_state = adamw.update(grads, opt_state, params,
                                         tcfg.adamw)
        return loss, params, opt_state

    return step

