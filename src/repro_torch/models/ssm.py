"""Mamba2 SSD (state-space duality) block: chunked quadratic-intra /
linear-inter scan for training and prefill, O(1) recurrent step for
decode.

The reference's `repro.models.ssm` (scalar A per head, shared B/C across
heads, causal conv on x/B/C, gated RMSNorm), with its leaf names.  The
intra-chunk term is a masked [Q,Q] product per head block; the
reference's two `lax.scan`s, over sequence segments and over the chunks
of a segment, are Python loops here.  Lengths are the reference's: a
prompt is one chunk or a whole number of chunks, and the chunks a whole
number of segments; nothing is padded (padding would change the state).

``jax.nn.softplus`` is ``logaddexp(x, 0)``; so is `_softplus` here
(`F.softplus` returns x above its threshold of 20).  The two packages'
results differ by up to two ulp (their libms' `exp` and `log1p`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, rms_norm


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    N = s.d_state
    conv_dim = d_in + 2 * N
    device = device if device is not None else gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * N + H), device=device),
        "conv_w": dense_init(gen, (s.conv_kernel, conv_dim),
                             device=device) * 0.1,
        "conv_b": torch.zeros((conv_dim,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": torch.full((H,), math.log(math.expm1(1e-2)),
                              device=device),
        "gate_norm": torch.ones((d_in,), device=device),
        "out_proj": dense_init(gen, (d_in, d), device=device),
    }


class MambaState(NamedTuple):
    h: torch.Tensor       # [B, H, N, P] SSM state
    conv: torch.Tensor    # [B, K-1, conv_dim] causal-conv tail


HEAD_BLOCK = 8          # heads per intra-chunk block (bounds the
                        # [Q,Q,hb] score tensor)
SEG_CHUNKS = 32         # chunks per sequence segment (the outer loop
                        # carries the SSM state)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """x: [B,S,C]; depthwise causal conv, kernel K."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0][None, None, :].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    N = s.d_state
    z, x, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    return z, x, Bm, Cm, dt, d_in, H, N


def _ssd_segment(xc, Bc, Cc, lc, h0):
    """SSD over one segment of chunks.

    xc: [B,nC,Q,H,P] (already dt-scaled, f32); Bc/Cc: [B,nC,Q,N];
    lc: [B,nC,Q,H] in-chunk cumulative log decay; h0: [B,H,N,P] carry.
    Returns (y [B,nC,Q,H,P], hT)."""
    B_, nC, Q, H, P = xc.shape
    total = lc[:, :, -1, :]                                   # [B,nC,H]

    cb = torch.einsum("bcqn,bcun->bcqu", Cc, Bc)              # [B,nC,Q,U]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    cbm = torch.where(tri[None, None], cb, 0.0)

    # intra-chunk, one head block at a time (keeps [Q,U,hb] bounded)
    hb = HEAD_BLOCK if H % HEAD_BLOCK == 0 else 1
    y_intra = []
    for j in range(0, H, hb):
        l_b = lc[..., j:j + hb]                               # [B,nC,Q,hb]
        seg = l_b[:, :, :, None, :] - l_b[:, :, None, :, :]   # [B,nC,Q,U,hb]
        scores = cbm[..., None] * torch.exp(seg)
        y_intra.append(torch.einsum("bcquh,bcuhp->bcqhp", scores,
                                    xc[:, :, :, j:j + hb]))
    y_intra = torch.cat(y_intra, dim=3)

    # chunk states: S_c = sum_u exp(total - l_u) B_u x_u^T   [B,nC,H,N,P]
    decay_to_end = torch.exp(total[:, :, None, :] - lc)       # [B,nC,Q,H]
    Sc = torch.einsum("bcun,bcuh,bcuhp->bchnp", Bc, decay_to_end, xc)

    h, h_prev = h0, []
    for c in range(nC):
        h_prev.append(h)                                      # state BEFORE chunk
        h = h * torch.exp(total[:, c])[:, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # [B,nC,H,N,P]

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(lc),
                           h_prev)
    return y_intra + y_inter, h


def mamba_forward(p, cfg: ModelConfig, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, MambaState]:
    """u: [B,S,D].  Returns (out [B,S,D], final MambaState for decode).

    Long sequences run as an outer loop over segments (SEG_CHUNKS·chunk
    tokens) carrying the SSM state — the parallel SSD form within each
    segment, linear recurrence across segments."""
    s = cfg.ssm
    dt_ = u.dtype
    B_, S, D = u.shape
    zxbcdt = u @ p["in_proj"].to(dt_)
    z, x, Bm, Cm, dtp, d_in, H, N = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([x, Bm, Cm], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    x, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)

    P = s.head_dim
    xh = x.reshape(B_, S, H, P)
    dt = _softplus(dtp.float() + p["dt_bias"][None, None, :])     # [B,S,H]
    A = -torch.exp(p["A_log"])                                    # [H]
    dA = dt * A[None, None, :]                                    # log decay
    xdt = xh.float() * dt[..., None]

    Q = min(s.chunk, S)
    assert S % Q == 0, (S, Q)
    nC = S // Q
    seg_c = min(SEG_CHUNKS, nC)
    assert nC % seg_c == 0, (nC, seg_c)
    nseg = nC // seg_c

    def shape_seg(t, extra):
        return t.reshape((B_, nseg, seg_c, Q) + extra).swapaxes(0, 1)

    xs = shape_seg(xdt, (H, P))
    Bs = shape_seg(Bm.float(), (N,))
    Cs = shape_seg(Cm.float(), (N,))
    ls = torch.cumsum(dA.reshape(B_, nseg, seg_c, Q, H), dim=3
                      ).swapaxes(0, 1)

    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(nseg):
        y_i, h = _ssd_segment(xs[i], Bs[i], Cs[i], ls[i], h)
        ys.append(y_i)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, P)

    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, S, d_in).to(dt_)

    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)

    K = s.conv_kernel
    conv_tail = F.pad(conv_in, (0, 0, K - 1, 0))[:, -(K - 1):, :]
    return out, MambaState(h, conv_tail)


def mamba_decode(p, cfg: ModelConfig, u: torch.Tensor, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """u: [B,1,D]; the O(1) recurrent step.  Returns (out, new state);
    `state` is not written."""
    s = cfg.ssm
    dt_ = u.dtype
    B_ = u.shape[0]
    zxbcdt = u @ p["in_proj"].to(dt_)
    z, x, Bm, Cm, dtp, d_in, H, N = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([x, Bm, Cm], dim=-1)                      # [B,1,C]
    window = torch.cat([state.conv, conv_in], dim=1)              # [B,K,C]
    w = p["conv_w"].to(dt_)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w)
                      + p["conv_b"].to(dt_))[:, None, :]
    x, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)

    P = s.head_dim
    xh = x.reshape(B_, 1, H, P)[:, 0]                             # [B,H,P]
    dt = _softplus(dtp.float()[:, 0] + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])                                # [B,H]
    Bv = Bm[:, 0].float()                                         # [B,N]
    Cv = Cm[:, 0].float()
    xdt = xh.float() * dt[..., None]

    h = state.h * a[:, :, None, None] \
        + torch.einsum("bn,bhp->bhnp", Bv, xdt)
    y = torch.einsum("bn,bhnp->bhp", Cv, h)
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B_, 1, d_in).to(dt_)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, MambaState(h, window[:, 1:, :])
