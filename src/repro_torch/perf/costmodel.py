"""Analytic roofline cost model per (arch x shape x mesh) cell.

The production dry run (`launch.dryrun`) counts what one fake rank
executes: its FLOPs, its bytes and its collectives.  This model states
what a cell should cost from the architecture alone, term by term: every
einsum below mirrors one in `repro_torch.models`, so the two can be held
against each other (counted / analytic FLOPs).  The arithmetic is the
reference's (``repro.perf.costmodel``) term for term, so every total and
breakdown entry equals it exactly.

All quantities are per rank per step on the 16 x 16 (x 2 pods) mesh.
The card's constants are those of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates at 700 W), and this module is their one source:
`launch.dryrun` and ``chip_smoke.py`` import them from here.
`CellCost.terms` takes another `Hardware` to put the same counts under
other constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES

#: one NVIDIA H100 SXM: bf16 tensor-core FLOP/s (dense)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink 4 bytes/s per card and direction
NVLINK_BW = 450e9
#: fp32 FLOP/s on the CUDA cores (no tensor cores): the bound of the
#: codec kernels' integer and float arithmetic
FP32_FLOPS = 67e12


class Hardware(NamedTuple):
    """The three rates the roofline terms divide by."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


H100 = Hardware(PEAK_FLOPS, HBM_BW, NVLINK_BW)

BYTES_P = 2          # params consumed in bf16
BYTES_MASTER = 4     # fp32 master
BYTES_ACT = 2


@dataclasses.dataclass
class CellCost:
    flops: float                 # per rank
    hbm_bytes: float             # per rank
    coll_bytes: float            # per rank (over the links)
    breakdown: Dict[str, float]

    def terms(self, hw: Hardware = H100):
        """Seconds of compute, memory and collectives under `hw`, the
        dominant one and its time."""
        t = {"compute_s": self.flops / hw.peak_flops,
             "memory_s": self.hbm_bytes / hw.hbm_bw,
             "collective_s": self.coll_bytes / hw.link_bw}
        dom = max(t, key=t.get)
        return dict(t, dominant=dom, bound_s=t[dom])


def _attn_fwd_flops(cfg, B, Sq, Sk, causal=True):
    """scores + AV for every attention layer (GQA or MLA q/k dims)."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))
    if cfg.mla:
        qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        vd = cfg.mla.v_head_dim
    else:
        qk = vd = cfg.head_dim
    eff = 0.5 if (causal and Sq == Sk) else 1.0
    per_layer = 2.0 * B * Sq * Sk * cfg.n_heads * (qk + vd) * eff
    return n_attn * per_layer


def _ssd_fwd_flops(cfg, B, S):
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    n_m = sum(1 for k in cfg.layer_kinds() if k.startswith("mamba"))
    d_in = s.expand * cfg.d_model
    Q, N = s.chunk, s.d_state
    per_tok = 2 * Q * N + 2 * Q * d_in + 8 * d_in * N   # cb, scores@x, states
    return n_m * B * S * per_tok


def _moe_waste_factor(cfg):
    """Dense-capacity dispatch computes E·cap slots = topk·cf·T token-slots
    (dropped-or-not), so MoE expert flops carry a capacity_factor excess."""
    return cfg.moe.capacity_factor if cfg.moe else 1.0


def _tp_reduces_per_stack(cfg):
    """One row-parallel all-reduce per matmul block: attn->1, mamba->1,
    mlp/moe->1 (per layer, fwd; bwd doubled by the caller's 2x factor)."""
    n = 0
    for kind in cfg.layer_kinds():
        n += 1                                  # attn or mamba mixer
        if kind.endswith("+mlp") or kind.endswith("+moe"):
            n += 1
    return n


def _active_matmul_flops(cfg, tokens):
    n_active = cfg.active_param_count()
    if cfg.moe:
        moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith("+moe"))
        d = cfg.d_model
        moe_active = 3 * d * cfg.moe.d_ff * cfg.moe.top_k * moe_layers
        n_active = n_active + moe_active * (_moe_waste_factor(cfg) - 1.0)
    return 2.0 * n_active * tokens


def cell_cost(arch: str, shape_name: str, multi_pod: bool,
              microbatches: int = 1, grad_compress: str = "none",
              accum_bytes: int = 4, weight_compress: str = "none",
              kv_compress: bool = False, a2a_compress: str = "none") -> CellCost:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    npods = 2 if multi_pod else 1
    DP, TP = 16, 16
    chips = npods * DP * TP
    B, S = shape.global_batch, shape.seq_len
    P_all = cfg.param_count()
    br: Dict[str, float] = {}

    if shape.kind == "train":
        tokens = B * S
        mm = 3.0 * _active_matmul_flops(cfg, tokens)          # fwd+bwd(2x)
        at = 3.0 * _attn_fwd_flops(cfg, B, S, S)
        sd = 3.0 * _ssd_fwd_flops(cfg, B, S)
        rematf = (mm + at + sd) / 3.0                          # fwd recompute
        flops = (mm + at + sd + rematf) / chips
        br["flops_matmul"] = mm / chips
        br["flops_attn"] = at / chips
        br["flops_ssd"] = sd / chips
        br["flops_remat"] = rematf / chips

        # HBM: weights touched per microbatch (gathered bf16 / TP shard),
        # optimizer state r/w, gradient r/w, remat'd activations
        w_read = 2 * microbatches * P_all * BYTES_P / TP       # fwd+bwd
        opt_rw = P_all * (BYTES_MASTER * 2 + 2 * 2 * 2) / chips
        grad_rw = 2 * microbatches * P_all * accum_bytes / chips
        act = 12.0 * (tokens / (DP * npods)) * cfg.d_model * BYTES_ACT \
            * cfg.n_layers / TP
        hbm = w_read + opt_rw + grad_rw + act
        br.update(hbm_weights=w_read, hbm_opt=opt_rw, hbm_grads=grad_rw,
                  hbm_acts=act)

        # collectives: FSDP gathers (fwd+bwd per microbatch), grad
        # reduce-scatter over data, TP activation all-reduces, MoE a2a,
        # cross-pod grad all-reduce (fp32 or narrow int)
        # weight_compress='int8': the gather moves int8+1/128 scales
        wbytes = (1.0 + 4.0 / 128) if weight_compress == "int8" else BYTES_P
        fsdp = 2 * microbatches * P_all * wbytes / TP
        gsync = P_all * accum_bytes / TP
        tok_loc = tokens / (DP * npods) / microbatches
        n_tp_ar = _tp_reduces_per_stack(cfg)
        tp_ar = 2.0 * microbatches * n_tp_ar * tok_loc * cfg.d_model * BYTES_ACT
        a2a = 0.0
        if cfg.moe:
            moe_layers = sum(1 for k in cfg.layer_kinds()
                             if k.endswith("+moe"))
            a2a_bytes = (1.0 + 4.0 / 128) if a2a_compress == "int8" \
                else BYTES_ACT
            a2a = 3 * 2 * microbatches * moe_layers * tok_loc \
                * cfg.moe.top_k * cfg.d_model * a2a_bytes
        pod = 0.0
        if multi_pod:
            gbytes = {"none": 4, "int16": 2, "int8": 1}[grad_compress]
            pod = 2.0 * P_all * gbytes / (DP * TP)
        coll = fsdp + gsync + tp_ar + a2a + pod
        br.update(coll_fsdp=fsdp, coll_gradsync=gsync, coll_tp=tp_ar,
                  coll_moe_a2a=a2a, coll_pod=pod)
        return CellCost(flops, hbm, coll, br)

    if shape.kind == "prefill":
        tokens = B * S
        flops_g = _active_matmul_flops(cfg, tokens) \
            + _attn_fwd_flops(cfg, B, S, S) + _ssd_fwd_flops(cfg, B, S)
        flops = flops_g / chips
        w_read = P_all * BYTES_P / TP
        act = 6.0 * (tokens / (DP * npods)) * cfg.d_model * BYTES_ACT \
            * cfg.n_layers / TP
        cache_w = _cache_bytes(cfg, B, S) / chips
        hbm = w_read + act + cache_w
        fsdp = P_all * BYTES_P / TP
        tok_loc = tokens / (DP * npods)
        tp_ar = _tp_reduces_per_stack(cfg) * tok_loc * cfg.d_model * BYTES_ACT
        a2a = 0.0
        if cfg.moe:
            moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith("+moe"))
            a2a = 2 * moe_layers * tok_loc * cfg.moe.top_k * cfg.d_model \
                * BYTES_ACT
        coll = fsdp + tp_ar + a2a
        br.update(hbm_weights=w_read, hbm_acts=act, hbm_cache=cache_w,
                  coll_fsdp=fsdp, coll_tp=tp_ar, coll_moe_a2a=a2a)
        return CellCost(flops, hbm, coll, br)

    # decode: one token per slot against an S-long cache
    flops_g = _active_matmul_flops(cfg, B)
    n_attn = sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))
    if cfg.mla:
        m = cfg.mla
        # latent up-projection of the whole cache per step (MLA tradeoff)
        flops_g += 2.0 * B * S * m.kv_lora_rank \
            * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim) * n_attn
        flops_g += _attn_fwd_flops(cfg, B, 1, S, causal=False)
    else:
        flops_g += _attn_fwd_flops(cfg, B, 1, S, causal=False)
    if cfg.ssm:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        n_m = sum(1 for k in cfg.layer_kinds() if k.startswith("mamba"))
        flops_g += 4.0 * B * d_in * s.d_state * n_m
    flops = flops_g / chips
    w_read = P_all * BYTES_P / TP
    # int8 KV cache (+ per-SEQ_BLOCK fp32 scales) halves the cache reads
    kv_factor = (0.5 + 4.0 / (2 * 128)) if kv_compress else 1.0
    cache = _cache_bytes(cfg, B, S) * kv_factor / chips
    hbm = w_read + cache
    coll = _decode_coll(cfg, B)
    br.update(hbm_weights=w_read, hbm_cache=cache, coll=coll)
    return CellCost(flops, hbm, coll, br)


def _cache_bytes(cfg, B, S):
    total = 0.0
    for k in cfg.layer_kinds():
        if k.startswith("attn"):
            if cfg.mla:
                total += B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)
            else:
                total += 2 * B * S * cfg.n_kv_heads * cfg.head_dim
        elif cfg.ssm:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            total += B * (d_in // s.head_dim) * s.d_state * s.head_dim * 2
    return total * BYTES_ACT


def _decode_coll(cfg, B):
    # TP all-reduces on the [B,1,D] residual per matmul block
    return _tp_reduces_per_stack(cfg) * B * cfg.d_model * BYTES_ACT


def summarize(arch, shape_name, multi_pod, hw: Hardware = H100, **kw):
    """`cell_cost` (``**kw`` are its knobs) as one flat record, with the
    roofline terms under `hw`."""
    c = cell_cost(arch, shape_name, multi_pod, **kw)
    return {"flops_per_chip": c.flops, "hbm_bytes_per_chip": c.hbm_bytes,
            "coll_bytes_per_chip": c.coll_bytes, **c.terms(hw),
            "breakdown": c.breakdown}
