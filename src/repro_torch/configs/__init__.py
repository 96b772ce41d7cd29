"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig, SSMConfig

from . import (mamba2_1_3b, moonshot_v1_16b_a3b, deepseek_v2_236b,
               jamba_1_5_large_398b, phi_3_vision_4_2b, qwen3_32b, qwen3_4b,
               granite_34b, qwen2_5_3b, musicgen_medium)
from .shapes import SHAPES, ShapeSpec, applicable  # noqa: F401

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (mamba2_1_3b, moonshot_v1_16b_a3b, deepseek_v2_236b,
              jamba_1_5_large_398b, phi_3_vision_4_2b, qwen3_32b, qwen3_4b,
              granite_34b, qwen2_5_3b, musicgen_medium)
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(name: str, n_periods: int = 2) -> ModelConfig:
    """Small same-family config for CPU smoke tests: few layers, narrow
    width, few experts, tiny vocab — the structure (pattern, MoE/MLA/SSM
    machinery, qk_norm/bias, stubs) is preserved."""
    cfg = get(name)
    d = 64
    n_heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    n_kv = 1 if cfg.n_kv_heads == 1 else (2 if cfg.n_kv_heads else 0)
    changes = dict(
        n_layers=len(cfg.pattern) * n_periods,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_prepend_embeds=8 if cfg.n_prepend_embeds else 0,
    )
    if cfg.moe is not None:
        # capacity_factor 8: no token dropping at smoke-test sizes, so
        # teacher-forced forward and step-decode agree exactly
        changes["moe"] = MoEConfig(n_experts=8, top_k=2, d_ff=32,
                                   n_shared=min(cfg.moe.n_shared, 1),
                                   capacity_factor=8.0)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                   qk_nope_dim=16, qk_rope_dim=8,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2,
                                   conv_kernel=4, chunk=16)
    return dataclasses.replace(cfg, **changes)
