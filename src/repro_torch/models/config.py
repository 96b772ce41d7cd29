"""Architecture config schema covering the 10 assigned families:
dense / MoE / MLA-MoE / SSM (Mamba2 SSD) / hybrid (Jamba) / VLM & audio
backbones (stub frontends)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    n_shared: int = 0            # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:                 # deepseek-v2 multi-head latent attention
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:                 # mamba2 SSD
    d_state: int = 128
    head_dim: int = 64           # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128             # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                    # dense MLP hidden (0 = no dense MLP)
    vocab: int
    head_dim: int = 128
    # layer pattern: tuple of kinds, tiled to n_layers.  kinds:
    #   'attn+mlp' | 'attn+moe' | 'mamba+mlp' | 'mamba+moe' | 'mamba'
    pattern: Tuple[str, ...] = ("attn+mlp",)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    qk_norm: bool = False        # qwen3
    qkv_bias: bool = False       # qwen2.5
    mlp_gated: bool = True       # False: 2-matrix GELU MLP (granite)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # modality stubs: extra precomputed embeddings prepended (vlm) or
    # added per-position (audio frames)
    n_prepend_embeds: int = 0    # phi-3-vision patch tokens
    add_frame_embeds: bool = False  # musicgen EnCodec frame embeddings
    # attention classes for shape handling
    sub_quadratic: bool = False  # True for SSM/hybrid (long_500k eligible)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.name,)
        return self.n_layers // len(self.pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.pattern) * self.n_periods

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.pattern:
            blk = 0
            if kind.startswith("attn"):
                if self.mla is not None:
                    m = self.mla
                    blk += d * m.q_lora_rank \
                        + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim) \
                        + d * (m.kv_lora_rank + m.qk_rope_dim) \
                        + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim) \
                        + self.n_heads * m.v_head_dim * d
                else:
                    blk += d * self.n_heads * self.head_dim * 2 \
                        + d * self.n_kv_heads * self.head_dim * 2
            if kind.startswith("mamba"):
                s = self.ssm
                d_in = s.expand * d
                blk += d * (2 * d_in + 2 * s.d_state) + d_in * d
            if kind.endswith("+mlp") and self.d_ff:
                blk += (3 if self.mlp_gated else 2) * d * self.d_ff
            if kind.endswith("+moe"):
                blk += 3 * d * self.moe.d_ff * (self.moe.n_experts + self.moe.n_shared)
                blk += d * self.moe.n_experts       # router
            total += blk * (self.n_layers // len(self.pattern))
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters — the MoE 6·N_active·D term."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe_layers = sum(1 for k in self.layer_kinds() if k.endswith("+moe"))
        all_experts = 3 * d * self.moe.d_ff * self.moe.n_experts * n_moe_layers
        active = 3 * d * self.moe.d_ff * self.moe.top_k * n_moe_layers
        return full - all_experts + active
