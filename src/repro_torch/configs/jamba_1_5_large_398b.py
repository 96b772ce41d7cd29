"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

# period of 8: one attention layer per 8 (1:7), MoE on odd positions
_PATTERN = ("mamba+mlp", "mamba+moe", "mamba+mlp", "mamba+moe",
            "attn+mlp", "mamba+moe", "mamba+mlp", "mamba+moe")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    sub_quadratic=True,
)
