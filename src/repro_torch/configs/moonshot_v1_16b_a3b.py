"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=0, vocab=163840, head_dim=128,
    pattern=("attn+moe",),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408),
)
