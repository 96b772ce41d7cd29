"""qwen3-32b — dense, GQA kv=8, qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, head_dim=128,
    pattern=("attn+mlp",), qk_norm=True,
)
