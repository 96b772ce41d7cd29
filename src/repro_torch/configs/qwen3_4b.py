"""qwen3-4b — dense, GQA kv=8, qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    pattern=("attn+mlp",), qk_norm=True, tie_embeddings=True,
)
