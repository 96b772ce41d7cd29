"""qwen2.5-3b — dense, GQA kv=2, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, head_dim=128,
    pattern=("attn+mlp",), qkv_bias=True, tie_embeddings=True,
)
