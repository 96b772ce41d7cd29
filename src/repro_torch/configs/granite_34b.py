"""granite-34b — llama-arch code model, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    pattern=("attn+mlp",), mlp_gated=False,
)
