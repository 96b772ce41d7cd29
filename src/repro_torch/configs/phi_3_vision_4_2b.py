"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (STUB: precomputed
patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96,
    pattern=("attn+mlp",),
    n_prepend_embeds=256,
)
