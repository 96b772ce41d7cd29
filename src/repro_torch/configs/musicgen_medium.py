"""musicgen-medium — decoder-only over EnCodec tokens (STUB frontend:
precomputed frame embeddings added to token embeds).
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab=2048, head_dim=64,
    pattern=("attn+mlp",),
    add_frame_embeds=True,
)
