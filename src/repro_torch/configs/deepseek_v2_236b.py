"""deepseek-v2-236b — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=0, vocab=102400, head_dim=128,
    pattern=("attn+moe",),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
)
