"""mamba2-1.3b — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=64,
    pattern=("mamba",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    sub_quadratic=True, tie_embeddings=True,
)
