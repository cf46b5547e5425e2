"""zamba2-1.2b [hybrid] — Mamba2 backbone + one globally-shared attention
block applied every 6th layer. [arXiv:2411.15242]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_groups=1, d_conv=4, expand=2,
    attn_every=6,
)
