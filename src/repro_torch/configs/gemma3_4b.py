"""gemma3-4b [dense] — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-*] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
Runs long_500k: sub-quadratic by the 5:1 local-window pattern."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab=262144, rope_theta=1e6, tie_embeddings=True,
    window=1024, global_every=6,
)
