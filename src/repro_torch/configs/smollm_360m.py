"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-*]
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152, tie_embeddings=True,
)
