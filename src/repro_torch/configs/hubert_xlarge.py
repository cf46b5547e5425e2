"""hubert-xlarge [audio] — encoder-only (w2v2 arch); modality frontend is a
stub (input_specs supplies precomputed frame embeddings, d=512).
[arXiv:2106.07447] 48L d_model=1280 16H d_ff=5120 vocab=504."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab=504, causal=False,
    frontend="audio", d_frontend=512,
)
