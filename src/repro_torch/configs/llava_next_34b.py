"""llava-next-34b [vlm] — anyres tiling; backbone only, vision frontend is a
stub (input_specs supplies pre-projected patch embeddings).
[hf:llava-hf/llava-v1.6-*] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, rope_theta=5e6,
    frontend="vision", n_patch_tokens=576,
)
