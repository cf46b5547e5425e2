"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + 1 shared,
MoE interleaved every other layer; early fusion.
[hf:meta-llama/Llama-4-*] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
Policy: bf16 optimizer moments (>=200B trick, DESIGN.md)."""
import torch

from repro_torch.models.config import ModelConfig, Policy

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    n_experts=128, top_k=1, n_shared_experts=1, d_ff_expert=8192, moe_every=2,
    policy=Policy(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16),
)
