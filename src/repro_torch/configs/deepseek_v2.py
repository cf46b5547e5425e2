"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434] 60L d_model=5120 128H vocab=102400, expert d_ff=1536
(assignment's d_ff); layer-0 dense FFN uses the model's 12288.
Policy: bf16 optimizer moments (>=200B trick, DESIGN.md)."""
import torch

from repro_torch.models.config import ModelConfig, Policy

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288, vocab=102400, rope_theta=1e4,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    first_dense=1,
    q_lora=1536, kv_lora=512, nope_head_dim=128, rope_head_dim=64,
    v_head_dim=128,
    policy=Policy(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16),
)
