"""Architecture registry: the 10 assigned archs (exact public configs) plus
reduced smoke variants for CPU tests — the port's copy of
``repro.configs``, with torch dtypes in the policies."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, Policy

from repro_torch.configs import (  # noqa: E402
    mamba2_130m, qwen1_5_110b, smollm_360m, qwen2_5_14b, gemma3_4b,
    llava_next_34b, llama4_maverick, deepseek_v2, zamba2_1_2b, hubert_xlarge,
)

ARCHS = {
    "mamba2-130m": mamba2_130m.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "smollm-360m": smollm_360m.CONFIG,
    "qwen2.5-14b": qwen2_5_14b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick.CONFIG,
    "deepseek-v2-236b": deepseek_v2.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, tiny dims — runs one train/forward step on CPU."""
    if cfg.global_every:
        n_layers = cfg.global_every + 1
    elif cfg.attn_every:
        n_layers = cfg.attn_every + 2
    elif cfg.first_dense:
        n_layers = cfg.first_dense + 4
    elif cfg.moe_every > 1:
        n_layers = 2 * cfg.moe_every
    else:
        n_layers = 3
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, 4 - (4 % max(1, kv)))
    kw = dict(
        n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        d_head=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab=256,
        attn_chunk=32, ssd_chunk=16,
        policy=Policy(moment_dtype=cfg.policy.moment_dtype),
    )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2),
                  d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.is_mla:
        kw.update(q_lora=48, kv_lora=32, nope_head_dim=16, rope_head_dim=8,
                  v_head_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, expand=2)
        if cfg.ssm_heads:
            kw.update(ssm_heads=8)
    if cfg.window:
        kw.update(window=16)
    if cfg.frontend == "audio":
        kw.update(d_frontend=32)
    if cfg.frontend == "vision":
        kw.update(n_patch_tokens=8)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


SMOKE = {k: reduce_for_smoke(v) for k, v in ARCHS.items()}
