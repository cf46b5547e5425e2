"""Dense GQA attention block (optional QKV bias) — the port of the GQA
half of ``repro.models.attention``.  MLA is not ported yet (ROADMAP Queue
1 item 12d)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, attention, update_cache
from repro_torch.models.params import P


def gqa_spec(cfg: ModelConfig) -> dict:
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "wq": P((D, Hq * Dh), ("embed", "heads")),
        "wk": P((D, Hkv * Dh), ("embed", "heads")),
        "wv": P((D, Hkv * Dh), ("embed", "heads")),
        "wo": P((Hq * Dh, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((Hq * Dh,), ("heads",), "zeros")
        s["bk"] = P((Hkv * Dh,), ("heads",), "zeros")
        s["bv"] = P((Hkv * Dh,), ("heads",), "zeros")
    return s


def gqa_apply(cfg: ModelConfig, p: dict, h, *, positions, cache=None,
              pos=None, window: int = 0):
    """h: [B, S, D]; ``pos`` (host int) = cache fill level for a decode
    step, None for prefill.  Returns (out, new_cache); the given cache is
    never written."""
    B, S, D = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cd = h.dtype

    def proj(w, b):
        y = h @ p[w].to(cd)
        if cfg.qkv_bias:
            y = y + p[b].to(cd)
        return y

    q = proj("wq", "bq").reshape(B, S, Hq, Dh)
    k = proj("wk", "bk").reshape(B, S, Hkv, Dh)
    v = proj("wv", "bv")                                  # flat [B, S, Hkv*Dh]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta).reshape(B, S, Hkv * Dh)

    new_cache = None
    if cache is not None:
        start = pos if pos is not None else 0
        new_cache = {"k": update_cache(cache["k"], k, start),
                     "v": update_cache(cache["v"], v, start)}
    if pos is not None:                                   # decode: attend to cache
        kk = new_cache["k"].to(cd).reshape(B, -1, Hkv, Dh)
        vv = new_cache["v"].to(cd).reshape(B, -1, Hkv, Dh)
        out = attention(q, kk, vv, causal=False, window=window,
                        kv_len=pos + S)
    else:
        out = attention(q, k.reshape(B, S, Hkv, Dh), v.reshape(B, S, Hkv, Dh),
                        causal=cfg.causal, window=window)
    return out.reshape(B, S, Hq * Dh) @ p["wo"].to(cd), new_cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int, seq_axis: str):
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": P((batch, max_len, Hkv * Dh), ("batch", seq_axis, "heads"), "zeros"),
        "v": P((batch, max_len, Hkv * Dh), ("batch", seq_axis, "heads"), "zeros"),
    }
