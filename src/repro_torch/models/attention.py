"""Attention blocks: dense GQA (optional QKV bias, sliding window) and MLA
(DeepSeek-V2 multi-head latent attention with a compressed KV cache) —
the port of ``repro.models.attention``.

MLA's prefill attends through ``layers.attention``, so on the card through
the flash kernel at q and k's 192 columns (128 "nope" and 64 rope) and
v's 128.  Its decode step with weight absorption (``cfg.mla_absorb``,
deepseek-v2's setting) is einsums and a softmax over the latent cache, as
in the reference, where it runs outside any Pallas kernel; without
absorption the decode step up-projects the cache to per-head k and v and
needs ``decode_attention`` at (192, 128), which the card does not have
(ROADMAP Queue 1 item 26): it raises there, and runs on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, attention, rmsnorm,
                                       update_cache)
from repro_torch.models.params import P

# the ROADMAP item that would let an unabsorbed MLA decode run on the card
MLA_DECODE_ITEM = ("26: decode_attention at (D, Dv) = (192, 128), for MLA "
                   "decode with mla_absorb=False")


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
        # past the cache's end the reference's mask (k_pos >= pos + S)
        # masks nothing: every row, as kv_len = the cache's length
        out = attention(q, kk, vv, causal=False, window=window,
                        kv_len=min(pos + S, kk.shape[1]))
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


# ---------------------------------------------------------------------- MLA
def mla_spec(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    s = {
        "wkv_a": P((D, cfg.kv_lora + rope_d), ("embed", None)),
        "kv_ln": P((cfg.kv_lora,), (None,), "zeros"),
        "wk_b": P((cfg.kv_lora, H * nope), (None, "heads")),
        "wv_b": P((cfg.kv_lora, H * vd), (None, "heads")),
        "wo": P((H * vd, D), ("heads", "embed")),
    }
    if cfg.q_lora:
        s["wq_a"] = P((D, cfg.q_lora), ("embed", None))
        s["q_ln"] = P((cfg.q_lora,), (None,), "zeros")
        s["wq_b"] = P((cfg.q_lora, H * (nope + rope_d)), (None, "heads"))
    else:
        s["wq"] = P((D, H * (nope + rope_d)), ("embed", "heads"))
    return s


def mla_apply(cfg: ModelConfig, p: dict, h, *, positions, cache=None,
              pos=None, window: int = 0):
    """h: [B, S, D]; ``pos`` (host int) = cache fill level for a decode
    step, None for prefill.  The cache holds ``ckv`` = [normed latent,
    roped k_rope] ``[B, max_len, kv_lora + rope]``.  Returns (out,
    new_cache); the given cache is never written."""
    B, S, D = h.shape
    H = cfg.n_heads
    nope, rope_d, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    L = cfg.kv_lora
    cd = h.dtype

    if cfg.q_lora:
        qa = rmsnorm(h @ p["wq_a"].to(cd), p["q_ln"], cfg.rms_eps)
        q = (qa @ p["wq_b"].to(cd)).reshape(B, S, H, nope + rope_d)
    else:
        q = (h @ p["wq"].to(cd)).reshape(B, S, H, nope + rope_d)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :nope], q_rope], dim=-1)

    kv = h @ p["wkv_a"].to(cd)                            # [B,S,L+rope_d]
    # the rmsnorm kernel reads whole rows: the latent columns copied out
    latent = rmsnorm(kv[..., :L].contiguous(), p["kv_ln"], cfg.rms_eps)
    k_rope = apply_rope(kv[..., L:][..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    ckv = torch.cat([latent, k_rope], dim=-1)             # the cached form

    new_cache = None
    if cache is not None:
        start = pos if pos is not None else 0
        new_cache = {"ckv": update_cache(cache["ckv"], ckv, start)}
    src = new_cache["ckv"].to(cd) if pos is not None else ckv
    T = src.shape[1]
    lat, kr = src[..., :L], src[..., L:]

    if pos is not None and cfg.mla_absorb:
        # weight absorption: W_uk folded into q and W_uv into the output,
        # so attention runs over the latent cache itself
        scale = (nope + rope_d) ** -0.5
        wk_b = p["wk_b"].to(cd).reshape(L, H, nope)
        q_lat = torch.einsum("bshn,lhn->bshl", q[..., :nope], wk_b)
        s_nope = torch.einsum("bshl,btl->bhst", q_lat, lat)
        s_rope = torch.einsum("bshr,btr->bhst", q[..., nope:], kr)
        s = (s_nope + s_rope).float() * scale
        kpos = torch.arange(T, device=h.device)
        s = torch.where(kpos >= pos + S, -1e30, s)
        w = torch.softmax(s, dim=-1).to(cd)
        ctx_lat = torch.einsum("bhst,btl->bshl", w, lat)           # [B,S,H,L]
        wv_b = p["wv_b"].to(cd).reshape(L, H, vd)
        out = torch.einsum("bshl,lhv->bshv", ctx_lat, wv_b)
        return out.reshape(B, S, H * vd) @ p["wo"].to(cd), new_cache
    if pos is not None and h.device.type != "cpu":
        raise NotImplementedError(
            f"{cfg.name}: MLA decode without weight absorption needs "
            f"decode_attention at ({nope + rope_d}, {vd}), not built for "
            f"the card (ROADMAP Queue 1 item {MLA_DECODE_ITEM})")

    k_nope = (lat @ p["wk_b"].to(cd)).reshape(B, T, H, nope)
    v = (lat @ p["wv_b"].to(cd)).reshape(B, T, H, vd)
    # [B, T, H, nope + rope], contiguous: a 384-byte head stride at 192
    k = torch.cat([k_nope, kr[..., None, :].expand(B, T, H, rope_d)],
                  dim=-1)
    # the scale (nope + rope)^-0.5 is q's D^-0.5, which attention applies
    if pos is not None:
        out = attention(q, k, v, causal=False, window=window,
                        kv_len=min(pos + S, T))
    else:
        out = attention(q, k, v, causal=cfg.causal, window=window)
    return out.reshape(B, S, H * vd) @ p["wo"].to(cd), new_cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                   seq_axis: str):
    return {"ckv": P((batch, max_len, cfg.kv_lora + cfg.rope_head_dim),
                     ("batch", seq_axis, "heads"), "zeros")}
