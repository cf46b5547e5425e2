"""Core layer primitives: RMSNorm, RoPE, attention, SwiGLU, the KV-cache
update — the port of ``repro.models.layers``.

``rmsnorm`` and ``attention`` go through the kernels' dispatcher
(``kernels.ops``): on the card they launch the hand-written kernels
(``rmsnorm``, ``flash_attention`` for prefill, ``decode_attention`` for a
decode step), on the CPU their plain versions.  The reference's jnp
``layers.attention`` rounds the softmax probabilities to v's dtype before
the PV product; the kernels (Pallas and CUDA alike) keep them in f32, so
in bf16 the port differs from the reference's jnp path by that rounding
(equal up to rounding order under an f32 policy).  Everything else is
plain torch, ``chunked_xent`` (the training loss) included: its unembed
product is a ``torch.matmul``, as the reference leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import comm


def rmsnorm(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, in x's dtype.  A
    bf16 weight (deepseek-v2's and llama4-maverick's bf16 params: their
    1-D norm weights stay in the param dtype) is widened to f32 here, the
    one place, which is exact and is the reference's ``(1 +
    w.astype(f32))``; the kernel takes an f32 weight."""
    if w.dtype != torch.float32:
        w = w.float()
    return ops.rmsnorm(x, w, eps=eps)


def rope_freqs(d_head: int, theta: float, device=None):
    ar = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / d_head))


def apply_rope(x, positions, theta: float = 1e4):
    """x: [..., S, H, D]; positions: [..., S] or [S] (any int dtype), split
    halves (not interleaved), computed in f32 and cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs       # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                         # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal=True, window=0, kv_len=None):
    """GQA attention.  q: [B, Sq, Hq, D]; k: [B, Sk, Hkv, D]; v: [B, Sk,
    Hkv, Dv] -> [B, Sq, Hq, Dv], the scores scaled by D^-0.5 (MLA's v is
    narrower than q and k, and its scale is q's).

    ``kv_len is None`` (train/prefill): flash attention over all of k/v,
    causal and/or windowed.  ``kv_len`` set (decode): one query token over
    the first ``kv_len`` cache rows, which needs ``Sq == 1`` and no causal
    mask; a window masks nothing there (below).  Other combinations raise.
    """
    if kv_len is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if q.shape[1] != 1 or causal:
        raise ValueError("decode attention takes one query token and no "
                         f"causal mask, got Sq={q.shape[1]}, causal={causal}")
    # A windowed decode attends to every one of the first kv_len rows, as
    # the reference does (ROADMAP Queue 3 R1): its decode passes q_offset 0
    # (repro/models/attention.py:63-64), so the query sits at position 0,
    # and its window mask, q_pos - k_pos >= window (repro/models/
    # layers.py:45-46), is never true for k_pos >= 0.
    return ops.decode_attention(q, k, v, kv_len)


def swiglu(x, wg, wi, wo, compute_dtype):
    g = x @ wg.to(compute_dtype)
    u = x @ wi.to(compute_dtype)
    return (F.silu(g.float()).to(compute_dtype) * u) @ wo.to(compute_dtype)


def _chunk_loss(hb, unembed, lb, mb):
    """Sum over one chunk of the masked next-token CE: f32 logits of
    ``hb @ unembed`` (in hb's dtype), logsumexp minus the label's logit."""
    logits = (hb @ unembed.to(hb.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lb[..., None].long())[..., 0]
    return ((lse - tgt) * mb).sum()


def chunked_xent(h, unembed, labels, mask=None, chunk=512, group=None):
    """Next-token CE without holding ``[B, S, V]`` logits for autograd.

    h: [B, S, D] (already shifted so h[t] predicts labels[t]);
    unembed: [D, V]; labels: [B, S] int; mask: [B, S] or None.  Chunks of
    ``min(chunk, S)`` positions (S must be a multiple); under grad each
    chunk's loss is checkpointed, so its logits are recomputed in the
    backward rather than kept.  Returns the masked mean in f32 over
    ``max(count, 1)``, summed chunk by chunk as the reference's scan.
    With a data-parallel ``group``, the sum and the count are each summed
    over its ranks before the division (``comm.ratio``): the one CE of
    the global batch, the reference's, whatever each rank's mask
    holds."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_xent: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=h.device)
    grad = torch.is_grad_enabled() and (h.requires_grad
                                        or unembed.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], unembed, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        part = (checkpoint(_chunk_loss, *args, use_reentrant=False) if grad
                else _chunk_loss(*args))
        tot = tot + part
        cnt = cnt + args[3].sum()
    return comm.ratio(tot, cnt, group)


def update_cache(cache_kv, new_kv, pos: int):
    """cache_kv: [B, S_max, F]; new_kv: [B, s, F]; pos: start index.

    Out of place, like the reference's ``dynamic_update_slice``: the
    server keeps prefilled caches as fabric payloads that other decode
    batches read, so a decode step must never write into them.  The
    start is clamped to ``[0, S_max - s]`` as ``dynamic_update_slice``
    clamps it, so a step past the cache's end overwrites its last rows."""
    s = new_kv.shape[1]
    start = max(0, min(pos, cache_kv.shape[1] - s))
    out = cache_kv.clone()
    out[:, start:start + s] = new_kv.to(cache_kv.dtype)
    return out
