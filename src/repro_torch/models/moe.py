"""Token-choice top-k MoE with capacity-based scatter dispatch — the port
of the one-device path of ``repro.models.moe`` (``moe_spec``,
``capacity_for`` and ``_moe_gspmd``).

Dispatch avoids the ``[T, E, C]`` one-hot: each token choice's position
in its expert is a cumsum over a ``[T*k, E]`` int32 one-hot, and the
token embeddings are scattered into an ``[E*C + 1, D]`` buffer whose last
row takes the choices past an expert's capacity C (dropped).  The order
of the flattened ``[T*k]`` choices (token-major) decides who is dropped.
The router product, the expert products (``torch.bmm`` over all E
experts, as the reference's einsums) and the shared experts are plain
torch: the reference computes them outside any Pallas kernel.

The reference's expert-parallel path (``_moe_shard_map``: tokens and
experts over a mesh, one ``all_to_all`` each way) is not ported: on one
device the reference takes ``_moe_gspmd`` whenever no mesh has a
``"model"`` axis, and the port takes it for every config (ROADMAP Queue 1
item 25 ports expert parallelism over a ``torch.distributed`` group).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.params import P


def moe_spec(cfg: ModelConfig) -> dict:
    D, E = cfg.d_model, cfg.n_experts
    Fe = cfg.d_ff_expert or cfg.d_ff
    s = {
        "router": P((D, E), ("embed", None)),
        "wg": P((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wi": P((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wo": P((E, Fe, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        s["shared"] = {
            "wg": P((D, Fs), ("embed", "mlp")),
            "wi": P((D, Fs), ("embed", "mlp")),
            "wo": P((Fs, D), ("mlp", "embed")),
        }
    return s


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert: ``ceil(T k / E * capacity_factor)`` rounded up to
    a multiple of 8, at least 8 (so a decode step's T = B still has 8)."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def top_k(gates, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal values.  ``torch.topk`` promises no
    order on ties, and bf16 router logits tie often (two of 160 experts),
    so this is a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p: dict, x):
    """The router: x [T, D] in the compute dtype -> (gates [T, E] f32,
    topv [T, k] renormalised, topi [T, k]); the logits are taken in x's
    dtype and widened, as the reference's."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, cfg.top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return gates, topv, topi


def dispatch(cfg: ModelConfig, topi, C: int):
    """Each flattened choice's buffer row: (dest [T*k], keep [T*k]).  The
    choice j of expert e at position ``mypos`` (the count of earlier
    choices of e, token-major) goes to row ``e * C + mypos`` if
    ``mypos < C``, else to the discard row ``E * C``."""
    E = cfg.n_experts
    fe = topi.reshape(-1)
    onehot = (fe[:, None] == torch.arange(E, device=fe.device)[None, :]
              ).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=0) - 1                  # [T*k, E]
    mypos = torch.gather(pos_all, 1, fe[:, None])[:, 0]
    keep = mypos < C
    dest = torch.where(keep, fe * C + mypos, E * C)
    return dest, keep


def moe_apply(cfg: ModelConfig, p: dict, h, *, want_aux: bool = True):
    """h: [B, S, D] -> (out [B, S, D], aux) with aux the Switch-style
    load-balance loss ``E * sum(f_e * mean(gates))`` (f32 scalar; f_e the
    share of the T*k choices that picked e), or None when not
    ``want_aux`` (serving skips it)."""
    B, S, D = h.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity_for(cfg, T)
    cd = h.dtype
    x = h.reshape(T, D)
    gates, topv, topi = route(cfg, p, x)
    aux = None
    if want_aux:
        f_e = torch.zeros(E, dtype=torch.float32, device=h.device).index_add_(
            0, topi.reshape(-1),
            torch.ones(T * k, dtype=torch.float32, device=h.device)) / (T * k)
        aux = E * torch.sum(f_e * gates.mean(0))

    dest, keep = dispatch(cfg, topi, C)
    x_rep = x.repeat_interleave(k, dim=0)                      # [T*k, D]
    # repeated targets only on the discard row, which is sliced away
    buf = torch.zeros((E * C + 1, D), dtype=cd, device=h.device)
    buf = buf.index_copy(0, dest, x_rep)
    xe = buf[:E * C].reshape(E, C, D)
    g = torch.bmm(xe, p["wg"].to(cd))
    u = torch.bmm(xe, p["wi"].to(cd))
    act = F.silu(g.float()).to(cd) * u
    ye = torch.bmm(act, p["wo"].to(cd))                        # [E, C, D]

    y_pad = torch.cat([ye.reshape(E * C, D),
                       torch.zeros((1, D), dtype=cd, device=h.device)], 0)
    y_tok = y_pad[dest] * (keep[:, None] * topv.reshape(T * k)[:, None]
                           ).to(cd)
    out = y_tok.reshape(T, k, D).sum(dim=1)
    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + swiglu(x, sp["wg"], sp["wi"], sp["wo"], cd)
    return out.reshape(B, S, D), aux
