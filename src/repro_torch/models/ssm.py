"""Mamba2 (SSD, state-space duality) block — the port of
``repro.models.ssm``: the chunked scan for prefill, the one-step
recurrence for decode.

The intra-chunk step goes through the kernels' dispatcher
(``kernels.ops.ssd_chunk``): on the card the hand-written ``ssd_chunk``
kernel, on the CPU its plain version.  The inter-chunk scan is a Python
loop over chunks in f32, as ``tests/test_kernels.py`` composes the
reference's Pallas kernel with it.  The reference's jnp ``ssd_chunked``
keeps the intra-chunk part in f32, adds the inter-chunk part and rounds
once; the port asks the kernel for the intra-chunk part in f32
(``out_dtype``) and does the same, so under a bf16 policy the sum is
rounded once, where the reference rounds it.

Rounding points follow the reference: the conv window, the ``silu`` input
cast and the gated-norm input are in the compute dtype, and the state is
stored in the cache dtype after every step.  torch does not promote dtypes
in ``einsum``; where the reference mixes a compute-dtype operand with the
f32 state (jnp promotes to f32), the port casts it to f32 first.  The
cache given to ``ssm_apply`` is never written: a prefix payload that
other decode batches read stays as it was.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import P


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    H = cfg.ssm_heads or d_in // cfg.ssm_head_dim
    Pd = d_in // H
    G, N = cfg.ssm_groups, cfg.ssm_state
    return d_in, H, Pd, G, N


def ssm_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_in, H, Pd, G, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * G * N
    return {
        "in_proj": P((D, 2 * d_in + 2 * G * N + H), ("embed", "mlp")),
        "conv_w": P((cfg.d_conv, conv_dim), (None, "mlp"), "fan_in"),
        "conv_b": P((conv_dim,), ("mlp",), "zeros"),
        "A_log": P((H,), (None,), "a_log"),
        "D_skip": P((H,), (None,), "ones"),
        "dt_bias": P((H,), (None,), "zeros"),
        "norm_w": P((d_in,), ("mlp",), "zeros"),
        "out_proj": P((d_in, D), ("mlp", "embed")),
    }


def ssm_cache_spec(cfg: ModelConfig, batch: int) -> dict:
    d_in, H, Pd, G, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * G * N
    return {
        "conv": P((batch, cfg.d_conv - 1, conv_dim), ("batch", None, "mlp"),
                  "zeros"),
        "state": P((batch, H, N, Pd), ("batch", None, "dstate", None),
                   "zeros"),
    }


def _causal_conv(x, w, b):
    """x: [B, S, C]; w: [K, C] depthwise causal; summed from term 0 in
    x's dtype, as the reference's Python ``sum``."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _heads(t, H: int):
    """[..., G, N] -> [..., H, N]: group g serves heads g*H/G .. (g+1)*H/G
    - 1 (``jnp.repeat``); a stride-0 view, not a copy, when G == 1."""
    G = t.shape[-2]
    if G == 1:
        return t.expand(*t.shape[:-2], H, t.shape[-1])
    return t.repeat_interleave(H // G, dim=-2)


def ssd_chunked(x, dt, A, Bc, Cc, chunk: int, state0=None):
    """SSD chunked algorithm.

    x: [B,S,H,P]; dt: [B,S,H] f32; A: [H] f32 (negative); Bc/Cc:
    [B,S,G,N].  Returns (y [B,S,H,P] in x's dtype, final_state [B,H,N,P]
    f32).  ``chunk`` must divide S: the reference asserts it, and the
    port raises rather than pad."""
    B, S, H, Pd = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide the "
                         f"sequence length {S}")
    nc = S // chunk
    y_intra, chunk_state, cum = ops.ssd_chunk(
        x.reshape(B, nc, chunk, H, Pd), dt.float().reshape(B, nc, chunk, H),
        A.float(), _heads(Bc.reshape(B, nc, chunk, G, N), H),
        _heads(Cc.reshape(B, nc, chunk, G, N), H), torch.float32)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,nc,H]
    state = (torch.zeros((B, H, N, Pd), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    Cg = Cc.float().reshape(B, nc, chunk, G, N)
    ys = []
    for c in range(nc):
        decay_in = torch.exp(cum[:, c])                         # [B,Q,H]
        y_inter = torch.einsum(
            "bqgn,bgknp->bqgkp", Cg[:, c],
            state.reshape(B, G, H // G, N, Pd)).reshape(B, chunk, H, Pd)
        ys.append(y_intra[:, c] + y_inter * decay_in[..., None])
        state = state * chunk_decay[:, c][:, :, None, None] + chunk_state[:, c]
    y = torch.stack(ys, 1).reshape(B, S, H, Pd)
    return y.to(x.dtype), state


def _compact(t, dtype):
    """``t`` in ``dtype`` as a tensor of its own (a slice would keep the
    whole projection it views alive in the cache)."""
    return t.to(dtype).contiguous()


def ssm_apply(cfg: ModelConfig, p: dict, h, *, cache=None):
    """h: [B,S,D] -> (out, new_cache).  cache = {'conv': [B,K-1,Cd],
    'state': [B,H,N,P]}; with a cache, S == 1 is a decode step and S > 1
    a prefill that snapshots the final state and the conv tail."""
    B, S, D = h.shape
    d_in, H, Pd, G, N = ssm_dims(cfg)
    cd = h.dtype
    zxbcdt = h @ p["in_proj"].to(cd)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * G * N:]
    conv_w, conv_b = p["conv_w"].to(cd), p["conv_b"].to(cd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())     # [B,S,H]
    A = -torch.exp(p["A_log"].float())
    D_skip = p["D_skip"].float()

    new_cache = None
    if cache is not None and S == 1:                    # decode step
        window = torch.cat([cache["conv"].to(cd), xBC], dim=1)
        xBC_t = (window * conv_w[None]).sum(1, keepdim=True) \
            + conv_b[None, None]
        xBC = F.silu(xBC_t.float()).to(cd)
        x = xBC[..., :d_in].reshape(B, 1, H, Pd)
        Bc = xBC[..., d_in:d_in + G * N].reshape(B, 1, G, N)
        Cc = xBC[..., d_in + G * N:].reshape(B, 1, G, N)
        dA = torch.exp(dt[:, 0, :] * A[None])                  # [B,H]
        xf = x[:, 0].float()
        state = cache["state"].float()
        state = state * dA[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", _heads(Bc[:, 0], H).float() * dt[:, 0, :, None],
            xf)
        y = torch.einsum("bhn,bhnp->bhp", _heads(Cc[:, 0], H).float(), state)
        y = y + D_skip[None, :, None] * xf
        y = y.reshape(B, 1, d_in).to(cd)
        new_cache = {"conv": _compact(window[:, 1:], cache["conv"].dtype),
                     "state": state.to(cache["state"].dtype)}
    else:                                               # prefill
        xBC_c = F.silu(_causal_conv(xBC, conv_w, conv_b).float()).to(cd)
        x = xBC_c[..., :d_in].reshape(B, S, H, Pd)
        Bc = xBC_c[..., d_in:d_in + G * N].reshape(B, S, G, N)
        Cc = xBC_c[..., d_in + G * N:].reshape(B, S, G, N)
        y4, final = ssd_chunked(x, dt, A, Bc, Cc, min(cfg.ssd_chunk, S))
        y = y4.float() + D_skip[None, None, :, None] * x.float()
        y = y.reshape(B, S, d_in).to(cd)
        if cache is not None:       # the conv tail is the PRE-conv input
            K = cfg.d_conv
            new_cache = {"conv": _compact(xBC[:, -(K - 1):],
                                          cache["conv"].dtype),
                         "state": final.to(cache["state"].dtype)}

    g = y.float() * F.silu(z.float())
    g = rmsnorm(g.to(cd), p["norm_w"], cfg.rms_eps)
    return g @ p["out_proj"].to(cd), new_cache
