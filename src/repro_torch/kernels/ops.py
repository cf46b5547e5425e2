"""The kernels' dispatcher: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel, which launches or raises —
there is no fallback and no switch that selects the plain version on the
card.  A CPU tensor goes to the plain PyTorch version (``kernels.ref``),
the port's counterpart of the reference's interpret mode.  The device is
read from the lane vector of the coherence kernels (``addr``) and from
the activations of the float kernels (``x``, ``q``).

A meta tensor (the dry run's fake: shapes, no data) goes to the float
kernel's wrapper like a CUDA one; there, under ``launch.opanalysis``,
the call is charged its rule (``kernels.cost``), and the plain version
gives the outputs' shapes, none of its operators counted.  A meta tensor
never reaches a launch, and a CUDA tensor launches under the analyser
as everywhere else.

Gradients: on the CPU, autograd differentiates the plain versions.  On
the card, ``rmsnorm``, ``flash_attention`` and ``ssd_chunk`` go through
their ``autograd.Function`` (the forward kernel, and a backward kernel
as the gradient) only when grad mode is on and an input requires grad;
otherwise they launch the forward kernel directly, which keeps the
serving path's host time as it was.  ``decode_attention`` has no
backward kernel: on a CUDA tensor that requires grad it raises
``NotImplementedError`` naming the ROADMAP item, before any launch, and
never differentiates a plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.lease_probe import lease_probe as _lease_probe
from repro_torch.kernels.rmsnorm import RMSNormFn
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssd_chunk import SSDChunkFn
from repro_torch.kernels.ssd_chunk import ssd_chunk as _ssd_chunk
from repro_torch.kernels.tier_pass import miss_round as _miss_round
from repro_torch.kernels.tier_pass import write_grant as _write_grant

# the ROADMAP item that would give decode_attention a backward
DECODE_BWD_ITEM = "20: a decode_attention backward, if a consumer needs one"


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(name: str, item: str):
    return NotImplementedError(
        f"{name}: no backward kernel on the card yet (ROADMAP Queue 1 item "
        f"{item}); the port never differentiates a plain version there")


def lease_probe(tag, rts, cts, addr, mwts=None, mrts=None, *, row=None):
    if _on_cpu(addr):
        return ref.lease_probe_ref(tag, rts, cts, addr, mwts, mrts, row=row)
    return _lease_probe(tag, rts, cts, addr, mwts, mrts, row=row)


def miss_round(*args, rows=None):
    if _on_cpu(args[9]):                       # addr
        return ref.miss_round_ref(*args, rows=rows)
    return _miss_round(*args, rows=rows)


def write_grant(ts_tag, ts_mem, ts_seq, addr, wl, row=None):
    if _on_cpu(addr):
        return ref.write_grant_ref(ts_tag, ts_mem, ts_seq, addr, wl, row)
    return _write_grant(ts_tag, ts_mem, ts_seq, addr, wl, row)


def rmsnorm(x, w, *, eps=1e-6):
    if _on_cpu(x):
        return ref.rmsnorm_ref(x, w, eps)
    if _wants_grad(x, w):
        return RMSNormFn.apply(x, w, eps)
    return _rmsnorm(x, w, eps=eps)


def flash_attention(q, k, v, *, causal=True, window=0):
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len):
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=False, kv_len=kv_len)
    if _wants_grad(q, k, v):
        raise _no_backward("decode_attention", DECODE_BWD_ITEM)
    return _decode(q, k, v, kv_len)


def ssd_chunk(x, dt, A, Bc, Cc, out_dtype=None):
    if _on_cpu(x):
        return ref.ssd_chunk_ref(x, dt, A, Bc, Cc, out_dtype)
    if _wants_grad(x, dt, A, Bc, Cc):
        return SSDChunkFn.apply(x, dt, A, Bc, Cc, out_dtype)
    return _ssd_chunk(x, dt, A, Bc, Cc, out_dtype=out_dtype)
