"""The kernels' dispatcher: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel, which launches or raises —
there is no fallback and no switch that selects the plain version on the
card.  A CPU tensor goes to the plain PyTorch version (``kernels.ref``),
the port's counterpart of the reference's interpret mode.  The device is
read from the lane vector of the coherence kernels (``addr``) and from
the activations of the float kernels (``x``, ``q``).
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.lease_probe import lease_probe as _lease_probe
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.tier_pass import miss_round as _miss_round
from repro_torch.kernels.tier_pass import write_grant as _write_grant


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def lease_probe(tag_rows, rts_rows, cts, addr, mwts, mrts):
    if _on_cpu(addr):
        return ref.lease_probe_ref(tag_rows, rts_rows, cts, addr, mwts, mrts)
    return _lease_probe(tag_rows, rts_rows, cts, addr, mwts, mrts)


def miss_round(*args):
    if _on_cpu(args[9]):                       # addr
        return ref.miss_round_ref(*args)
    return _miss_round(*args)


def write_grant(*args):
    if _on_cpu(args[3]):                       # addr
        return ref.write_grant_ref(*args)
    return _write_grant(*args)


def rmsnorm(x, w, *, eps=1e-6):
    if _on_cpu(x):
        return ref.rmsnorm_ref(x, w, eps)
    return _rmsnorm(x, w, eps=eps)


def flash_attention(q, k, v, *, causal=True, window=0):
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _flash(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len):
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=False, kv_len=kv_len)
    return _decode(q, k, v, kv_len)
