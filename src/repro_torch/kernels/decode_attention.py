"""Flash-decode on the H100: one query token over a KV cache.

The CUDA kernel (``csrc/decode_attention.cu``) replaces the Pallas kernel
``repro/kernels/decode_attention.py::_decode_kernel``; its plain version
is ``kernels.ref.attention_ref(..., causal=False, kv_len=kv_len)``.  It
reads only the first ``kv_len`` cache rows, in splits of 128 combined by
a second pass.  ``kv_len`` is a host int (the reference prefetches it as
a device scalar).  This wrapper launches on CUDA tensors only and raises
on anything else; ``kernels.ops.decode_attention`` is the dispatcher that
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention import check_qkv

KEYS_PER_SPLIT = 128          # csrc/decode_attention.cu kKeys
MAX_Q_PER_KV = 16             # csrc/decode_attention.cu kMaxQpk
_ARGS = ([cuda.P, cuda.LD, cuda.LD] + [cuda.P, cuda.LD, cuda.LD, cuda.LD] * 2
         + [cuda.P] * 4 + [cuda.I] * 5 + [cuda.F, cuda.I, cuda.P])


def decode_attention(q, k, v, kv_len):
    """q: [B, 1, Hq, D]; k, v: [B, Sk, Hkv, D]; kv_len: int in [1, Sk].
    Returns [B, 1, Hq, D] in q's dtype.  Allocates its output and the
    per-split scratch, launches on the current stream and does not
    synchronise."""
    dt = check_qkv(q, k, v, "decode_attention")
    if isinstance(kv_len, torch.Tensor):
        raise TypeError("decode_attention: kv_len must be a host int (a "
                        "tensor would cost a device sync)")
    kv_len = int(kv_len)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sq != 1:
        raise ValueError(f"decode_attention: expected one query token, got "
                         f"Sq={Sq}")
    if not 1 <= kv_len <= Sk:
        raise ValueError(f"decode_attention: kv_len={kv_len} outside "
                         f"[1, {Sk}]")
    if Hq // Hkv > MAX_Q_PER_KV:
        raise ValueError(f"decode_attention: {Hq // Hkv} query heads per kv "
                         f"head, at most {MAX_Q_PER_KV}")
    dev = q.device
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    if B:
        nsplit = -(-kv_len // KEYS_PER_SPLIT)
        f32 = dict(dtype=torch.float32, device=dev)
        pm = torch.empty((B, Hq, nsplit), **f32)
        pl = torch.empty((B, Hq, nsplit), **f32)
        pacc = torch.empty((B, Hq, nsplit, D), **f32)
        fn = cuda.function("decode_attention", "halcone_decode_attention",
                           _ARGS)
        args = [q.data_ptr(), q.stride(0), q.stride(2)]
        for t in (k, v):
            args += [t.data_ptr(), *t.stride()[:3]]
        cuda.launch(fn, args + [pm.data_ptr(), pl.data_ptr(),
                                pacc.data_ptr(), out.data_ptr(), B, Hq, Hkv,
                                D, kv_len, D ** -0.5, dt], dev)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
