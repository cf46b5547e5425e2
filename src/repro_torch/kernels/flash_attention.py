"""Flash attention (forward, prefill) on the H100.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; its plain version is
``kernels.ref.attention_ref``.  It reads ``[B, S, H, D]`` tensors with
their strides (no transposes) and takes any Sq and Sk.  This wrapper
launches on CUDA tensors only and raises on anything else;
``kernels.ops.flash_attention`` is the dispatcher that sends CPU tensors
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

HEAD_DIMS = (16, 32, 64, 128)
_ARGS = ([cuda.P, cuda.LD, cuda.LD, cuda.LD] * 3 + [cuda.P] + [cuda.I] * 6
         + [cuda.F, cuda.I, cuda.I, cuda.I, cuda.P])


def check_qkv(q, k, v, name: str):
    """Shared argument checks of the attention wrappers: 4-D CUDA tensors
    of one float dtype, k and v of one shape, GQA heads that divide, a
    head dim the kernels are built for.  Returns q's storage type code."""
    dev = q.device
    dt = cuda.check_float("q", q, None)
    for nm, t in (("k", k), ("v", v)):
        cuda.check_float(nm, t, dev, q.dtype)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q [B,Sq,Hq,D] and k, v "
                         f"[B,Sk,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or Hq % k.shape[2]:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    return dt


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype.  Causal masks key positions after the query's (both counted
    from 0); ``window`` > 0 also masks keys at least ``window`` behind it.
    Allocates its output, launches on the current stream and does not
    synchronise."""
    dt = check_qkv(q, k, v, "flash_attention")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1:
        raise ValueError("flash_attention: needs at least one key")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if B and Sq:
        fn = cuda.function("flash_attention", "halcone_flash_attention",
                           _ARGS)
        args = []
        for t in (q, k, v):
            args += [t.data_ptr(), *t.stride()[:3]]
        cuda.launch(fn, args + [out.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
                                D ** -0.5, int(causal), int(window), dt],
                    q.device)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
