"""Flash-decode on the H100: one query token over a KV cache.

The CUDA kernel (``csrc/decode_attention.cu``) replaces the Pallas kernel
``repro/kernels/decode_attention.py::_decode_kernel``; its plain version
is ``kernels.ref.attention_ref(..., causal=False, kv_len=kv_len)``.  It
reads only the first ``kv_len`` cache rows, in one launch: a cluster of
up to 8 blocks per (batch row, kv head) that combine their partial
softmax through distributed shared memory.  Head dims: ``HEAD_DIMS``
(D = 80 is not built: hubert-xlarge, its only user, is an encoder with
no decode step; ROADMAP Queue 1 item 23 builds it if a decoder needs
it).  ``kv_len`` is a host int (the
reference prefetches it as a device scalar).  k and v rows are copied
16 bytes at a time, so their base pointers and strides over B, S and H
must be multiples of 16 bytes.  This wrapper launches on CUDA tensors
only and raises on anything else; ``kernels.ops.decode_attention`` is the
dispatcher that sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost, cuda, ref
from repro_torch.kernels.flash_attention import check_qkv

MAX_Q_PER_KV = 16             # csrc/decode_attention.cu kMaxQpk
HEAD_DIMS = (16, 32, 64, 128, 256)
_ARGS = ([cuda.P, cuda.LD, cuda.LD] + [cuda.P, cuda.LD, cuda.LD, cuda.LD] * 2
         + [cuda.P] + [cuda.I] * 5 + [cuda.F, cuda.I, cuda.P])


def decode_attention(q, k, v, kv_len):
    """q: [B, 1, Hq, D]; k, v: [B, Sk, Hkv, D]; kv_len: int in [1, Sk].
    Returns [B, 1, Hq, D] in q's dtype.  Allocates its output (and
    nothing else), launches on the current stream and does not
    synchronise.  Under ``launch.opanalysis`` it is charged its cost rule;
    on a fake its plain version gives the output."""
    if cost.current() is not None:
        cost.charge("decode_attention", cost.decode_cost, q.shape[0],
                    q.shape[2], k.shape[2], q.shape[3], v.shape[3],
                    kv_len, q.dtype)
    if cost.is_fake(q):
        return cost.plain(ref.attention_ref, q, k, v, causal=False,
                          kv_len=kv_len)
    dt = check_qkv(q, k, v, "decode_attention", HEAD_DIMS,
                   " (D = 80 is ROADMAP Queue 1 item 23)")
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
    for name, t in (("k", k), ("v", v)):
        cuda.check_rows_16b(f"decode_attention: {name}", t)
    dev = q.device
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    if B:
        fn = cuda.function("decode_attention", "halcone_decode_attention",
                           _ARGS)
        args = [q.data_ptr(), q.stride(0), q.stride(2)]
        for t in (k, v):
            args += [t.data_ptr(), *t.stride()[:3]]
        cuda.launch(fn, args + [out.data_ptr(), B, Hq, Hkv, D, kv_len,
                                D ** -0.5, dt], dev)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
