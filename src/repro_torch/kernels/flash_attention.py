"""Flash attention (forward, prefill) on the H100.

Two CUDA kernels replace the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; ``route(dtype, D)``
picks one, as a plain function of the dtype and the head dim:

- ``"wgmma"``: bf16 with D in (64, 128) goes to the tensor-core kernel
  (``csrc/flash_attention_wgmma.cu``: TMA loads, ``wgmma`` products, P
  split into two bf16 halves for the P.V product).  TMA wants each stride
  over B, S and H, and each base pointer, to be a multiple of 16 bytes;
  the wrapper raises otherwise.
- ``"simt"``: f32 (held to 1e-5, which TF32 tensor cores would not meet),
  and bf16 at D in (16, 32), go to the CUDA-core kernel
  (``csrc/flash_attention.cu``).

Nothing falls back at run time: a call that its route's kernel cannot
build, take or launch raises.  Both read ``[B, S, H, D]`` tensors with
their strides (no transposes) and take any Sq and Sk.  The plain version
is ``kernels.ref.attention_ref``.  This wrapper launches on CUDA tensors
only and raises on anything else; ``kernels.ops.flash_attention`` is the
dispatcher that sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "simt")
_ARGS = ([cuda.P, cuda.LD, cuda.LD, cuda.LD] * 3 + [cuda.P] + [cuda.I] * 6
         + [cuda.F, cuda.I, cuda.I, cuda.I, cuda.P])
_ARGS_WGMMA = _ARGS[:-2] + [cuda.P]       # no storage type code


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


def route(dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 with a head dim
    in ``WGMMA_HEAD_DIMS``, ``"simt"`` for f32 and for bf16 at the other
    head dims of ``HEAD_DIMS``.  Raises ``ValueError`` on any other pair."""
    if dtype not in (torch.float32, torch.bfloat16) \
            or head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for {dtype} at head "
                         f"dim {head_dim}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def tma_strides(name: str, t) -> list:
    """``t``'s element strides over (B, S, H) for a TMA tensor map; a dim
    of size 1 gets its contiguous stride, since only its index 0 is read.
    Raises unless the base pointer and every stride of a dim longer than 1
    are multiples of 16 bytes."""
    cuda.check_rows_16b(f"flash_attention (tensor-core route): {name}", t)
    B, S, H, D = t.shape
    return [inner if n == 1 else s for n, s, inner in
            zip((B, S, H), t.stride()[:3], (S * H * D, H * D, D))]


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype.  Causal masks key positions after the query's (both counted
    from 0); ``window`` > 0 also masks keys at least ``window`` behind it.
    Takes the kernel ``route(q.dtype, D)`` names; allocates its output,
    launches on the current stream and does not synchronise."""
    dt = check_qkv(q, k, v, "flash_attention")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1:
        raise ValueError("flash_attention: needs at least one key")
    path = route(q.dtype, D)
    strides = ([tma_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v))]
               if path == "wgmma" else [t.stride()[:3] for t in (q, k, v)])
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if B and Sq:
        args = []
        for t, st in zip((q, k, v), strides):
            args += [t.data_ptr(), *st]
        args += [out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, D ** -0.5,
                 int(causal), int(window)]
        if path == "wgmma":
            fn = cuda.function("flash_attention_wgmma",
                               "halcone_flash_attention_wgmma", _ARGS_WGMMA)
        else:
            fn = cuda.function("flash_attention", "halcone_flash_attention",
                               _ARGS)
            args.append(dt)
        cuda.launch(fn, args, q.device)
        flash_attention.launches += 1
        flash_attention.route_launches[path] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
