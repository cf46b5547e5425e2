"""Flash attention (forward, prefill) on the H100, and its gradient.

Two CUDA kernels replace the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; ``route(dtype, D)``
picks one, as a plain function of the dtype and the head dim:

- ``"wgmma"``: bf16 with D in (64, 128) goes to the tensor-core kernel
  (``csrc/flash_attention_wgmma.cu``: TMA loads, ``wgmma`` products, P
  split into two bf16 halves for the P.V product).  TMA wants each stride
  over B, S and H, and each base pointer, to be a multiple of 16 bytes;
  the wrapper raises otherwise.  Asked with ``stats=``, it also writes
  each row's softmax max m and 1 / max(l, 1e-30).
- ``"simt"``: f32 (held to 1e-5, which TF32 tensor cores would not meet),
  and bf16 at D in (16, 32), go to the CUDA-core kernel
  (``csrc/flash_attention.cu``).

The gradient ``flash_attention_bwd`` takes the same route: ``"wgmma"``
runs ``csrc/flash_attention_bwd_wgmma.cu`` (two launches on the tensor
cores, P recomputed from the forward's m and 1 / l, P and dS split into
bf16 halves), ``"simt"`` ``csrc/flash_attention_bwd.cu`` (three launches
on the CUDA cores, its own row pass).  Its plain version is autograd of
the plain forward (``kernels.ref.attention_bwd_ref``), and
``FlashAttentionFn`` joins forward and backward for autograd, passing the
forward's statistics on.  Nothing falls back at run time: a call that its
route's kernel cannot build, take or launch raises.  Both read
``[B, S, H, D]`` tensors with their strides (no transposes) and take any
Sq and Sk.  The plain version is ``kernels.ref.attention_ref``.  These
wrappers launch on CUDA tensors only and raise on anything else;
``kernels.ops.flash_attention`` is the dispatcher that sends CPU tensors
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "simt")
_ARGS = ([cuda.P, cuda.LD, cuda.LD, cuda.LD] * 3 + [cuda.P] + [cuda.I] * 6
         + [cuda.F, cuda.I, cuda.I, cuda.I, cuda.P])
# no storage type code; a stats pointer after the output
_ARGS_WGMMA = _ARGS[:13] + [cuda.P] + _ARGS[13:-2] + [cuda.P]


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


def check_stats(name: str, stats, q) -> None:
    """Raise unless ``stats`` is the ``[2, B, Hq, Sq]`` contiguous f32
    tensor of row statistics for ``q`` [B, Sq, Hq, D], on q's device."""
    B, Sq, Hq, _ = q.shape
    if not isinstance(stats, torch.Tensor) or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous() \
            or stats.shape != (2, B, Hq, Sq):
        raise ValueError(f"{name}: stats must be a contiguous float32 "
                         f"tensor of shape {(2, B, Hq, Sq)} on {q.device}")


def flash_attention(q, k, v, *, causal=True, window=0, stats=None):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype.  Causal masks key positions after the query's (both counted
    from 0); ``window`` > 0 also masks keys at least ``window`` behind it.
    Takes the kernel ``route(q.dtype, D)`` names; allocates its output,
    launches on the current stream and does not synchronise.

    ``stats``: None, or on the ``"wgmma"`` route a ``[2, B, Hq, Sq]`` f32
    tensor that receives each row's m (the max of its unscaled masked
    products) and 1 / max(l, 1e-30), the statistics
    ``flash_attention_bwd`` recomputes P from.  The ``"simt"`` kernel
    writes none, and raises if asked."""
    dt = check_qkv(q, k, v, "flash_attention")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1:
        raise ValueError("flash_attention: needs at least one key")
    path = route(q.dtype, D)
    if stats is not None:
        if path != "wgmma":
            raise ValueError("flash_attention: only the tensor-core route "
                             "writes row statistics")
        check_stats("flash_attention", stats, q)
    strides = ([tma_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v))]
               if path == "wgmma" else [t.stride()[:3] for t in (q, k, v)])
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if B and Sq:
        args = []
        for t, st in zip((q, k, v), strides):
            args += [t.data_ptr(), *st]
        args.append(out.data_ptr())
        if path == "wgmma":
            args.append(0 if stats is None else stats.data_ptr())
        args += [B, Sq, Sk, Hq, Hkv, D, D ** -0.5, int(causal), int(window)]
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
        flash_attention.stats_writes += stats is not None
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
# launches that also wrote row statistics (under grad only)
flash_attention.stats_writes = 0


_ARGS_BWD = [cuda.P] * 11 + [cuda.I] * 6 + [cuda.F, cuda.I, cuda.I, cuda.I,
                                            cuda.P]
_ARGS_BWD_WGMMA = [cuda.P] * 10 + [cuda.I] * 6 + [cuda.F, cuda.I, cuda.I,
                                                  cuda.P]


def flash_attention_bwd(q, k, v, out, dout, *, causal=True, window=0,
                        stats=None, _route=None):
    """The gradient of ``flash_attention(q, k, v, causal=causal,
    window=window)``: q, out, dout [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D],
    all contiguous and of one dtype, ``out`` the forward's output.
    Returns (dq, dk, dv) in that dtype, computed in f32, with no atomics,
    so the result is the same from run to run.  Takes the kernel
    ``route(q.dtype, D)`` names:

    - ``"wgmma"``: two launches (dQ with Di = dO . O, then dK/dV) that
      recompute P from ``stats``, the ``[2, B, Hq, Sq]`` row statistics
      the forward kernel wrote for this ``out`` (``flash_attention(...,
      stats=)``, as ``FlashAttentionFn`` does); raises ``ValueError``
      without them.  Allocates a ``[B, Hq, Sq]`` f32 scratch for Di.
    - ``"simt"``: three launches (row statistics, dK/dV, dQ); ignores
      ``stats``.  Allocates three ``[B, Hq, Sq]`` f32 rows of scratch.

    ``_route="simt"`` forces the CUDA-core kernel at any shape it takes,
    to time the two routes against each other on the card; nothing on the
    training path passes it.  Allocates its outputs, launches on the
    current stream and does not synchronise."""
    dt = check_qkv(q, k, v, "flash_attention_bwd")
    dev = q.device
    for name, t in (("out", out), ("dout", dout)):
        cuda.check_float(name, t, dev, q.dtype)
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} shape "
                             f"{tuple(t.shape)}, q has {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous, got strides {t.stride()}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1:
        raise ValueError("flash_attention_bwd: needs at least one key")
    if _route not in (None, "simt"):
        raise ValueError(f"flash_attention_bwd: _route must be None or "
                         f"'simt', got {_route!r}")
    path = _route or route(q.dtype, D)
    if path == "wgmma":
        if stats is None:
            raise ValueError(
                "flash_attention_bwd: the tensor-core route recomputes P "
                "from the forward's row statistics; pass the stats= that "
                "flash_attention(..., stats=) wrote, as FlashAttentionFn "
                "does")
        check_stats("flash_attention_bwd", stats, q)
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                        ("dout", dout)):
            cuda.check_rows_16b(f"flash_attention_bwd (tensor-core route): "
                                f"{name}", t)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B and Sq:
        if path == "wgmma":
            di = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
            fn = cuda.function("flash_attention_bwd_wgmma",
                               "halcone_flash_attention_bwd_wgmma",
                               _ARGS_BWD_WGMMA)
            args = [t.data_ptr() for t in (q, k, v, out, dout, stats, dq, dk,
                                           dv, di)]
            args += [B, Sq, Sk, Hq, Hkv, D, D ** -0.5, int(causal),
                     int(window)]
        else:
            rows = torch.empty((3, B, Hq, Sq), dtype=torch.float32,
                               device=dev)
            fn = cuda.function("flash_attention_bwd",
                               "halcone_flash_attention_bwd", _ARGS_BWD)
            args = [t.data_ptr() for t in (q, k, v, out, dout, dq, dk, dv,
                                           *rows)]
            args += [B, Sq, Sk, Hq, Hkv, D, D ** -0.5, int(causal),
                     int(window), dt]
        cuda.launch(fn, args, dev)
        flash_attention_bwd.launches += 1
        flash_attention_bwd.route_launches[path] += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with ``flash_attention_bwd`` as its gradient,
    both kernels.  On the ``"wgmma"`` route the forward also writes its
    row statistics, saved beside its output for the backward: a
    recomputed forward (``torch.utils.checkpoint``) saves its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = (t.contiguous() for t in (q, k, v))
        stats = None
        if route(q.dtype, q.shape[-1]) == "wgmma":
            B, Sq, Hq, _ = q.shape
            stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32,
                                device=q.device)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              stats=stats)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window, stats=stats)
        return dq, dk, dv, None, None
