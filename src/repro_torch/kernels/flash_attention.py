"""Flash attention (forward, prefill) on the H100, and its gradient.

Two CUDA kernels replace the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``; ``route(dtype, D,
Dv)`` picks one, as a plain function of the dtype, q and k's head dim D
and v's Dv.  The pairs ``PAIRS`` lists are built: ``(D, D)`` for D in
``HEAD_DIMS``, and MLA's ``(192, 128)`` (deepseek-v2: 128 "nope" and 64
rope columns of q and k, 128 of v; the output has v's width):

- ``"wgmma"``: bf16 at ``WGMMA_PAIRS`` goes to the tensor-core
  kernel (``csrc/flash_attention_wgmma.cu``: TMA loads, ``wgmma``
  products, P split into two bf16 halves for the P.V product; at D = 256
  two blocks share a row tile, each with half of O's columns; at D = 80,
  hubert-xlarge's, the 160-byte rows load as two 64-column boxes whose
  columns past 80 TMA fills with zeros).  TMA wants each stride over B,
  S and H, and each base pointer, to be a multiple of 16 bytes; the
  wrapper raises otherwise.  Asked with ``stats=``, it also writes each
  row's softmax max m and 1 / max(l, 1e-30).
- ``"simt"``: f32 (held to 1e-5, which TF32 tensor cores would not meet),
  and bf16 at D in (16, 32), go to the CUDA-core kernel
  (``csrc/flash_attention.cu``; at D = 80 and 256, and at (192, 128),
  each query row is split over four threads).  ``_route="simt"`` sends
  bf16 at D = 80 there too (its route before the tensor-core kernel
  took that head dim), to time the two against each other on the card;
  nothing on the model's path passes it.

The gradient ``flash_attention_bwd`` takes the same route at every pair
of ``PAIRS``: ``"wgmma"`` runs ``csrc/flash_attention_bwd_wgmma.cu`` (dQ,
then dK/dV, on the tensor cores, P recomputed from the forward's m and
1 / l, P and dS split into bf16 halves; at D = 256 two blocks share each
tile, each with half of the output columns; at MLA's (192, 128) dQ is
one block a tile at N = 192 and dV and dK are two launches, dV from P
alone), ``"simt"`` ``csrc/flash_attention_bwd.cu`` (three launches on
the CUDA cores, its own row pass; 32-row tiles at 192 and 256).  Its plain
version is autograd of the plain forward
(``kernels.ref.attention_bwd_ref``), and ``FlashAttentionFn`` joins
forward and backward for autograd, passing the forward's statistics on.
Nothing falls back at run time: a call that its route's kernel cannot
build, take or launch raises.  Both read
``[B, S, H, D]`` tensors with their strides (no transposes) and take any
Sq and Sk.  The plain version is ``kernels.ref.attention_ref``.  These
wrappers launch on CUDA tensors only and raise on anything else;
``kernels.ops.flash_attention`` is the dispatcher that sends CPU tensors
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
# MLA (deepseek-v2): q and k of nope_head_dim + rope_head_dim, v narrower
MLA_PAIR = (192, 128)
# the (q/k head dim, v head dim) pairs the forward kernels are built for
PAIRS = tuple((d, d) for d in HEAD_DIMS) + (MLA_PAIR,)
WGMMA_PAIRS = tuple((d, d) for d in WGMMA_HEAD_DIMS) + (MLA_PAIR,)
# the pairs csrc/flash_attention.cu builds bf16 code for
SIMT_BF16_PAIRS = ((16, 16), (32, 32), (80, 80))
# the head dims flash_attention_bwd's kernels are built for with v as wide
# (with MLA_PAIR: every pair of PAIRS)
BWD_HEAD_DIMS = HEAD_DIMS
ROUTES = ("wgmma", "simt")
_ARGS = ([cuda.P, cuda.LD, cuda.LD, cuda.LD] * 3 + [cuda.P] + [cuda.I] * 7
         + [cuda.F, cuda.I, cuda.I, cuda.I, cuda.P])
# no storage type code; a stats pointer after the output
_ARGS_WGMMA = _ARGS[:13] + [cuda.P] + _ARGS[13:-2] + [cuda.P]


def check_qkv(q, k, v, name: str, head_dims=HEAD_DIMS, unbuilt="",
              pairs=()):
    """Shared argument checks of the attention wrappers: 4-D CUDA tensors
    of one float dtype, k [B, Sk, Hkv, D] and v [B, Sk, Hkv, Dv], GQA
    heads that divide, and a head dim in ``head_dims`` with Dv = D, or a
    ``(D, Dv)`` in ``pairs`` (the ones the caller's kernels are built
    for; ``unbuilt`` is added to the error for any other).  Returns q's
    storage type code."""
    dev = q.device
    dt = cuda.check_float("q", q, None)
    for nm, t in (("k", k), ("v", v)):
        cuda.check_float(nm, t, dev, q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: expected q [B,Sq,Hq,D], k [B,Sk,Hkv,D] "
                         f"and v [B,Sk,Hkv,Dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    Dv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or Hq % k.shape[2]:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)}")
    if (D, Dv) not in pairs and (D != Dv or D not in head_dims):
        got = f"head dim {D}" + (f" with v's {Dv}" if Dv != D else "")
        raise ValueError(f"{name}: {got} not in {head_dims}"
                         + (f" or the (D, Dv) pairs {pairs}" if pairs
                            else "") + unbuilt)
    return dt


def route(dtype, head_dim: int, v_dim=None) -> str:
    """The kernel a CUDA call takes at q and k's ``head_dim`` and v's
    ``v_dim`` (None: the same): ``"wgmma"`` for bf16 at a pair of
    ``WGMMA_PAIRS``, ``"simt"`` for f32 and for bf16 at the other pairs
    of ``PAIRS``.  Raises ``ValueError`` on any other dtype or pair."""
    pair = (head_dim, head_dim if v_dim is None else v_dim)
    if dtype not in (torch.float32, torch.bfloat16) or pair not in PAIRS:
        raise ValueError(f"flash_attention: no kernel for {dtype} at head "
                         f"dim {head_dim}"
                         + (f" with v's {pair[1]}" if pair[1] != head_dim
                            else ""))
    if dtype == torch.bfloat16 and pair in WGMMA_PAIRS:
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


def flash_attention(q, k, v, *, causal=True, window=0, stats=None,
                    _route=None):
    """q: [B, Sq, Hq, D]; k: [B, Sk, Hkv, D]; v: [B, Sk, Hkv, Dv] ->
    [B, Sq, Hq, Dv] in q's dtype, the scores scaled by D^-0.5, at a
    ``(D, Dv)`` of ``PAIRS``.  Causal masks key positions after the
    query's (both counted from 0); ``window`` > 0 also masks keys at least
    ``window`` behind it.  Takes the kernel ``route(q.dtype, D, Dv)``
    names; allocates its output, launches on the current stream and does
    not synchronise.

    ``stats``: None, or on the ``"wgmma"`` route a ``[2, B, Hq, Sq]``
    f32 tensor that receives each row's m (the max of its unscaled masked
    products) and 1 / max(l, 1e-30), the statistics
    ``flash_attention_bwd`` recomputes P from.  Raises if asked on the
    other route.

    ``_route="simt"`` forces the CUDA-core kernel at any pair it takes
    (bf16 at D = 80 and f32 everywhere), to time the routes against each
    other on the card."""
    dt = check_qkv(q, k, v, "flash_attention", pairs=PAIRS)
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if Sk < 1:
        raise ValueError("flash_attention: needs at least one key")
    if _route not in (None, "simt"):
        raise ValueError(f"flash_attention: _route must be None or 'simt', "
                         f"got {_route!r}")
    path = route(q.dtype, D, Dv)
    if _route == "simt":
        if q.dtype == torch.bfloat16 and (D, Dv) not in SIMT_BF16_PAIRS:
            raise ValueError(f"flash_attention: the CUDA-core kernel has no "
                             f"bf16 code at head dim {D}")
        path = "simt"
    if stats is not None:
        if path != "wgmma":
            raise ValueError("flash_attention: only the tensor-core route "
                             "writes row statistics")
        check_stats("flash_attention", stats, q)
    strides = ([tma_strides(n, t) for n, t in (("q", q), ("k", k), ("v", v))]
               if path == "wgmma" else [t.stride()[:3] for t in (q, k, v)])
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    if B and Sq:
        args = []
        for t, st in zip((q, k, v), strides):
            args += [t.data_ptr(), *st]
        args.append(out.data_ptr())
        if path == "wgmma":
            args.append(0 if stats is None else stats.data_ptr())
        args += [B, Sq, Sk, Hq, Hkv, D, Dv, D ** -0.5, int(causal),
                 int(window)]
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


# (B, Sq, Sk, Hq, Hkv, D, Dv) after the pointers
_ARGS_BWD = [cuda.P] * 11 + [cuda.I] * 7 + [cuda.F, cuda.I, cuda.I, cuda.I,
                                            cuda.P]
_ARGS_BWD_WGMMA = [cuda.P] * 10 + [cuda.I] * 7 + [cuda.F, cuda.I, cuda.I,
                                                  cuda.P]


def flash_attention_bwd(q, k, v, out, dout, *, causal=True, window=0,
                        stats=None, _route=None):
    """The gradient of ``flash_attention(q, k, v, causal=causal,
    window=window)``: q [B, Sq, Hq, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv,
    Dv] and out, dout [B, Sq, Hq, Dv] at a ``(D, Dv)`` of ``PAIRS``, all
    contiguous and of one dtype, ``out`` the forward's output.  Returns
    (dq, dk, dv) in that dtype, computed in f32, with no atomics, so the
    result is the same from run to run.  Takes the kernel
    ``route(q.dtype, D, Dv)`` names:

    - ``"wgmma"``: dQ with Di = dO . O, then dK/dV (at (192, 128) dV and
      dK in two launches), recomputing P from ``stats``, the ``[2, B, Hq,
      Sq]`` row statistics the forward kernel wrote for this ``out``
      (``flash_attention(..., stats=)``, as ``FlashAttentionFn`` does);
      raises ``ValueError`` without them.  Allocates a ``[B, Hq, Sq]`` f32 scratch for Di.
    - ``"simt"``: three launches (row statistics, dK/dV, dQ); ignores
      ``stats``.  Allocates three ``[B, Hq, Sq]`` f32 rows of scratch.

    ``_route="simt"`` forces the CUDA-core kernel at any shape it takes,
    to time the two routes against each other on the card; nothing on the
    training path passes it.  Allocates its outputs, launches on the
    current stream and does not synchronise."""
    dt = check_qkv(q, k, v, "flash_attention_bwd", pairs=PAIRS)
    dev = q.device
    want = (*q.shape[:3], v.shape[3])
    for name, t in (("out", out), ("dout", dout)):
        cuda.check_float(name, t, dev, q.dtype)
        if t.shape != want:
            raise ValueError(f"flash_attention_bwd: {name} shape "
                             f"{tuple(t.shape)}, expected {want} (q's rows "
                             "and heads, v's width)")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous, got strides {t.stride()}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if Sk < 1:
        raise ValueError("flash_attention_bwd: needs at least one key")
    if _route not in (None, "simt"):
        raise ValueError(f"flash_attention_bwd: _route must be None or "
                         f"'simt', got {_route!r}")
    path = _route or route(q.dtype, D, Dv)
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
            args += [B, Sq, Sk, Hq, Hkv, D, Dv, D ** -0.5, int(causal),
                     int(window)]
        else:
            rows = torch.empty((3, B, Hq, Sq), dtype=torch.float32,
                               device=dev)
            fn = cuda.function("flash_attention_bwd",
                               "halcone_flash_attention_bwd", _ARGS_BWD)
            args = [t.data_ptr() for t in (q, k, v, out, dout, dq, dk, dv,
                                           *rows)]
            args += [B, Sq, Sk, Hq, Hkv, D, Dv, D ** -0.5, int(causal),
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
        if route(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma":
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
