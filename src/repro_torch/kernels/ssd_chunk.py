"""The Mamba2 SSD intra-chunk step on the H100.

Two CUDA kernels replace the Pallas kernel
``repro/kernels/ssd_chunk.py::_ssd_kernel``; ``route(dtype, P, N)`` picks
one, as a plain function of the dtype, the head dim P and the state dim
N:

- ``"wgmma"``: bf16 with P and N in (64, 128) goes to the tensor-core
  kernel (``csrc/ssd_chunk_wgmma.cu``: TMA loads, ``wgmma`` products, the
  decay weights split into two bf16 halves).  TMA wants x, B and C to
  start on 16 bytes with every stride over their first four dims a whole
  16 bytes; the wrapper raises otherwise.
- ``"simt"``: f32 (held to 1e-5, which TF32 tensor cores would miss),
  and bf16 at the other shapes, go to the CUDA-core kernels
  (``csrc/ssd_chunk.cu``: an output pass and a state pass).

Nothing falls back at run time: a call that its route's kernel cannot
build, take or launch raises.  Both read x, B and C with their strides,
so the model passes a group's B/C broadcast to its heads as a stride-0
view and never builds the per-head copy (the tensor-core kernel reads it
through a map whose head dim has size 1).  y comes back in x's dtype or,
with ``out_dtype=torch.float32``, in f32.  The plain version is
``kernels.ref.ssd_chunk_ref``.  This wrapper launches on CUDA tensors
only and raises on anything else; ``kernels.ops.ssd_chunk`` is the
dispatcher that sends CPU tensors to the plain version.

The gradient: ``ssd_chunk_bwd`` takes the cotangents of y, the state and
cum and returns those of x, dt, A, B and C, on the forward's route:
``"wgmma"`` (``csrc/ssd_chunk_bwd_wgmma.cu``: a query and a key pass on
TMA and ``wgmma``, the f32 operands dy, dstate and the weights split into
bf16 halves; x, B and C under the forward's TMA rules) or ``"simt"``
(``csrc/ssd_chunk_bwd.cu``, f32 on the CUDA cores); each ends in the same
chunk and dA passes, four launches with fixed-order sums.
``SSDChunkFn`` pairs it with the forward under autograd.  Its plain
version is ``kernels.ref.ssd_chunk_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost, cuda, ref

HEAD_DIMS = (16, 32, 64, 128)   # P: csrc/ssd_chunk.cu's instantiations
WGMMA_DIMS = (64, 128)          # P and N: csrc/ssd_chunk_wgmma.cu's
ROUTES = ("wgmma", "simt")
MAX_STATE = 256                 # N: two [64, N+1] f32 tiles in shared memory
MAX_CHUNK = 1024                # Q: cum and dt of a chunk in shared memory
MAX_GRID_Z = 65535              # one grid z per (batch, chunk)
_ARGS = ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] \
    + ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] * 3 + [cuda.I] * 8 \
    + [cuda.P]
_ARGS_BWD = ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] \
    + ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] * 10 + [cuda.I] * 7 \
    + [cuda.P]
_ARGS_WGMMA = ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] \
    + ([cuda.P] + [cuda.LD] * 4 + [cuda.I]) * 2 + [cuda.P] * 3 \
    + [cuda.I] * 7 + [cuda.P]
_ARGS_BWD_WGMMA = ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] \
    + ([cuda.P] + [cuda.LD] * 4 + [cuda.I]) * 2 + [cuda.P] * 11 \
    + [cuda.I] * 6 + [cuda.P]


def route(dtype, P: int, N: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 with P and N in
    ``WGMMA_DIMS``, ``"simt"`` for f32 and for bf16 at the other P in
    ``HEAD_DIMS`` and N in [1, ``MAX_STATE``].  Raises ``ValueError`` on
    any other triple."""
    if dtype not in (torch.float32, torch.bfloat16) or P not in HEAD_DIMS \
            or not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_chunk: no kernel for {dtype} at head dim "
                         f"P={P} (one of {HEAD_DIMS}) and state dim N={N} "
                         f"(1 to {MAX_STATE})")
    if dtype == torch.bfloat16 and P in WGMMA_DIMS and N in WGMMA_DIMS:
        return "wgmma"
    return "simt"


def pick(name: str, dtype, P: int, N: int, path=None) -> str:
    """The kernel a call of ``name`` takes: ``route(dtype, P, N)``, or
    ``path="simt"`` (the CUDA-core kernels take every shape); raises
    ``ValueError`` on a route that does not take the call."""
    routed = route(dtype, P, N)
    path = routed if path is None else path
    if path not in (routed, "simt"):
        raise ValueError(f"{name}: the {path!r} kernel does not take "
                         f"{dtype} at P={P}, N={N}")
    return path


def tma_view(name: str, t, broadcast: bool = True):
    """``t``'s element strides over (b, c, q, h) for a TMA tensor map, and
    the map's head count: with ``broadcast``, a head stride of 0 (a group
    broadcast to its heads) reads through a head dim of size 1; a dim of
    size 1 takes its contiguous stride, since only its index 0 is read.
    Raises unless the base pointer and every other stride of a dim longer
    than 1 are multiples of 16 bytes, and on a stride of 0 that is not a
    broadcast head."""
    cuda.check_rows_16b(f"ssd_chunk (tensor-core route): {name}", t)
    Bsz, nc, Q, H, W = t.shape
    heads = 1 if broadcast and H > 1 and t.stride(3) == 0 else H
    if any(n > 1 and s == 0 for n, s in
           zip((Bsz, nc, Q, heads), t.stride()[:4])):
        raise ValueError(f"ssd_chunk (tensor-core route): {name} has a "
                         f"stride of 0 TMA cannot read: {t.stride()}")
    inner = (nc * Q * H * W, Q * H * W, H * W, W)
    strides = [c if n == 1 else s for n, s, c in
               zip((Bsz, nc, Q, heads), t.stride()[:4], inner)]
    return strides, heads


def _check_inputs(name, x, dt, A, Bc, Cc) -> int:
    """Raise unless x, dt, A, Bc and Cc fit the kernels (device, dtype,
    shapes, P, N, Q, the grid's B*nc, a contiguous A); returns x's
    storage type code."""
    dev = x.device
    code = cuda.check_float("x", x, None)
    cuda.check_float("dt", dt, dev, torch.float32)
    cuda.check_float("A", A, dev, torch.float32)
    cuda.check_float("Bc", Bc, dev, x.dtype)
    cuda.check_float("Cc", Cc, dev, x.dtype)
    if x.dim() != 5:
        raise ValueError(f"{name}: expected x [B, nc, Q, H, P], got "
                         f"shape {tuple(x.shape)}")
    Bsz, nc, Q, H, P = x.shape
    N = Bc.shape[-1] if Bc.dim() == 5 else -1
    if tuple(dt.shape) != (Bsz, nc, Q, H) or tuple(A.shape) != (H,) \
            or Bc.dim() != 5 or tuple(Bc.shape[:4]) != (Bsz, nc, Q, H) \
            or Cc.shape != Bc.shape:
        raise ValueError(f"{name}: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bc "
                         f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim P={P} not in {HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{name}: state dim N={N} outside "
                         f"[1, {MAX_STATE}]")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk length Q={Q} outside "
                         f"[1, {MAX_CHUNK}]")
    if Bsz * nc > MAX_GRID_Z:
        raise ValueError(f"{name}: B*nc={Bsz * nc} chunks, at most "
                         f"{MAX_GRID_Z} per call")
    if not A.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous")
    return code


def ssd_chunk(x, dt, A, Bc, Cc, *, out_dtype=None, path=None):
    """x: [B, nc, Q, H, P]; dt: [B, nc, Q, H] f32; A: [H] f32; Bc, Cc:
    [B, nc, Q, H, N] in x's dtype (f32 or bf16; a head stride of 0 is
    fine).  Returns (y [B, nc, Q, H, P] in ``out_dtype``, x's dtype or
    f32, by default x's; state [B, nc, H, N, P] f32; cum [B, nc, Q, H]
    f32), as ``ref.ssd_chunk_ref``.  Takes the kernel ``route(x.dtype, P,
    N)`` names, or ``path="simt"``, the CUDA-core kernels at any shape
    they take (to hold the two routes against each other on the card);
    allocates its outputs, launches on the current stream and does not
    synchronise.  Under ``launch.opanalysis`` it is charged its cost rule;
    on a fake its plain version gives the outputs."""
    if cost.current() is not None:
        cost.charge("ssd_chunk", cost.ssd_cost, *x.shape,
                    Bc.shape[-1], x.dtype, Bc.stride(3) == 0, out_dtype)
    if cost.is_fake(x):
        return cost.plain(ref.ssd_chunk_ref, x, dt, A, Bc, Cc,
                          out_dtype)
    code = _check_inputs("ssd_chunk", x, dt, A, Bc, Cc)
    dev = x.device
    Bsz, nc, Q, H, P = x.shape
    N = Bc.shape[-1]
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"ssd_chunk: y in {out_dtype}; the kernels give "
                        f"x's dtype ({x.dtype}) or float32")
    path = pick("ssd_chunk", x.dtype, P, N, path)
    views = [tma_view("x", x, False), tma_view("Bc", Bc),
             tma_view("Cc", Cc)] if path == "wgmma" else None
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, nc, Q, H, P), dtype=out_dtype, device=dev)
    state = torch.empty((Bsz, nc, H, N, P), **f32)
    cum = torch.empty((Bsz, nc, Q, H), **f32)
    if Bsz * nc * H:
        args = [x.data_ptr(), *(views[0][0] if views else x.stride()[:4]),
                dt.data_ptr(), *dt.stride()[:4], A.data_ptr()]
        for i, t in ((1, Bc), (2, Cc)):
            args += [t.data_ptr(), *(views[i][0] if views else t.stride()[:4])]
            if views:
                args.append(views[i][1])
        args += [y.data_ptr(), state.data_ptr(), cum.data_ptr(), Bsz, nc, Q,
                 H, P, N]
        if path == "wgmma":
            fn = cuda.function("ssd_chunk_wgmma", "halcone_ssd_chunk_wgmma",
                               _ARGS_WGMMA)
        else:
            fn = cuda.function("ssd_chunk", "halcone_ssd_chunk", _ARGS)
            args.append(code)
        cuda.launch(fn, args + [cuda.FLOAT_CODES[out_dtype]], dev)
        ssd_chunk.launches += 1
        ssd_chunk.route_launches[path] += 1
    return y, state, cum


ssd_chunk.launches = 0
ssd_chunk.route_launches = dict.fromkeys(ROUTES, 0)


def ssd_chunk_bwd(x, dt, A, Bc, Cc, cum, dy, dstate, dcum, *, path=None):
    """The gradient of ``ssd_chunk``: x, dt, A, Bc, Cc as the forward took
    them (a head stride of 0 is fine), its cum [B, nc, Q, H] f32, and the
    cotangents dy [B, nc, Q, H, P] (f32 or x's dtype), dstate [B, nc, H,
    N, P] f32 and dcum [B, nc, Q, H] f32.  Returns (dx, ddt, dA, dBc,
    dCc) as ``ref.ssd_chunk_bwd_ref``: dx, dBc and dCc in x's dtype, of
    the inputs' shapes and contiguous (per head: a caller that broadcast
    B or C to the heads sums them, as expand's backward does), ddt and dA
    in f32.  Takes the forward's route, ``route(x.dtype, P, N)``, or
    ``path="simt"``, the CUDA-core kernel at any shape it takes (to hold
    the two routes against each other on the card); launches on the
    current stream and does not synchronise.  Under ``launch.opanalysis``
    it is charged its cost rule; on a fake its plain version gives the
    gradients."""
    if cost.current() is not None:
        cost.charge("ssd_chunk_bwd", cost.ssd_bwd_cost, *x.shape,
                    Bc.shape[-1], x.dtype, Bc.stride(3) == 0)
    if cost.is_fake(x):
        return cost.plain(ref.ssd_chunk_bwd_ref, x, dt, A, Bc, Cc, dy,
                          dstate, dcum, dy.dtype)
    code = _check_inputs("ssd_chunk_bwd", x, dt, A, Bc, Cc)
    dev = x.device
    Bsz, nc, Q, H, P = x.shape
    N = Bc.shape[-1]
    cuda.check_float("dy", dy, dev)
    for name, t, shape in (("dy", dy, (Bsz, nc, Q, H, P)),
                           ("dstate", dstate, (Bsz, nc, H, N, P)),
                           ("dcum", dcum, (Bsz, nc, Q, H)),
                           ("cum", cum, (Bsz, nc, Q, H))):
        if name != "dy":
            cuda.check_float(name, t, dev, torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if dy.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"ssd_chunk_bwd: dy in {dy.dtype}; y comes in "
                        f"x's dtype ({x.dtype}) or float32")
    path = pick("ssd_chunk_bwd", x.dtype, P, N, path)
    views = [tma_view("x", x, False), tma_view("Bc", Bc),
             tma_view("Cc", Cc)] if path == "wgmma" else None
    dy, dstate, dcum, cum = (t.float().contiguous()
                             for t in (dy, dstate, dcum, cum))
    if views:
        # the tensor-core kernels read rows of dy and dstate 16 bytes at a
        # time
        for name, t in (("dy", dy), ("dstate", dstate)):
            cuda.check_rows_16b(f"ssd_chunk_bwd (tensor-core route): {name}",
                                t)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bsz, nc, Q, H, P), dtype=x.dtype, device=dev)
    dBc, dCc = (torch.empty((Bsz, nc, Q, H, N), dtype=x.dtype, device=dev)
                for _ in range(2))
    ddt = torch.empty((Bsz, nc, Q, H), **f32)
    dA = torch.zeros((H,), **f32)
    if Bsz * nc * H:
        scratch = torch.empty(3 * Bsz * nc * Q * H + Bsz * nc * H, **f32)
        if views:
            dyhl = dy_halves(dy)
            args = [x.data_ptr(), *views[0][0], dt.data_ptr(),
                    *dt.stride()[:4], A.data_ptr()]
            for i, t in ((1, Bc), (2, Cc)):
                args += [t.data_ptr(), *views[i][0], views[i][1]]
            args += [t.data_ptr() for t in (dy, dstate, dcum, cum, dyhl, dx,
                                            dBc, dCc, ddt, dA, scratch)]
            args += [Bsz, nc, Q, H, P, N]
            fn = cuda.function("ssd_chunk_bwd_wgmma",
                               "halcone_ssd_chunk_bwd_wgmma", _ARGS_BWD_WGMMA)
        else:
            args = [x.data_ptr(), *x.stride()[:4], dt.data_ptr(),
                    *dt.stride()[:4], A.data_ptr(), Bc.data_ptr(),
                    *Bc.stride()[:4], Cc.data_ptr(), *Cc.stride()[:4]]
            args += [t.data_ptr() for t in (dy, dstate, dcum, cum, dx, dBc,
                                            dCc, ddt, dA, scratch)]
            args += [Bsz, nc, Q, H, P, N, code]
            fn = cuda.function("ssd_chunk_bwd", "halcone_ssd_chunk_bwd",
                               _ARGS_BWD)
        cuda.launch(fn, args, dev)
        ssd_chunk_bwd.launches += 1
        ssd_chunk_bwd.route_launches[path] += 1
    return dx, ddt, dA, dBc, dCc


def dy_halves(dy):
    """The scratch of the tensor-core backward's dy: its bf16 hi and lo
    halves, [2, B, nc, Q, H, P], written by the query pass and read by the
    key pass through TMA maps that take them as contiguous tensors (H
    heads)."""
    return torch.empty((2,) + tuple(dy.shape), dtype=torch.bfloat16,
                       device=dy.device)


ssd_chunk_bwd.launches = 0
ssd_chunk_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class SSDChunkFn(torch.autograd.Function):
    """``ssd_chunk`` with ``ssd_chunk_bwd`` as its gradient, both kernels
    on the route ``route`` picks: the forward saves its inputs (B and C
    as the views it was given) and its cum; a recomputed forward
    (``torch.utils.checkpoint``) saves its own.  Inputs that need no
    gradient get None."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, out_dtype):
        y, state, cum = ssd_chunk(x, dt, A, Bc, Cc, out_dtype=out_dtype)
        ctx.save_for_backward(x, dt, A, Bc, Cc, cum)
        return y, state, cum

    @staticmethod
    def backward(ctx, dy, dstate, dcum):
        grads = ssd_chunk_bwd(*ctx.saved_tensors, dy, dstate, dcum)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)
