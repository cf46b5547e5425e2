"""Fused RMSNorm on the H100: one read and one write of each row, and
its gradient.

The CUDA kernel (``csrc/rmsnorm.cu``) replaces the Pallas kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``; its plain version is
``kernels.ref.rmsnorm_ref``.  ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``)
is its backward, whose plain version is autograd of the plain forward
(``kernels.ref.rmsnorm_bwd_ref``); ``RMSNormFn`` joins the two for
autograd.  These wrappers launch on CUDA tensors only and raise on
anything else; ``kernels.ops.rmsnorm`` is the dispatcher that sends CPU
tensors to the plain version.  ``plan`` picks the forward kernel's shape
for a call on the host.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cuda

_ARGS = [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.F, cuda.I, cuda.I,
         cuda.I, cuda.I, cuda.P]
BLOCK = 256                  # threads of a many-rows block
TPRS = (32, 128, 256)        # threads per row the kernel is built for
VPTS = (1, 2, 4)             # 16-byte vectors per thread
ELEMENT_PATH = (0, 32, BLOCK // 32)


def _fit(n, options):
    return next(o for o in options if o >= n)


@functools.lru_cache(maxsize=None)
def plan(R: int, D: int, vec_len: int, n_sms: int):
    """``(vpt, tpr, rows)`` for ``R`` rows of ``D`` elements stored as
    ``vec_len`` elements per 16-byte vector, on a card of ``n_sms`` SMs:
    ``tpr`` threads hold a row in ``vpt`` vectors each and a block holds
    ``rows`` rows.  Many rows (a many-rows launch fills every SM): 256 /
    tpr rows a block, the smallest tpr that holds the row in at most four
    vectors a thread.  Few rows: one row a block of 128 threads (256 when
    the row is over 128 vectors; 32 when it is at most 32), one or two
    vectors a thread.  ``ELEMENT_PATH`` (vpt 0) when D does not fill whole
    vectors or the row is over 1024 vectors."""
    nvec = D // vec_len
    if D % vec_len or not 0 < nvec <= VPTS[-1] * TPRS[-1]:
        return ELEMENT_PATH
    tpr = _fit(-(-nvec // VPTS[-1]), TPRS)
    rows = BLOCK // tpr
    if -(-R // rows) < n_sms:                      # few rows
        tpr, rows = (32 if nvec <= 32 else 128 if nvec <= 128 else 256), 1
    return _fit(-(-nvec // tpr), VPTS), tpr, rows


@functools.lru_cache(maxsize=None)
def _n_sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm(x, w, *, eps=1e-6):
    """x: [..., D] contiguous, f32 or bf16; w: [D] f32.  Returns
    ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` computed in f32, in x's dtype
    and shape.  Allocates its output, launches on the current stream and
    does not synchronise."""
    dev = x.device
    dt = cuda.check_float("x", x, None)
    cuda.check_float("w", w, dev, torch.float32)
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous [..., D] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w: expected shape ({D},), got {tuple(w.shape)}")
    R = x.numel() // D if D else 0
    out = torch.empty_like(x)
    if R:
        vpt, tpr, rows = ELEMENT_PATH
        if (x.data_ptr() | out.data_ptr() | w.data_ptr()) % 16 == 0:
            vpt, tpr, rows = plan(R, D, 16 // x.element_size(),
                                  _n_sms(dev.index))
        fn = cuda.function("rmsnorm", "halcone_rmsnorm", _ARGS)
        cuda.launch(fn, [x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D,
                         float(eps), vpt, tpr, rows, dt], dev)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


_ARGS_BWD = [cuda.P] * 6 + [cuda.I, cuda.I, cuda.F] + [cuda.I] * 5 + [cuda.P]
BWD_BLOCK_ROWS = 8           # the element path: one warp a row, 8 a block
BWD_MAX_D = 6400             # the element path: (1 + 8) rows of D f32 in
                             # shared memory


def rmsnorm_bwd_plan(R: int, D: int, vec_len: int, n_sms: int,
                     aligned: bool = True):
    """``(vpt, tpr, slots, G)`` of ``rmsnorm_bwd``'s first launch: the
    forward's ``plan`` for the row layout (``tpr`` threads hold a row in
    ``vpt`` vectors each, ``slots`` rows a block), and ``G`` blocks that
    walk the groups of ``slots`` rows in a grid-stride loop: one a group
    up to one an SM, then enough that each walks about four groups, at
    most four an SM (each block adds a partial row that dw's second
    launch sums; at R = 4096, D = 960 this measured fastest, 132 blocks
    in bf16 and 512 in f32: ``scripts/rmsnorm_bwd_blocks.py``).  The
    element path (``vpt`` 0, ``BWD_BLOCK_ROWS`` rows a block) where the
    forward's plan takes it or the pointers are not all ``aligned`` on
    16 bytes."""
    vpt, tpr, slots = plan(R, D, vec_len, n_sms) if aligned else ELEMENT_PATH
    if not vpt:
        slots = BWD_BLOCK_ROWS
    groups = -(-R // slots)
    G = min(max(min(groups, n_sms), -(-groups // 4)), 4 * n_sms)
    return vpt, tpr, slots, G


def rmsnorm_bwd(x, w, dy, *, eps=1e-6):
    """The gradient of ``rmsnorm(x, w, eps=eps)``: x and dy [..., D]
    contiguous, of one dtype (f32 or bf16); w [D] f32.  Returns (dx in
    x's dtype and shape, dw [D] f32).  The rows are held in registers in
    the forward's layout (``rmsnorm_bwd_plan``; the element path when D
    does not fill whole vectors or a pointer is off 16 bytes), and dw sums
    over the rows in a fixed order (per-block partial rows, then a second
    launch), so it is the same from run to run.  Allocates its outputs and
    an f32 scratch of ``G x D`` partial rows, launches on the current
    stream and does not synchronise."""
    dev = x.device
    dt = cuda.check_float("x", x, None)
    cuda.check_float("dy", dy, dev, x.dtype)
    cuda.check_float("w", w, dev, torch.float32)
    for name, t in (("x", x), ("dy", dy)):
        if t.dim() < 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous [..., D] "
                             f"tensor, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if dy.shape != x.shape:
        raise ValueError(f"dy: shape {tuple(dy.shape)}, x has "
                         f"{tuple(x.shape)}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w: expected shape ({D},), got {tuple(w.shape)}")
    if not 1 <= D <= BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: D={D} outside [1, {BWD_MAX_D}]")
    R = x.numel() // D
    dx = torch.empty_like(x)
    if not R:
        return dx, torch.zeros(D, dtype=torch.float32, device=dev)
    dw = torch.empty(D, dtype=torch.float32, device=dev)
    aligned = (x.data_ptr() | dy.data_ptr() | dx.data_ptr()
               | w.data_ptr()) % 16 == 0
    vpt, tpr, slots, G = rmsnorm_bwd_plan(R, D, 16 // x.element_size(),
                                          _n_sms(dev.index), aligned)
    part = torch.empty((G, D), dtype=torch.float32, device=dev)
    fn = cuda.function("rmsnorm_bwd", "halcone_rmsnorm_bwd", _ARGS_BWD)
    cuda.launch(fn, [x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), dw.data_ptr(), part.data_ptr(), R, D,
                     float(eps), G, vpt, tpr, slots, dt], dev)
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm`` with ``rmsnorm_bwd`` as its gradient, both kernels."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None
