"""Fused RMSNorm on the H100: one read and one write of each row.

The CUDA kernel (``csrc/rmsnorm.cu``) replaces the Pallas kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``; its plain version is
``kernels.ref.rmsnorm_ref``.  This wrapper launches on CUDA tensors only
and raises on anything else; ``kernels.ops.rmsnorm`` is the dispatcher
that sends CPU tensors to the plain version.  ``plan`` picks the
kernel's shape for a call on the host.
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
