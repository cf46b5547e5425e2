"""Fused RMSNorm on the H100: one read and one write of each row.

The CUDA kernel (``csrc/rmsnorm.cu``) replaces the Pallas kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``; its plain version is
``kernels.ref.rmsnorm_ref``.  This wrapper launches on CUDA tensors only
and raises on anything else; ``kernels.ops.rmsnorm`` is the dispatcher
that sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_ARGS = [cuda.P, cuda.P, cuda.P, cuda.I, cuda.I, cuda.F, cuda.I, cuda.I,
         cuda.P]


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
        vec = (D % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        fn = cuda.function("rmsnorm", "halcone_rmsnorm", _ARGS)
        cuda.launch(fn, [x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D,
                         float(eps), int(vec), dt], dev)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
