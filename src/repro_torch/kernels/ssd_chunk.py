"""The Mamba2 SSD intra-chunk step on the H100.

The CUDA kernels (``csrc/ssd_chunk.cu``: an output pass and a state pass)
replace the Pallas kernel ``repro/kernels/ssd_chunk.py::_ssd_kernel``;
the plain version is ``kernels.ref.ssd_chunk_ref``.  x, B and C are read
with their strides, so the model passes a group's B/C broadcast to its
heads as a stride-0 view and never builds the per-head copy.  This
wrapper launches on CUDA tensors only and raises on anything else;
``kernels.ops.ssd_chunk`` is the dispatcher that sends CPU tensors to the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

HEAD_DIMS = (16, 32, 64, 128)   # P: csrc/ssd_chunk.cu's instantiations
MAX_STATE = 256                 # N: two [64, N+1] f32 tiles in shared memory
MAX_CHUNK = 1024                # Q: cum and dt of a chunk in shared memory
MAX_GRID_Z = 65535              # one grid z per (batch, chunk)
_ARGS = ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] \
    + ([cuda.P] + [cuda.LD] * 4) * 2 + [cuda.P] * 3 + [cuda.I] * 7 \
    + [cuda.P]


def ssd_chunk(x, dt, A, Bc, Cc):
    """x: [B, nc, Q, H, P]; dt: [B, nc, Q, H] f32; A: [H] f32; Bc, Cc:
    [B, nc, Q, H, N] in x's dtype (f32 or bf16; a head stride of 0 is
    fine).  Returns (y [B, nc, Q, H, P] in x's dtype, state [B, nc, H, N,
    P] f32, cum [B, nc, Q, H] f32), as ``ref.ssd_chunk_ref``.  Allocates
    its outputs, launches on the current stream and does not
    synchronise."""
    dev = x.device
    code = cuda.check_float("x", x, None)
    cuda.check_float("dt", dt, dev, torch.float32)
    cuda.check_float("A", A, dev, torch.float32)
    cuda.check_float("Bc", Bc, dev, x.dtype)
    cuda.check_float("Cc", Cc, dev, x.dtype)
    if x.dim() != 5:
        raise ValueError(f"ssd_chunk: expected x [B, nc, Q, H, P], got "
                         f"shape {tuple(x.shape)}")
    Bsz, nc, Q, H, P = x.shape
    N = Bc.shape[-1] if Bc.dim() == 5 else -1
    if tuple(dt.shape) != (Bsz, nc, Q, H) or tuple(A.shape) != (H,) \
            or Bc.dim() != 5 or tuple(Bc.shape[:4]) != (Bsz, nc, Q, H) \
            or Cc.shape != Bc.shape:
        raise ValueError(f"ssd_chunk: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bc "
                         f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk: head dim P={P} not in {HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_chunk: state dim N={N} outside "
                         f"[1, {MAX_STATE}]")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk: chunk length Q={Q} outside "
                         f"[1, {MAX_CHUNK}]")
    if Bsz * nc > MAX_GRID_Z:
        raise ValueError(f"ssd_chunk: B*nc={Bsz * nc} chunks, at most "
                         f"{MAX_GRID_Z} per call")
    if not A.is_contiguous():
        raise ValueError("ssd_chunk: A must be contiguous")
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, nc, Q, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((Bsz, nc, H, N, P), **f32)
    cum = torch.empty((Bsz, nc, Q, H), **f32)
    if Bsz * nc * H:
        fn = cuda.function("ssd_chunk", "halcone_ssd_chunk", _ARGS)
        args = []
        for t in (x, dt):
            args += [t.data_ptr(), *t.stride()[:4]]
        args.append(A.data_ptr())
        for t in (Bc, Cc):
            args += [t.data_ptr(), *t.stride()[:4]]
        cuda.launch(fn, args + [y.data_ptr(), state.data_ptr(),
                                cum.data_ptr(), Bsz, nc, Q, H, P, N, code],
                    dev)
        ssd_chunk.launches += 1
    return y, state, cum


ssd_chunk.launches = 0
