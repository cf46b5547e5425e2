"""HALCONE lease-probe kernel on the H100: tag compare + lease check +
Algorithm 1/2 install math, batched over request lanes.

The CUDA kernel (``csrc/lease_probe.cu``) replaces the Pallas kernel
``repro/kernels/lease_probe.py::_probe_kernel``; its plain version is
``kernels.ref.lease_probe_ref``.  This wrapper launches on CUDA tensors
only and raises on anything else; ``kernels.ops.lease_probe`` is the
dispatcher that sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_ARGS = [cuda.P, cuda.LD, cuda.P, cuda.LD] + [cuda.P] * 11 \
    + [cuda.I, cuda.I, cuda.P]


def lease_probe(tag_rows, rts_rows, cts, addr, mwts, mrts):
    """Fused probe + install over gathered set rows, on the card.

    tag_rows/rts_rows: [N, W] int32 (ways contiguous, rows may be strided);
    cts/addr/mwts/mrts: [N] int32.  Returns (tag_hit, hit, way, row_rts,
    new_wts, new_rts, new_cts): two bool and five int32 [N] tensors, the
    contract of ``repro/kernels/lease_probe.py``.  Allocates its outputs,
    launches on the current stream and does not synchronise."""
    dev = tag_rows.device
    N = tag_rows.shape[0] if tag_rows.dim() == 2 else -1
    tag_ld = cuda.check_rows("tag_rows", tag_rows, N, dev)
    rts_ld = cuda.check_rows("rts_rows", rts_rows, N, dev)
    W = tag_rows.shape[1]
    if rts_rows.shape[1] != W:
        raise ValueError(f"rts_rows has {rts_rows.shape[1]} ways, tag_rows "
                         f"{W}")
    for name, v in (("cts", cts), ("addr", addr), ("mwts", mwts),
                    ("mrts", mrts)):
        cuda.check_vec(name, v, N, dev)
    flags = [torch.empty((N,), dtype=torch.bool, device=dev)
             for _ in range(2)]
    ints = [torch.empty((N,), dtype=torch.int32, device=dev)
            for _ in range(5)]
    if N:
        fn = cuda.function("lease_probe", "halcone_lease_probe", _ARGS)
        cuda.launch(fn, [tag_rows.data_ptr(), tag_ld, rts_rows.data_ptr(),
                         rts_ld] + [t.data_ptr() for t in
                                    (cts, addr, mwts, mrts, *flags, *ints)]
                    + [N, W], dev)
        lease_probe.launches += 1
    return (*flags, *ints)


lease_probe.launches = 0
