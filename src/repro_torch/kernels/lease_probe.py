"""HALCONE lease-probe kernel on the H100: tag compare + lease check +
Algorithm 1/2 install math, batched over request lanes.

The CUDA kernel (``csrc/lease_probe.cu``) replaces the Pallas kernel
``repro/kernels/lease_probe.py::_probe_kernel``; its plain version is
``kernels.ref.lease_probe_ref``.  With ``row`` it reads a tier's tables in
place (``[K, W]`` with a row stride, e.g. ``tier.tag[rep][:, :-1]``) and
each lane's set from ``row``, so the caller gathers nothing; without it,
lane i reads row i (the reference's gathered form).  This wrapper
launches on CUDA tensors only and raises on anything else;
``kernels.ops.lease_probe`` is the dispatcher that sends CPU tensors to
the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_ARGS = [cuda.P, cuda.LD, cuda.P, cuda.LD, cuda.P, cuda.I, cuda.P, cuda.I] \
    + [cuda.P] * 10 + [cuda.I, cuda.I, cuda.P]


def lease_probe(tag, rts, cts, addr, mwts=None, mrts=None, *, row=None):
    """Fused probe + install over a tier's set rows, on the card.

    tag/rts: [K, W] int32 tables (ways contiguous, any row stride); row:
    [N] int32 set of each lane, each in [0, K) (the kernel traps
    otherwise), or None for lane i on row i (K == N); cts: [N] or [1] (one
    clock for every lane); addr: [N]; mwts/mrts: [N], or None for 0.
    Returns (tag_hit, hit, way, row_rts, new_wts, new_rts, new_cts): two
    bool and five int32 [N] tensors, the contract of
    ``repro/kernels/lease_probe.py`` on the rows ``tag[row]``.  Allocates
    its outputs, launches on the current stream and does not
    synchronise."""
    dev = addr.device
    N = addr.shape[0] if addr.dim() == 1 else -1
    cuda.check_vec("addr", addr, N, dev)
    K, W, lds = cuda.check_table((("tag", tag), ("rts", rts)), row, N, dev)
    cts_step = cuda.check_lane_or_one("cts", cts, N, dev)
    for name, v in (("mwts", mwts), ("mrts", mrts)):
        if v is not None:
            cuda.check_vec(name, v, N, dev)
    flags = [torch.empty((N,), dtype=torch.bool, device=dev)
             for _ in range(2)]
    ints = [torch.empty((N,), dtype=torch.int32, device=dev)
            for _ in range(5)]
    if N:
        ptr = lambda t: None if t is None else t.data_ptr()
        fn = cuda.function("lease_probe", "halcone_lease_probe", _ARGS)
        cuda.launch(fn, [tag.data_ptr(), lds[0], rts.data_ptr(), lds[1],
                         ptr(row), K, cts.data_ptr(), cts_step,
                         addr.data_ptr(), ptr(mwts), ptr(mrts)]
                    + [t.data_ptr() for t in (*flags, *ints)] + [N, W], dev)
        lease_probe.launches += 1
    return (*flags, *ints)


lease_probe.launches = 0
