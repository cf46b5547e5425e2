"""HALCONE fused miss/write round kernels on the H100.

``miss_round`` and ``write_grant`` (``csrc/tier_pass.cu``) replace the
Pallas kernels ``repro/kernels/tier_pass.py::_miss_round_kernel`` and
``::_write_grant_kernel``; their plain versions are
``kernels.ref.miss_round_ref`` and ``kernels.ref.write_grant_ref``.
``miss_round`` keeps the reference's gathered-row signature: the caller
passes each lane's set rows (``[N, W]``) and the TSU shard's row
(``[N, C]``).  ``write_grant`` takes the TSU tables themselves (``[K, C]``
with a row stride: the shards' set 0 with the trash way sliced off) and
``row``, each lane's table row, so no lane's row is copied and each
distinct row is read once, by one block; without ``row`` it takes the
gathered form (lane i reads row i).  These wrappers launch on CUDA
tensors only and raise on anything else; ``kernels.ops`` is the
dispatcher that sends CPU tensors to the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_MISS_ARGS = [cuda.P, cuda.LD] * 7 + [cuda.P] * 21 + [cuda.I] * 4 + [cuda.P]
_WRITE_ARGS = [cuda.P, cuda.LD] * 3 + [cuda.P] * 10 + [cuda.I] * 3 + [cuda.P]

# output kinds, in the reference's order (True = bool)
_MISS_BOOL = (True, True, False, True, True, False, True, False, False,
              False, False, True, False, False, False, False)
_WRITE_BOOL = (True, False, True, False, False, False, True)


def _outs(kinds, N, dev):
    return [torch.empty((N,), dtype=torch.bool if b else torch.int32,
                        device=dev) for b in kinds]


def miss_round(rp_tag, rp_rts, sh_tag, sh_rts, sh_wts, ts_tag, ts_mem,
               cts1, cts2, addr, act, rd):
    """Fused read-side round math over gathered set rows, on the card.

    rp_tag/rp_rts: [N, W1]; sh_tag/sh_rts/sh_wts: [N, W2]; ts_tag/ts_mem:
    [N, C]; cts1/cts2/addr/act/rd: [N] — all int32.  Returns the 16 [N]
    round intermediates of ``repro/kernels/tier_pass.py::miss_round``
    (th1, h1, th2, h2, fnd and ovf as bool)."""
    dev = addr.device
    N = addr.shape[0] if addr.dim() == 1 else -1
    rows = (("rp_tag", rp_tag), ("rp_rts", rp_rts), ("sh_tag", sh_tag),
            ("sh_rts", sh_rts), ("sh_wts", sh_wts), ("ts_tag", ts_tag),
            ("ts_mem", ts_mem))
    lds = [cuda.check_rows(n, t, N, dev) for n, t in rows]
    W1, W2, C = rp_tag.shape[1], sh_tag.shape[1], ts_tag.shape[1]
    for (n, t), w in zip(rows, (W1, W1, W2, W2, W2, C, C)):
        if t.shape[1] != w:
            raise ValueError(f"{n}: expected {w} ways, got {t.shape[1]}")
    vecs = (cts1, cts2, addr, act, rd)
    for n, v in zip(("cts1", "cts2", "addr", "act", "rd"), vecs):
        cuda.check_vec(n, v, N, dev)
    outs = _outs(_MISS_BOOL, N, dev)
    if N:
        args = []
        for (_, t), ld in zip(rows, lds):
            args += [t.data_ptr(), ld]
        args += [t.data_ptr() for t in (*vecs, *outs)] + [N, W1, W2, C]
        cuda.launch(cuda.function("tier_pass", "halcone_miss_round",
                                  _MISS_ARGS), args, dev)
        miss_round.launches += 1
    return tuple(outs)


def write_grant(ts_tag, ts_mem, ts_seq, addr, wl, row=None):
    """Fused write-side TSU math, on the card: one block per table row,
    any number of ways C (a row past 16384 ways is walked in tiles).

    ts_tag/ts_mem/ts_seq: [K, C] tables with contiguous ways; addr/wl:
    [N]; row: [N] table row of each lane, each in [0, K) (the kernel traps
    otherwise), or None for lane i reading row i (K == N) — all int32.
    Returns (th, way, full, wts, rts, nmem, ovf) of each lane as in
    ``repro/kernels/tier_pass.py::write_grant`` on the rows
    ``ts_*[row]`` (th, full, ovf bool)."""
    dev = addr.device
    N = addr.shape[0] if addr.dim() == 1 else -1
    K, C, lds = cuda.check_table(
        (("ts_tag", ts_tag), ("ts_mem", ts_mem), ("ts_seq", ts_seq)), row,
        N, dev)
    cuda.check_vec("addr", addr, N, dev)
    cuda.check_vec("wl", wl, N, dev)
    outs = _outs(_WRITE_BOOL, N, dev)
    if N:
        args = []
        for t, ld in zip((ts_tag, ts_mem, ts_seq), lds):
            args += [t.data_ptr(), ld]
        args += [None if row is None else row.data_ptr()]
        args += [t.data_ptr() for t in (addr, wl, *outs)] + [N, K, C]
        cuda.launch(cuda.function("tier_pass", "halcone_write_grant",
                                  _WRITE_ARGS), args, dev)
        write_grant.launches += 1
    return tuple(outs)


miss_round.launches = 0
write_grant.launches = 0
