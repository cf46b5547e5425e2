"""HALCONE fused miss/write round kernels on the H100.

``miss_round`` and ``write_grant`` (``csrc/tier_pass.cu``) replace the
Pallas kernels ``repro/kernels/tier_pass.py::_miss_round_kernel`` and
``::_write_grant_kernel``; their plain versions are
``kernels.ref.miss_round_ref`` and ``kernels.ref.write_grant_ref``.
Both take the tiers' tables themselves, read in place: ``[K, W]`` or
``[K, C]`` with a row stride (a tier's sets, or the TSU shards' set 0,
with the trash way sliced off), and each lane's row by index
(``miss_round``'s ``rows = (s1, s2, shard)``, ``write_grant``'s ``row``),
so no lane's row is copied and each distinct TSU row is read once, by
one block.  Without the indexes they take the reference's gathered form
(lane i reads row i of each table).  These wrappers launch on CUDA
tensors only and raise on anything else; ``kernels.ops`` is the
dispatcher that sends CPU tensors to the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda

_MISS_ARGS = [cuda.P, cuda.LD] * 7 + [cuda.P] * 3 + [cuda.I] * 3 \
    + [cuda.P, cuda.I] * 2 + [cuda.P, cuda.P, cuda.I, cuda.P, cuda.I] \
    + [cuda.P] * 16 + [cuda.I] * 4 + [cuda.P]
_WRITE_ARGS = [cuda.P, cuda.LD] * 3 + [cuda.P] * 10 + [cuda.I] * 3 + [cuda.P]

# output kinds, in the reference's order (True = bool)
_MISS_BOOL = (True, True, False, True, True, False, True, False, False,
              False, False, True, False, False, False, False)
_WRITE_BOOL = (True, False, True, False, False, False, True)


def _outs(kinds, N, dev):
    return [torch.empty((N,), dtype=torch.bool if b else torch.int32,
                        device=dev) for b in kinds]


def miss_round(rp_tag, rp_rts, sh_tag, sh_rts, sh_wts, ts_tag, ts_mem,
               cts1, cts2, addr, act, rd, *, rows=None):
    """Fused read-side round math over the tiers' tables, on the card.

    rp_tag/rp_rts: [K1, W1]; sh_tag/sh_rts/sh_wts: [K2, W2]; ts_tag/ts_mem:
    [KT, C] — int32 tables with contiguous ways and any row stride;
    rows: (s1, s2, shard), the [N] int32 rows of each lane in them (the
    kernel traps on one outside its table), or None for lane i on row i
    of each (every K == N).  cts1/cts2: [N] or [1] (one clock for every
    lane); addr: [N] int32; act: [N] bool or int32; rd: [N] int32 or an
    int.  Returns the 16 [N] round intermediates of
    ``repro/kernels/tier_pass.py::miss_round`` on the rows named (th1,
    h1, th2, h2, fnd and ovf as bool)."""
    dev = addr.device
    N = addr.shape[0] if addr.dim() == 1 else -1
    cuda.check_vec("addr", addr, N, dev)
    r1, r2, rt = (None, None, None) if rows is None else rows
    K1, W1, l1 = cuda.check_table((("rp_tag", rp_tag), ("rp_rts", rp_rts)),
                                  r1, N, dev)
    K2, W2, l2 = cuda.check_table((("sh_tag", sh_tag), ("sh_rts", sh_rts),
                                   ("sh_wts", sh_wts)), r2, N, dev)
    KT, C, lt = cuda.check_table((("ts_tag", ts_tag), ("ts_mem", ts_mem)),
                                 rt, N, dev)
    st1 = cuda.check_lane_or_one("cts1", cts1, N, dev)
    st2 = cuda.check_lane_or_one("cts2", cts2, N, dev)
    act_bool = isinstance(act, torch.Tensor) and act.dtype == torch.bool
    if act_bool:
        cuda.check_flags("act", act, N, dev)
    else:
        cuda.check_vec("act", act, N, dev)
    if isinstance(rd, torch.Tensor):
        cuda.check_vec("rd", rd, N, dev)
        rd_ptr, rd_value = rd.data_ptr(), 0
    else:
        rd_ptr, rd_value = None, cuda.int32_value("rd", rd)
    outs = _outs(_MISS_BOOL, N, dev)
    if N:
        ptr = lambda t: None if t is None else t.data_ptr()
        args = []
        for t, ld in zip((rp_tag, rp_rts, sh_tag, sh_rts, sh_wts, ts_tag,
                          ts_mem), (*l1, *l2, *lt)):
            args += [t.data_ptr(), ld]
        args += [ptr(r1), ptr(r2), ptr(rt), K1, K2, KT, cts1.data_ptr(), st1,
                 cts2.data_ptr(), st2, addr.data_ptr(), act.data_ptr(),
                 int(act_bool), rd_ptr, rd_value]
        args += [t.data_ptr() for t in outs] + [N, W1, W2, C]
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
