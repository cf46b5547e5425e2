"""HALCONE's timestamp/lease rules as pure functions (Algorithms 1-5), on
int32 torch tensors.

The PyTorch counterpart of ``repro.core.protocol``: the same decision
surface, so every lease rule the port's state layer, plain kernel versions
and CUDA kernels apply is pinned to these lines.

Timestamp conventions (validated against the paper's Fig.5 walkthrough):
  MM read  of a block with TSU entry ``memts``:
      Mwts = memts,     Mrts = memts + RdLease,  memts' = Mrts
  MM write:
      Mwts = memts + 1, Mrts = memts + WrLease,  memts' = Mrts
  Cache install (read or write response with lease [wts_r, rts_r]):
      Bwts = max(cts, wts_r); Brts = max(Bwts + 1, rts_r)
  cts advances only on writes: cts' = max(cts, Bwts).
  Validity (hit): tag match AND cts <= rts.

Every rule takes int32 tensors (the array fabric, the engine) or Python
ints (the host-object oracle, ``coherence.fabric.tsu``/``cache``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TS_BITS = 16
TS_MAX = (1 << TS_BITS) - 1


class Lease(NamedTuple):
    wts: torch.Tensor
    rts: torch.Tensor


def mm_read(memts, rd_lease):
    """TSU action for a read request. Returns (lease, new_memts)."""
    wts = memts
    rts = memts + rd_lease
    return Lease(wts, rts), rts


def mm_write(memts, wr_lease):
    """TSU action for a write request. Returns (lease, new_memts)."""
    wts = memts + 1
    rts = memts + wr_lease
    return Lease(wts, rts), rts


def _maximum(a, b):
    """Elementwise max: ``torch.maximum`` on tensors, ``max`` on ints."""
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return max(a, b)


def install(cts, wts_resp, rts_resp):
    """Cache-block timestamp update on a fill/response (Algorithms 1,2,4,5)."""
    bwts = _maximum(cts, wts_resp)
    brts = _maximum(bwts + 1, rts_resp)
    return Lease(bwts, brts)


def cts_after_write(cts, bwts):
    return _maximum(cts, bwts)


def valid(cts, rts):
    """Lease validity: the block may be read while cts <= rts."""
    return cts <= rts


def overflow_reinit(ts):
    """16-bit overflow: re-initialize to 0 instead of flushing."""
    if not isinstance(ts, torch.Tensor):
        return 0 if ts > TS_MAX else ts
    return torch.where(ts > TS_MAX, torch.zeros_like(ts), ts)
