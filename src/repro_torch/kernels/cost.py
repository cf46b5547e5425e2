"""What each hand-written kernel costs, and how a running analysis is
told of it.

Each kernel's cost rule gives the FLOPs by dtype and the least bytes the
kernel must move (each input read once, each output written once): from
the shapes alone for the float kernels, from the given tables and lanes
for the coherence kernels, whose work depends on the data.  There is one
formula a kernel, whatever route (tensor cores, CUDA cores or the plain
version) carries it; ``launch.roofline`` and ``chip_smoke.py``'s bounds
read the same rules.

The hooks ``charge``, ``plain`` and ``mark`` are how the kernels'
wrappers and the train step speak to the active
``launch.opanalysis.Analysis``; with none active they cost a lookup.
The analysis is found on torch's dispatch-mode stack, which is a
thread's own and which autograd carries to the threads that run a
backward: a kernel called on any other thread is never charged to it.
A fake here is a meta tensor: it has shapes and no data, and a kernel
never launches on one.

The rates are the NVIDIA H100 SXM data sheet's, for the card the port
runs on (``nvidia-smi``: NVIDIA H100 80GB HBM3, power limit 700 W).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# NVIDIA H100 80GB HBM3 (SXM), 700 W: data sheet peaks
BF16_FLOPS_PER_S = 989e12      # dense bf16 on the tensor cores
F32_FLOPS_PER_S = 67e12        # f32 on the CUDA cores (the port's products
                               # run with TF32 off)
HBM_BYTES_PER_S = 3.35e12      # HBM3
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, one direction of one GPU
# the peak rate of each dtype's operations; int32 compares and selects run
# on the CUDA cores, at the f32 rate (generous, so a bound never
# overstates the least time)
PEAK_FLOPS = {"bf16": BF16_FLOPS_PER_S, "f16": BF16_FLOPS_PER_S,
              "f32": F32_FLOPS_PER_S, "int32": F32_FLOPS_PER_S,
              "f64": F32_FLOPS_PER_S / 2}

_KEYS = {torch.bfloat16: "bf16", torch.float16: "f16",
         torch.float32: "f32", torch.float64: "f64", torch.int32: "int32"}


def dtype_key(dtype) -> str:
    """The name a dtype's FLOPs are counted under ("bf16", "f32", ...)."""
    return _KEYS.get(dtype, str(dtype).split(".")[-1])


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """``sum flops_dt / peak_dt``; a dtype with no peak here raises."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items() if f)


# ------------------------------------------------------- analysis hooks
def current():
    """The innermost active analysis, or None: a dispatch mode on torch's
    mode stack that charges kernels (``launch.opanalysis.Analysis``)."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "charges_kernels", False):
            return mode
    return None


def is_fake(t) -> bool:
    """A tensor with shapes but no data (the dry run's meta tensors)."""
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def charge(name: str, rule, *args, **kw) -> None:
    """Charge kernel ``name`` the cost ``rule(*args, **kw)`` (a
    ``KernelCost``) in the active analysis; nothing (and the rule is not
    evaluated) when none is active."""
    an = current()
    if an is not None and not an.suspended:
        an.charge(name, rule(*args, **kw))


def plain(fn, *args, **kw):
    """``fn(*args, **kw)`` (a kernel's plain version) with none of its
    operators counted; its outputs are live storages from here on."""
    an = current()
    if an is None:
        return fn(*args, **kw)
    an.suspended += 1
    try:
        out = fn(*args, **kw)
    finally:
        an.suspended -= 1
    an.track(out)
    return out


def mark(part: str, tree) -> None:
    """Tag the storages of ``tree``'s tensors as ``part`` for the whole
    of their lives (nothing when no analysis is active)."""
    an = current()
    if an is not None:
        an.tag(part, tree)


# ------------------------------------------------------------ kernel rules
@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call's least work: FLOPs by dtype and bytes moved."""
    flops: Dict[str, float]
    nbytes: float

    def bound(self) -> Tuple[float, str]:
        """(seconds, "bytes" or "operations"): the larger of the bytes over
        the HBM rate and the operations over their peak rates."""
        bt = self.nbytes / HBM_BYTES_PER_S
        ot = compute_seconds(self.flops)
        return max(bt, ot), ("bytes" if bt >= ot else "operations")


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the causal mask and the window leave visible,
    queries and keys both counted from position 0."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def rmsnorm_cost(R: int, D: int, dtype) -> KernelCost:
    """x read and y written (R rows of D), the f32 weight read; 4 f32
    operations an element."""
    return KernelCost({"f32": 4 * R * D},
                      2 * R * D * dtype.itemsize + 4 * D)


def rmsnorm_bwd_cost(R: int, D: int, dtype) -> KernelCost:
    """x and dy read, dx written, w read and dw written (f32); 12 f32
    operations an element."""
    return KernelCost({"f32": 12 * R * D},
                      3 * R * D * dtype.itemsize + 8 * D)


def flash_cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               Dv: int, dtype, causal: bool, window: int = 0,
               stats: bool = False) -> KernelCost:
    """q, k, v read, o written (and with ``stats`` each row's m and 1 / l,
    f32); S = Q K^T over D and O = P V over Dv at each visible pair."""
    nbytes = (B * Sq * Hq * (D + Dv) + B * Sk * Hkv * (D + Dv)) \
        * dtype.itemsize
    nbytes += 8 * B * Hq * Sq if stats else 0
    pairs = visible_pairs(Sq, Sk, causal, window)
    return KernelCost({dtype_key(dtype): 2 * (D + Dv) * B * Hq * pairs},
                      nbytes)


def flash_bwd_cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                   Dv: int, dtype, causal: bool, window: int = 0,
                   stats: bool = False) -> KernelCost:
    """q, k, v, o, dO read and dq, dk, dv written (with ``stats`` the
    forward's m and 1 / l read); S, dQ and dK over D, dP and dV over Dv at
    each visible pair."""
    nbytes = (2 * B * Sq * Hq * (D + Dv) + 2 * B * Sk * Hkv * (D + Dv)) \
        * dtype.itemsize
    nbytes += 8 * B * Hq * Sq if stats else 0
    pairs = visible_pairs(Sq, Sk, causal, window)
    return KernelCost({dtype_key(dtype): (6 * D + 4 * Dv) * B * Hq * pairs},
                      nbytes)


def decode_cost(B: int, Hq: int, Hkv: int, D: int, Dv: int, kv_len: int,
                dtype) -> KernelCost:
    """One query token a row over the first ``kv_len`` cache rows: q read,
    o written, kv_len rows of k and v read; S over D and O over Dv."""
    nbytes = (B * Hq * (D + Dv) + B * kv_len * Hkv * (D + Dv)) \
        * dtype.itemsize
    return KernelCost({dtype_key(dtype): 2 * (D + Dv) * B * Hq * kv_len},
                      nbytes)


def ssd_split(dtype, P: int, N: int) -> bool:
    """Whether ``ssd_chunk`` does its y and state products on bf16 halves
    (the tensor-core route: bf16 with P and N in 64 or 128)."""
    return dtype == torch.bfloat16 and P in (64, 128) and N in (64, 128)


def ssd_cost(B: int, nc: int, Q: int, H: int, P: int, N: int, dtype,
             stride0: bool, out_dtype=None) -> KernelCost:
    """Bytes: x in its dtype, y in ``out_dtype`` (x's by default), B and C
    once a group when they are a stride-0 broadcast, dt, cum and the f32
    state; flops over the visible causal pairs, 2N for the score and 2P
    for y a pair, 2NP a row for the state, y's and the state's products
    counted twice where they run on bf16 halves (``ssd_split``)."""
    el = dtype.itemsize
    out_el = (dtype if out_dtype is None else out_dtype).itemsize
    bc = B * nc * Q * N * (1 if stride0 else H)
    nbytes = B * nc * Q * H * P * (el + out_el) + 2 * bc * el \
        + 2 * 4 * B * nc * Q * H + 4 * B * nc * H * N * P + 4 * H
    k = 2 if ssd_split(dtype, P, N) else 1
    flops = B * nc * H * (Q * (Q + 1) // 2 * (2 * N + k * 2 * P)
                          + k * 2 * Q * N * P)
    return KernelCost({dtype_key(dtype): flops}, nbytes)


def ssd_bwd_cost(B: int, nc: int, Q: int, H: int, P: int, N: int, dtype,
                 stride0: bool) -> KernelCost:
    """Bytes: x, B and C (once a group when they are a stride-0
    broadcast), dt, cum, dy, dstate and dcum read (the cotangents f32),
    dx, the per-head dB and dC, ddt and dA written; flops over the visible
    causal pairs (C.B and dy.x, 2N + 2P; dx, dB and dC, 2P + 4N) and 4NP a
    row for the state terms."""
    el = dtype.itemsize
    bc = B * nc * Q * N * (1 if stride0 else H)
    rows = B * nc * Q * H
    nbytes = (rows * P * el + 2 * bc * el + 3 * 4 * rows + 4 * rows * P
              + 4 * B * nc * H * N * P + 4 * H
              + rows * P * el + 2 * rows * N * el + 4 * rows + 4 * H)
    flops = B * nc * H * (Q * (Q + 1) // 2 * (6 * N + 4 * P)
                          + 4 * Q * N * P)
    return KernelCost({dtype_key(dtype): flops}, nbytes)


# ------------------------------------------- coherence kernels (int32)
def first_match(tags, addr):
    """Per lane: index of the first way of its row ``tags`` that holds its
    address, or -1."""
    eq = tags == addr[:, None]
    return np.where(eq.any(1), eq.argmax(1), -1)


def scanned_ways(tags, addr) -> Tuple[int, int]:
    """Ways read up to each lane's first match (all of them on a miss) in
    ``[N, W]`` rows, and the number of lanes that match."""
    f = first_match(tags, addr)
    return int((f + 1).sum() + (f < 0).sum() * tags.shape[1]), \
        int((f >= 0).sum())


def probe_cost(tags, addr, lane_words: int = 0) -> KernelCost:
    """``lease_probe`` in its indexed form: per lane its set's tags up to
    the first match, the rts of a hit, its address and row and the
    outputs (5 int32 + 2 bool), and the one clock (``lane_words`` more
    int32 a lane where each lane has its own clock and grant);
    operations, the compares and 8 a lane."""
    N = len(addr)
    scanned, hits = scanned_ways(tags, addr)
    return KernelCost({"int32": scanned + 8 * N},
                      4 * scanned + 4 * hits + (30 + 4 * lane_words) * N + 4)


def miss_cost(tables, rows, addr, indexed: bool) -> KernelCost:
    """``miss_round``.  Bytes: each distinct TSU row named once (its C
    tags), per lane its replica and shared set's tags up to the first
    match, the clocks of the matched ways, the memts of a TSU hit, its
    address, act and row indexes (indexed) or five int32 vectors
    (gathered), the two clocks once (indexed) and the 16 outputs (10
    int32 + 6 bool).  Operations: a compare a way of each distinct row,
    the compares of the set scans and 30 a lane."""
    rp_tag, sh_tag, ts_tag = tables[0], tables[2], tables[5]
    s1, s2, shard = rows
    N, C = len(addr), ts_tag.shape[2] - 1
    distinct = len(np.unique(shard)) if indexed else N
    nbytes, ops = 4 * C * distinct, C * distinct + 30 * N
    for tags, s, vals in ((rp_tag[1, :, :-1], s1, 1),
                          (sh_tag[1, :, :-1], s2, 2)):
        scanned, hits = scanned_ways(tags[s], addr)
        nbytes += 4 * scanned + 4 * vals * hits
        ops += scanned
    nbytes += 4 * scanned_ways(ts_tag[shard, 0, :-1], addr)[1]
    nbytes += (17 * N + 8) if indexed else 20 * N
    return KernelCost({"int32": ops}, nbytes + 46 * N)


def grant_cost(tables, row, addr, indexed: bool) -> KernelCost:
    """``write_grant``.  Bytes: each distinct row named once (its tags,
    the memts of its live ways and the seq of its ways tied at the
    minimum), then per lane addr, wl, the row index when ``indexed``, one
    memts on a hit and the outputs (4 int32 + 3 bool).  Operations: three
    per way of each distinct row, one compare per way a lane scans to its
    first match (all C on a miss) and ten per lane."""
    tag, mem, seq = (a[:, 0, :-1] for a in tables)
    C = tag.shape[1]
    nbytes, ops = 0, 0
    for r in np.unique(row):
        valid = tag[r] != -1
        p = np.where(valid, mem[r], -2 ** 30)
        nbytes += 4 * (C + int(valid.sum()) + int((p == p.min()).sum()))
        ops += 3 * C
    f = first_match(tag[row], addr)
    N = len(row)
    nbytes += (12 if indexed else 8) * N + 4 * int((f >= 0).sum()) + 19 * N
    ops += int((f + 1).sum() + (f < 0).sum() * C) + 10 * N
    return KernelCost({"int32": ops}, nbytes)
