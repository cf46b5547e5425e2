"""Count one rank's work in a step by running the step: FLOPs by dtype,
HBM bytes, collective wire bytes and peak live bytes — the counterpart
of ``repro.launch.hloanalysis``, which reads them from compiled HLO.

The step runs under a ``TorchDispatchMode`` that sees every operator, on
the tensors it is given: fakes (meta tensors: ``params.abstract``,
``meta_like``; nothing is allocated and no kernel runs) or real ones.
Nothing is traced out of a loop: every iteration runs and is counted.

- FLOPs: 2·M·N·K for the matrix-product family (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot`` — what ``linear``, ``matmul``
  and ``einsum`` lower to — and convolution), by the operands' dtype.  As
  in the reference, no elementwise FLOPs are counted.
- HBM bytes: operand + result bytes of every operator that moves data (a
  stride-0 dim counted once).  Views, metadata operators and ``empty``
  count nothing; an in-place operator counts its reads and its write
  (``copy_`` and fills only the write and the source); a gather reads the
  rows it returns, not its whole table.
- Collectives: every ``c10d`` operator (``models/comm.py``'s
  ``all_gather_into_tensor``, ``all_reduce`` and ``all_to_all_single``)
  by kind and group size, its wire bytes by ``roofline._wire_bytes``.
- Each hand-written kernel is charged once, by its cost rule
  (``kernels.cost``), where its wrapper is entered (``cost.charge``); on
  a fake its plain version gives the outputs' shapes and none of its
  operators is counted (``cost.plain``).  A real CUDA tensor still
  launches the kernel.
- Peak live bytes: every storage from its allocation to the death of the
  last tensor on it (a weak reference; a tensor autograd saved lives
  as long as its graph), the given inputs live throughout.  The peak is
  split into params, grads, optimizer state and the rest: the inputs are
  tagged by the caller (``parts=``), the gradients by the step
  (``cost.mark("grads", ...)``), and each allocation keeps its tag for
  its whole life.

An analysis is active where its dispatch mode is: on the thread that
entered it, and on the threads autograd runs its backward on.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as kcost
from repro_torch.kernels.cost import dtype_key
from repro_torch.launch.roofline import _wire_bytes

aten = torch.ops.aten

PARTS = ("params", "grads", "optimizer", "other")

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default, aten.mv.default, aten.dot.default,
           aten.addmv.default, aten.addbmm.default}
# allocate without writing
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}
# read the rows they return (and their indices), not the whole table
_GATHER = {"index", "index_select", "embedding", "gather", "take"}
# write their destination without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}
_KIND = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "_allgather_base_": "all-gather", "allgather_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "broadcast_": "collective-broadcast"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_per_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_per_group: Dict[int, float] = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per kernel: calls, flops (all dtypes) and bytes charged by its rule
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    peak_parts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # each part's own largest live bytes over the step
    part_peaks: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    host_reads: int = 0
    result: Any = dataclasses.field(default=None, repr=False, compare=False)


def _stored_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans, a stride-0 dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(x, out=None) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (a namedtuple is a
    tuple), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Analysis(TorchDispatchMode):
    """The counting mode; use ``analyze`` or ``with Analysis(...) as an:``
    then ``an.cost``.  ``parts`` tags input trees (``{"params": tree,
    "optimizer": tree}``); every tensor of ``inputs`` is live throughout.
    A read of a fake's value on the host (``.item()``) raises unless
    ``host_reads`` is set, when it reads 0 and is counted."""

    charges_kernels = True              # ``kernels.cost.current`` finds it

    def __init__(self, inputs=(), parts=None, host_reads: bool = False):
        super().__init__()
        self.cost = Cost()
        self.suspended = 0              # > 0 inside a plain version
        self._host_reads = host_reads
        self._inputs = inputs
        self._parts = parts or {}
        # storage key -> [id, refs, bytes]
        self._live: Dict[int, list] = {}
        self._events: List[tuple] = []          # (id, +/- bytes)
        self._tags: Dict[int, str] = {}
        self._refs: dict = {}                   # weak references to outputs
        self._next_id = 0

    # -------------------------------------------------------- memory
    def _alloc(self, t: torch.Tensor, refs: int) -> Optional[list]:
        key = _key(t)
        entry = self._live.get(key)
        if entry is None:
            entry = [self._next_id, 0, t.untyped_storage().nbytes()]
            self._next_id += 1
            self._live[key] = entry
            self._events.append((entry[0], entry[2]))
        entry[1] += refs
        return entry

    def track(self, out, outs=None) -> None:
        """Hold every tensor of ``out`` live until it dies."""
        for t in (_tensors(out) if outs is None else outs):
            key = _key(t)
            entry = self._alloc(t, 1)
            ref = weakref.ref(t, lambda r, k=key, i=entry[0]:
                              self._release(r, k, i))
            self._refs[id(ref)] = ref

    def _release(self, ref, key: int, ident: int) -> None:
        self._refs.pop(id(ref), None)
        entry = self._live.get(key)
        if entry is None or entry[0] != ident:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self._events.append((ident, -entry[2]))

    def tag(self, part: str, tree) -> None:
        """Tag the live storages of ``tree``'s tensors as ``part``."""
        for t in _tensors(tree):
            entry = self._live.get(_key(t))
            if entry is not None:
                self._tags[entry[0]] = part

    def _peak(self) -> None:
        cur, by, peak = 0, dict.fromkeys(PARTS, 0), -1
        part_peaks = dict.fromkeys(PARTS, 0)
        at = dict(by)
        for ident, n in self._events:
            part = self._tags.get(ident, "other")
            cur += n
            by[part] += n
            part_peaks[part] = max(part_peaks[part], by[part])
            if cur > peak:
                peak, at = cur, dict(by)
        self.cost.peak_bytes = max(peak, 0)
        self.cost.peak_parts = at
        self.cost.part_peaks = part_peaks

    # ------------------------------------------------------- counting
    def charge(self, name: str, kc) -> None:
        """Count kernel ``name``'s ``kcost.KernelCost``."""
        c = self.cost
        for dt, f in kc.flops.items():
            c.flops_by_dtype[dt] = c.flops_by_dtype.get(dt, 0.0) + f
            c.flops += f
        c.hbm_bytes += kc.nbytes
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += sum(kc.flops.values())
        k["bytes"] += kc.nbytes

    def _flops(self, func, args, out) -> None:
        if func in _MATMUL:
            a = [t for t in args if isinstance(t, torch.Tensor)]
            if func in (aten.addmm.default, aten.baddbmm.default,
                        aten.addmv.default, aten.addbmm.default):
                a = a[1:]
            x, y = a[0], a[1]
            if func in (aten.mm.default, aten.addmm.default):
                f = 2 * x.shape[0] * x.shape[1] * y.shape[1]
            elif func in (aten.bmm.default, aten.baddbmm.default,
                          aten.addbmm.default):
                f = 2 * x.shape[0] * x.shape[1] * x.shape[2] * y.shape[2]
            else:                                   # mv, dot
                f = 2 * x.numel()
        elif func is aten.convolution.default:
            f = 2 * out.numel() * math.prod(args[1].shape[1:])
        elif func is aten.convolution_backward.default:
            f = 4 * args[0].numel() * math.prod(args[2].shape[1:])
        else:
            return
        dt = dtype_key(x.dtype if func in _MATMUL else args[0].dtype)
        c = self.cost
        c.flops_by_dtype[dt] = c.flops_by_dtype.get(dt, 0.0) + f
        c.flops += f

    def _collective(self, func, args, kwargs, op: str) -> None:
        kind = _KIND.get(op, "collective-permute")
        schema = func._schema.arguments
        group = None
        for i, a in enumerate(schema):
            if a.name == "process_group":
                group = args[i] if i < len(args) else kwargs.get(a.name)
        n = dist.ProcessGroup.unbox(group).size() if group is not None else 1
        ins = _tensors(args[1] if kind in ("all-gather", "all-to-all",
                                           "reduce-scatter") else args[0])
        if kind in ("all-gather", "all-to-all", "reduce-scatter"):
            res = _tensors(args[0])
        else:
            res = ins
        rb = sum(t.numel() * t.element_size() for t in res)
        wb = _wire_bytes(kind, rb, n)
        c = self.cost
        c.wire_bytes += wb
        c.coll_per_kind[kind] = c.coll_per_kind.get(kind, 0.0) + wb
        c.coll_per_group[n] = c.coll_per_group.get(n, 0.0) + wb
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        c.n_collectives += 1
        c.hbm_bytes += rb + sum(t.numel() * t.element_size() for t in ins)

    def _bytes(self, func, op: str, ins, outs) -> None:
        if op in _EMPTY:
            return
        if not func._schema.is_mutable and outs:
            keys = {_key(t) for t in ins}
            if all(_key(t) in keys for t in outs):
                return                              # a view
        if op in _GATHER:
            idx = sum(_stored_bytes(t) for t in ins
                      if not t.is_floating_point())
            self.cost.hbm_bytes += idx + 2 * sum(_stored_bytes(t)
                                                 for t in outs)
            return
        if op in _WRITE_ONLY:
            self.cost.hbm_bytes += sum(_stored_bytes(t) for t in ins)
            return
        self.cost.hbm_bytes += sum(_stored_bytes(t) for t in ins) \
            + sum(_stored_bytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten._local_scalar_dense.default \
                and kcost.is_fake(args[0]):
            if not self._host_reads:
                raise RuntimeError(
                    "a host read of a tensor's value (.item(), float(), "
                    "int()) inside the analysed step: a value that sets "
                    "work must come from the config, not from data")
            self.cost.host_reads += 1
            return 0.0 if args[0].dtype.is_floating_point else 0
        out = func(*args, **kwargs)
        if self.suspended or func.namespace == "prim":
            return out
        op = func._opname
        self.cost.n_ops += 1
        outs = _tensors(out)
        if func.namespace == "c10d":
            self._collective(func, args, kwargs, op)
        else:
            self._flops(func, args, out)
            self._bytes(func, op, _tensors(kwargs, _tensors(args)), outs)
        self.track(out, outs)
        return out

    # ------------------------------------------------------- context
    def __enter__(self):
        for t in _tensors(self._inputs):
            self._alloc(t, 1)                   # held by the caller
        for part, tree in self._parts.items():
            for t in _tensors(tree):
                self._alloc(t, 1)
            self.tag(part, tree)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._peak()


def meta_like(tree):
    """``tree`` (dicts, lists, tuples, namedtuples) with every tensor and
    numpy array replaced by a meta tensor of its shape and dtype (a
    tensor's strides too): fakes of a step's real inputs."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, np.ndarray):
        dt = torch.from_numpy(np.empty(0, dtype=tree.dtype)).dtype
        return torch.empty(tree.shape, dtype=dt, device="meta")
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(meta_like(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree


def analyze(fn, *args, parts=None, host_reads: bool = False, **kw) -> Cost:
    """Run ``fn(*args, **kw)`` under a fresh ``Analysis`` and return its
    ``Cost`` (``cost.result`` is what ``fn`` returned).  ``parts`` tags
    input trees for the peak's split (``Analysis``)."""
    an = Analysis(inputs=(args, kw), parts=parts, host_reads=host_reads)
    with an:
        out = fn(*args, **kw)
    an.cost.result = out
    return an.cost
