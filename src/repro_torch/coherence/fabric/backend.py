"""The backend contract: one lease API for every fabric implementation.

The port's copy of ``repro.coherence.fabric.backend``.  Every
implementation must be bit-identical on any op trace:

  * ``HostFabric`` (this file) — the host-object fabric (``TSUShard``
    dicts, ``_SetAssoc`` lists): slow, obvious, the differential-test
    oracle.  One Python call per key, no device.
  * ``ArrayFabric`` / ``ShardedArrayFabric`` (arrays.py) — the state as
    ``core.state`` tensors on the card, the TSU rows of the sharded one
    spread over the ranks of a ``torch.distributed`` group.

Op vocabulary:

  read(key, replica)          -> (value, version)|None
  write(key, value, replica)  posted write-through
  fence()                     drain + clock jump
  mm_write(key, value)        raw authority write
  publish(key, value, node)   mm_write + adopt into a node's shared tier
  mm_read(key)                raw authority read

Every backend also exposes ``grant_log`` — the ordered list of
``(key, wts, rts, version)`` leases the MM+TSU authority granted.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.coherence.fabric.cache import ReplicaCache, SharedCache
from repro_torch.coherence.fabric.tsu import FabricConfig, TSUFabric

# A bounded TSU is part of the contract: the array backend is a fixed
# [n_shards, capacity] table, so the oracle must run with the same bound.
DEFAULT_TSU_CAPACITY = 1024
# grant_log bound, shared by every backend so parity-compared logs
# truncate identically
GRANT_LOG_LEN = 65536


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card —
    under an initialised ``torch.distributed`` group the rank's own,
    ``cuda:LOCAL_RANK`` (the group rank when ``LOCAL_RANK`` is unset), and
    ``cuda:0`` for every rank when the host has one card (a one-card world
    over gloo).  Raises when CUDA is asked for and absent — never falls
    back to the CPU silently; callers that want the CPU pass
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the fabric runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if device is None and dist.is_available() and dist.is_initialized():
        idx = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        n = torch.cuda.device_count()
        if n == 1:
            idx = 0
        elif idx >= n:
            raise RuntimeError(f"local rank {idx} has no card of its own: "
                               f"{n} are visible")
        dev = torch.device("cuda", idx)
    return dev


def to_device(a, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``.  For a CUDA device
    the copy goes through pinned memory with ``non_blocking=True``: a copy
    from pageable memory would wait for the stream, and the serving path
    must enqueue device work without waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


class Op(NamedTuple):
    """One fabric operation, the unit of the differential trace."""

    kind: str                       # read|write|fence|mm_write|publish|mm_read
    key: Any = None
    value: Any = None
    replica: int = 0
    node: int = 0                   # publish target tier
    wr_lease: Optional[int] = None


def _bounded(cfg: FabricConfig) -> FabricConfig:
    if cfg.tsu_capacity is None:
        cfg = dataclasses.replace(cfg, tsu_capacity=DEFAULT_TSU_CAPACITY)
    return cfg


class ReadBatchHandle:
    """The pending result of ``FabricBackend.read_batch_async``: the device
    work is already enqueued; ``.result()`` runs (and caches) the
    host-side decode.  CUDA stream asynchrony provides the overlap."""

    __slots__ = ("_finish", "_out")

    def __init__(self, finish):
        self._finish = finish
        self._out = None

    def result(self) -> List:
        if self._finish is not None:
            self._out = self._finish()
            self._finish = None
        return self._out


class FabricBackend(abc.ABC):
    """Common surface of the fabric implementations."""

    cfg: FabricConfig
    n_nodes: int
    n_replicas: int
    grant_log: List[Tuple[Any, int, int, int]]

    # ------------------------------------------------------------ scalar
    @abc.abstractmethod
    def read(self, key, replica: int = 0) -> Optional[Tuple[Any, Optional[int]]]:
        ...

    @abc.abstractmethod
    def write(self, key, value, replica: int = 0,
              wr_lease: Optional[int] = None) -> None:
        ...

    @abc.abstractmethod
    def fence(self) -> int:
        ...

    @abc.abstractmethod
    def mm_write(self, key, value,
                 wr_lease: Optional[int] = None) -> Tuple[int, int, int]:
        """Raw authority write -> (wts, rts, version)."""

    @abc.abstractmethod
    def publish(self, key, value, node: int = 0,
                wr_lease: Optional[int] = None) -> Tuple[int, int]:
        """Authority write + adopt into ``node``'s shared tier -> (wts, rts)."""

    @abc.abstractmethod
    def mm_read(self, key) -> Optional[Tuple[Any, int, int, int]]:
        """Raw authority read -> (value, version, wts, rts) | None."""

    @abc.abstractmethod
    def memts(self, key) -> int:
        ...

    @abc.abstractmethod
    def stats(self) -> Dict[str, int]:
        ...

    @abc.abstractmethod
    def replica_stats(self, replica: int = 0) -> Dict[str, int]:
        ...

    @abc.abstractmethod
    def peek(self, key, replica: int = 0) -> bool:
        """Non-mutating: True iff a read would hit the replica tier."""

    # ------------------------------------------------------------ batched
    def read_batch(self, keys: Sequence, replica: int = 0) -> List:
        """Batched read with TWO-PHASE semantics: replica-tier lease hits
        are served first, in op order, then the misses run the full
        descend-and-fill transition, in op order.  An all-hit batch bumps
        ``fast_read_batches``."""
        hits = [self.peek(k, replica) for k in keys]
        if keys and all(hits):
            self._note_fast_read_batch()
        out: List = [None] * len(keys)
        for i, k in enumerate(keys):
            if hits[i]:
                out[i] = self.read(k, replica)
        for i, k in enumerate(keys):
            if not hits[i]:
                out[i] = self.read(k, replica)
        return out

    def _note_fast_read_batch(self) -> None:
        """Record an all-hit batch in this backend's stats block."""

    def read_batch_async(self, keys: Sequence,
                         replica: int = 0) -> "ReadBatchHandle":
        """Dispatch a batched read and return a handle whose ``.result()``
        yields exactly ``read_batch``'s output.  Resolve handles in
        dispatch order, and every outstanding handle before the next
        write/fence.  This base implementation completes synchronously."""
        out = self.read_batch(keys, replica)
        return ReadBatchHandle(lambda: out)

    def write_batch(self, items: Sequence[Tuple[Any, Any]],
                    replica: int = 0, wr_lease: Optional[int] = None) -> None:
        """Batched posted writes: ONE batch boundary (a single ``apply``);
        every non-empty batch bumps ``write_batches``."""
        items = list(items)
        if not items:
            return
        self._note_write_batch()
        self.apply([Op("write", k, v, replica=replica, wr_lease=wr_lease)
                    for k, v in items])

    def _note_write_batch(self) -> None:
        """Record a posted-write batch in this backend's stats block."""

    def apply(self, ops: Sequence[Op]) -> List[Tuple[Op, Any]]:
        """Run an op trace; returns [(op, result)] in order."""
        out = []
        for op in ops:
            if op.kind == "read":
                r = self.read(op.key, op.replica)
            elif op.kind == "write":
                r = self.write(op.key, op.value, op.replica, op.wr_lease)
            elif op.kind == "fence":
                r = self.fence()
            elif op.kind == "mm_write":
                r = self.mm_write(op.key, op.value, op.wr_lease)
            elif op.kind == "publish":
                r = self.publish(op.key, op.value, op.node, op.wr_lease)
            elif op.kind == "mm_read":
                r = self.mm_read(op.key)
            else:
                raise ValueError(f"unknown op kind {op.kind!r}")
            out.append((op, r))
        return out


class HostFabric(FabricBackend):
    """The host-object fabric behind the backend contract — the oracle.

    Wraps one ``TSUFabric`` + ``n_nodes`` shared tiers + ``n_nodes *
    replicas_per_node`` replica tiers (replica r lives on node
    ``r // replicas_per_node``), and records every authority grant in
    ``grant_log`` in execution order.
    """

    def __init__(self, cfg: FabricConfig = FabricConfig(),
                 n_nodes: int = 1, replicas_per_node: int = 1):
        self.cfg = _bounded(cfg)
        self.n_nodes = n_nodes
        self.n_replicas = n_nodes * replicas_per_node
        self.fabric = TSUFabric(self.cfg)
        self.nodes = [SharedCache(self.fabric, node_id=i)
                      for i in range(n_nodes)]
        self.replicas = [ReplicaCache(self.nodes[r // replicas_per_node])
                         for r in range(self.n_replicas)]
        self.grant_log = collections.deque(maxlen=GRANT_LOG_LEN)
        self._tap_grants()

    def _tap_grants(self) -> None:
        fab, log = self.fabric, self.grant_log
        orig_read, orig_write = fab.read, fab.write

        def read(key, home_shard=None):
            g = orig_read(key, home_shard=home_shard)
            if g is not None:
                log.append((key, g.wts, g.rts, g.version))
            return g

        def write(key, value, *, wr_lease=None, home_shard=None):
            g = orig_write(key, value, wr_lease=wr_lease,
                           home_shard=home_shard)
            log.append((key, g.wts, g.rts, g.version))
            return g

        fab.read, fab.write = read, write

    # ------------------------------------------------------------- ops
    def _note_fast_read_batch(self) -> None:
        self.fabric.stats.bump("fast_read_batches")

    def _note_write_batch(self) -> None:
        self.fabric.stats.bump("write_batches")

    def peek(self, key, replica: int = 0) -> bool:
        return self.replicas[replica].peek(key)

    def read(self, key, replica: int = 0):
        return self.replicas[replica].get(key)

    def write(self, key, value, replica: int = 0, wr_lease=None) -> None:
        self.replicas[replica].put(key, value, wr_lease=wr_lease)

    def fence(self) -> int:
        return self.fabric.barrier()

    def mm_write(self, key, value, wr_lease=None):
        g = self.fabric.write(key, value, wr_lease=wr_lease)
        return g.wts, g.rts, g.version

    def publish(self, key, value, node: int = 0, wr_lease=None):
        g = self.fabric.write(key, value, wr_lease=wr_lease)
        self.nodes[node].adopt(key, value, g)
        return g.wts, g.rts

    def mm_read(self, key):
        g = self.fabric.read(key)
        if g is None:
            return None
        return g.value, g.version, g.wts, g.rts

    # ------------------------------------------------------------ views
    def memts(self, key) -> int:
        return self.fabric.memts(key)

    def stats(self) -> Dict[str, int]:
        return self.fabric.stats.to_dict()

    def replica_stats(self, replica: int = 0) -> Dict[str, int]:
        return self.replicas[replica].stats.to_dict()
