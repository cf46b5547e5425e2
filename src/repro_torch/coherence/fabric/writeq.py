"""Async write-through queue with bounded in-flight writes.

HALCONE's writes are POSTED: the writer does not stall for the MM round trip
(engine.py's write_lat has no mm term).  The host-side analogue is this
queue: ``submit`` enqueues the write-through and returns immediately; drains
happen in FIFO order whenever more than ``max_in_flight`` writes are
outstanding, on ``flush``, or at a ``fence``.

A fence is the kernel boundary (engine trace op 3): every queued write
reaches the TSU, then every attached clock jumps to the global maximum cts —
after the fence, no reader can be served a pre-fence version under an old
lease it already held only because its clock lagged.

``max_in_flight=0`` degenerates to synchronous write-through (the legacy
``kv_lease`` behavior, and what the adapters use).

The port's copy of ``repro.coherence.fabric.writeq``.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Deque, NamedTuple, Optional

from repro_torch.coherence.fabric.tsu import LeaseGrant, TSUFabric


class _Pending(NamedTuple):
    key: Any
    value: Any
    on_complete: Optional[Callable[[LeaseGrant], None]]
    wr_lease: Optional[int]
    home_shard: Optional[int]


class WriteQueue:
    def __init__(self, fabric: TSUFabric, max_in_flight: Optional[int] = None):
        self.fabric = fabric
        self.max_in_flight = (fabric.cfg.max_in_flight
                              if max_in_flight is None else max_in_flight)
        self._q: Deque[_Pending] = collections.deque()
        fabric.attach_queue(self)

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, key, value,
               on_complete: Optional[Callable[[LeaseGrant], None]] = None,
               *, wr_lease: Optional[int] = None,
               home_shard: Optional[int] = None) -> None:
        self._q.append(_Pending(key, value, on_complete, wr_lease, home_shard))
        while len(self._q) > self.max_in_flight:
            self._drain_one()

    def _drain_one(self) -> None:
        p = self._q.popleft()
        grant = self.fabric.write(p.key, p.value, wr_lease=p.wr_lease,
                                  home_shard=p.home_shard)
        if p.on_complete is not None:
            p.on_complete(grant)

    def flush(self) -> None:
        while self._q:
            self._drain_one()

    def fence(self) -> int:
        """Flush + kernel-boundary clock jump (delegates to the fabric, which
        drains every attached queue before moving the clocks)."""
        return self.fabric.barrier()
