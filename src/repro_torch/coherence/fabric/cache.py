"""Two-tier client caching over the TSU fabric: ReplicaCache over SharedCache.

Mirrors the simulator's L1-over-L2 hierarchy (engine.py) on the host:

  ReplicaCache  — a replica's private tier (the CU's L1): per-cache logical
                  clock ``cts``, set-associative with LRU + victim-way
                  eviction, write-through (writes always descend).
  SharedCache   — the node-shared tier (the GPU's L2): same structure, plus
                  the node's bounded async write queue to the fabric.

Coherence is pure HALCONE: a line is served while ``cts <= rts`` (tag match
alone is not enough); expiry *self-invalidates* — the line is dropped and
refetched from below, and no invalidation message ever travels between
caches (``FabricStats.inval_msgs`` stays 0 by construction).  All timestamp
arithmetic is ``repro_torch.core.protocol``; the tiers only move lines.

The port's copy of ``repro.coherence.fabric.cache``: pure host Python, the
oracle half of the host-object fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch.coherence.fabric.stats import FabricStats
from repro_torch.coherence.fabric.tsu import LeaseGrant, TSUFabric, stable_hash
from repro_torch.coherence.fabric.writeq import WriteQueue
from repro_torch.core import protocol
from repro_torch.core.state import BLOCK_BYTES


@dataclasses.dataclass
class _Line:
    key: Any
    value: Any
    version: Optional[int]   # None while a posted write is in flight
    wts: int
    rts: int
    lru: int = 0
    pending: bool = False    # posted write not yet through the fabric


class _SetAssoc:
    """Host-side set-associative store with the engine's victim rule:
    invalid ways first, else the least-recently-used live way."""

    def __init__(self, sets: int, ways: int):
        self.n_sets, self.n_ways = max(1, sets), max(1, ways)
        self._sets: List[List[Optional[_Line]]] = [
            [None] * self.n_ways for _ in range(self.n_sets)]
        self._tick = 0

    def _row(self, key) -> List[Optional[_Line]]:
        return self._sets[stable_hash(key) % self.n_sets]

    def probe(self, key) -> Optional[_Line]:
        for line in self._row(key):
            if line is not None and line.key == key:
                self._tick += 1
                line.lru = self._tick
                return line
        return None

    def install(self, line: _Line) -> bool:
        """Place (or refresh) a line; returns True iff a live line with a
        DIFFERENT key was displaced (a capacity eviction)."""
        row = self._row(line.key)
        self._tick += 1
        line.lru = self._tick
        victim, score = 0, None
        for w, cur in enumerate(row):
            if cur is not None and cur.key == line.key:
                row[w] = line
                return False
            s = -1 if cur is None else cur.lru     # invalid ways first
            if score is None or s < score:
                victim, score = w, s
        evicted = row[victim] is not None
        row[victim] = line
        return evicted

    def drop(self, key) -> None:
        row = self._row(key)
        for w, cur in enumerate(row):
            if cur is not None and cur.key == key:
                row[w] = None
                return


def _bump(stats: List[FabricStats], name: str, by: int = 1) -> None:
    for s in stats:
        s.bump(name, by)


class SharedCache:
    """Node-shared tier: one per node, fed by that node's write queue."""

    def __init__(self, fabric: TSUFabric, node_id: int = 0,
                 sets: Optional[int] = None, ways: Optional[int] = None,
                 max_in_flight: Optional[int] = None):
        cfg = fabric.cfg
        self.fabric = fabric
        self.node_id = node_id
        self.home_shard = node_id % cfg.n_shards
        self.cts = 0
        self._store = _SetAssoc(sets or cfg.shared_sets,
                                ways or cfg.shared_ways)
        self.queue = WriteQueue(fabric, max_in_flight)
        fabric.attach(self)

    def adopt(self, key, value, grant: LeaseGrant) -> LeaseGrant:
        """Install a fresh MM grant into this tier and advance the node clock
        (the write side of the engine's L2 install).  Used by the drain path
        and by authorities that publish around the queue."""
        lease = protocol.install(self.cts, grant.wts, grant.rts)
        wts, rts = int(lease.wts), int(lease.rts)
        self.cts = int(protocol.cts_after_write(self.cts, wts))
        if self._store.install(_Line(key, value, grant.version, wts, rts)):
            self.fabric.stats.bump("capacity_evictions")
        return LeaseGrant(value, grant.version, wts, rts, grant.shard)

    def get(self, key, mirror: Optional[FabricStats] = None
            ) -> Optional[Tuple[Any, int, int, int]]:
        """Returns (value, version, wts, rts) with the lease this tier holds,
        or None if the fabric has no such block."""
        stats = [self.fabric.stats] + ([mirror] if mirror else [])
        line = self._store.probe(key)
        if line is not None:
            if protocol.valid(self.cts, line.rts):
                _bump(stats, "l2_hits")
                return line.value, line.version, line.wts, line.rts
            _bump(stats, "coh_miss_l2")
            _bump(stats, "self_invalidations")
            self._store.drop(key)
        grant = self.fabric.read(key, home_shard=self.home_shard)
        if grant is None:
            return None
        lease = protocol.install(self.cts, grant.wts, grant.rts)
        wts, rts = int(lease.wts), int(lease.rts)
        if self._store.install(_Line(key, grant.value, grant.version,
                                     wts, rts)):
            _bump(stats, "capacity_evictions")
        return grant.value, grant.version, wts, rts

    def put(self, key, value, on_complete=None, *,
            wr_lease: Optional[int] = None) -> None:
        """Posted write-through: queue the fabric write; on drain, install the
        granted lease here and advance this node's clock before notifying the
        writer (the engine's L2-then-L1 install order)."""

        def _drained(grant: LeaseGrant) -> None:
            installed = self.adopt(key, value, grant)
            if on_complete is not None:
                on_complete(installed)

        self.queue.submit(key, value, _drained, wr_lease=wr_lease,
                          home_shard=self.home_shard)

    def fence(self) -> int:
        return self.queue.fence()


class ReplicaCache:
    """A replica's private tier over the node's SharedCache."""

    def __init__(self, shared: SharedCache,
                 sets: Optional[int] = None, ways: Optional[int] = None):
        cfg = shared.fabric.cfg
        self.shared = shared
        self.cts = 0
        self.stats = FabricStats()       # per-replica view of the same names
        self._store = _SetAssoc(sets or cfg.replica_sets,
                                ways or cfg.replica_ways)
        shared.fabric.attach(self)

    def _stats(self) -> List[FabricStats]:
        return [self.shared.fabric.stats, self.stats]

    def peek(self, key) -> bool:
        """Non-mutating lease check: True iff ``get`` would be served from
        this tier (tag match AND live lease).  No LRU touch, no counters —
        the probe half of the batched read's phase split (backend.py)."""
        for line in self._store._row(key):
            if line is not None and line.key == key:
                return bool(protocol.valid(self.cts, line.rts))
        return False

    def get(self, key) -> Optional[Tuple[Any, int]]:
        stats = self._stats()
        _bump(stats, "reads")
        line = self._store.probe(key)
        if line is not None:
            if protocol.valid(self.cts, line.rts):
                _bump(stats, "l1_hits")
                return line.value, line.version
            _bump(stats, "coh_miss_l1")
            _bump(stats, "self_invalidations")
            self._store.drop(key)
        else:
            _bump(stats, "compulsory")
        _bump(stats, "l1_to_l2")
        # link bytes accrue on the fabric-global view only (the per-replica
        # mirror keeps the simulator-shared subset)
        self.shared.fabric.stats.bump("bytes_l1_l2", BLOCK_BYTES)
        got = self.shared.get(key, mirror=self.stats)
        if got is None:
            return None
        value, version, wts, rts = got
        lease = protocol.install(self.cts, wts, rts)
        _bump(stats, "refetches")
        if self._store.install(_Line(key, value, version,
                                     int(lease.wts), int(lease.rts))):
            _bump(stats, "capacity_evictions")
        return value, version

    def put(self, key, value, *, wr_lease: Optional[int] = None) -> None:
        stats = self._stats()
        _bump(stats, "writes")
        _bump(stats, "l1_to_l2")         # write-through: writes descend
        self.shared.fabric.stats.bump("bytes_l1_l2", BLOCK_BYTES)

        def _installed(grant: LeaseGrant) -> None:
            lease = protocol.install(self.cts, grant.wts, grant.rts)
            wts, rts = int(lease.wts), int(lease.rts)
            self.cts = int(protocol.cts_after_write(self.cts, wts))
            # the fabric already counted this write-through at the drain;
            # mirror it into the per-replica view only.
            self.stats.bump("write_throughs")
            if self._store.install(_Line(key, value, grant.version,
                                         wts, rts)):
                _bump(stats, "capacity_evictions")

        # store-buffer forwarding: own reads see the posted write while it is
        # in flight (version None until the fabric assigns one); the
        # provisional lease dies as soon as cts advances.
        if self._store.install(_Line(key, value, None, self.cts, self.cts,
                                     pending=True)):
            _bump(stats, "capacity_evictions")
        self.shared.put(key, value, _installed, wr_lease=wr_lease)

    def fence(self) -> int:
        return self.shared.fence()
