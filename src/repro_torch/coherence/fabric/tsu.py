"""The sharded TSU service on the host: the lease authority of the
host-object oracle, plus the fabric's configuration, grant record and key
hash.

The port's copy of ``repro.coherence.fabric.tsu``.  ``FabricConfig``,
``LeaseGrant`` and ``stable_hash`` are byte for byte the reference's, so
keys route to the same shards and sets in both packages.  The paper
places one timestamp storage unit per HBM stack; the host fabric mirrors
that as N ``TSUShard``s behind the key hash (``TSUFabric.shard_of``).
Each shard is the MM+TSU pair for its keys: it holds the authoritative
value and version (MM) next to the 16-bit logical clock ``memts`` (TSU),
and every timestamp decision is a call into ``repro_torch.core.protocol``.

Overflow: when a grant would push ``memts`` past ``protocol.TS_MAX`` the
entry re-initializes to 0 and the grant is recomputed from the fresh clock
(write-through means MM always holds the data), as the engine and the
array fabric do.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Any, Dict, List, NamedTuple, Optional

from repro_torch.coherence.fabric.stats import FabricStats
from repro_torch.core import protocol
from repro_torch.core.state import BLOCK_BYTES


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    n_shards: int = 4
    rd_lease: int = 8
    wr_lease: int = 4
    tsu_capacity: Optional[int] = None   # per-shard entry cap (None = unbounded)
    shared_sets: int = 64                # node-shared tier geometry
    shared_ways: int = 4
    replica_sets: int = 32               # replica tier geometry
    replica_ways: int = 2
    max_in_flight: int = 8               # write-queue bound

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.rd_lease < 1 or self.wr_lease < 1:
            raise ValueError("rd_lease/wr_lease must be >= 1, got "
                             f"{self.rd_lease}/{self.wr_lease}")


class LeaseGrant(NamedTuple):
    """A TSU response: the block plus its [wts, rts] lease."""
    value: Any
    version: int
    wts: int
    rts: int
    shard: int


@dataclasses.dataclass
class _Entry:
    """One MM block + its TSU row (value/version = MM, memts = TSU)."""
    value: Any = None
    version: int = 0
    memts: int = 0


def stable_hash(key) -> int:
    """Process-independent key hash (python's hash() is salted per run)."""
    if not isinstance(key, bytes):
        key = str(key).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big")


class TSUShard:
    """One per-HBM-stack TSU: grants leases for the keys hashed to it."""

    def __init__(self, shard_id: int, cfg: FabricConfig, stats: FabricStats):
        self.shard_id = shard_id
        self.cfg = cfg
        self.stats = stats
        self.entries: Dict[Any, _Entry] = {}

    # ------------------------------------------------------------- grants
    def mm_read(self, key) -> Optional[LeaseGrant]:
        e = self.entries.get(key)
        if e is None:
            return None
        lease, new_memts = protocol.mm_read(e.memts, self.cfg.rd_lease)
        wts, rts, e.memts = self._reinit(lease, new_memts, self.cfg.rd_lease)
        return LeaseGrant(e.value, e.version, wts, rts, self.shard_id)

    def mm_write(self, key, value, wr_lease: Optional[int] = None) -> LeaseGrant:
        wl = self.cfg.wr_lease if wr_lease is None else wr_lease
        e = self.entries.get(key)
        if e is None:
            e = self._allocate(key)
        lease, new_memts = protocol.mm_write(e.memts, wl)
        wts, rts, e.memts = self._reinit(lease, new_memts, wl)
        e.value = value
        e.version += 1
        return LeaseGrant(e.value, e.version, wts, rts, self.shard_id)

    # ------------------------------------------------------------ helpers
    def _reinit(self, lease: protocol.Lease, new_memts: int, lease_len: int):
        """16-bit overflow reinit, the grant the engine computes: the clock
        restarts at 0 and the request is re-served as a first access."""
        if protocol.overflow_reinit(new_memts) != new_memts:
            self.stats.bump("overflow_reinits")
            lease, new_memts = protocol.mm_read(0, lease_len)
        return int(lease.wts), int(lease.rts), int(new_memts)

    def _allocate(self, key) -> _Entry:
        cap = self.cfg.tsu_capacity
        if cap is not None and len(self.entries) >= cap:
            # victim way: evict the min-memts row (the engine's TSU victim);
            # its next requester re-initializes from memts=0
            victim = min(self.entries, key=lambda k: self.entries[k].memts)
            del self.entries[victim]
            self.stats.bump("tsu_evictions")
        e = _Entry()
        self.entries[key] = e
        return e


class TSUFabric:
    """Key-hash router over the shards: the one front door for leases.

    ``home_shard`` on read/write names the caller's local stack; an access
    routed to any other shard is a cross-switch hop, counted as
    ``pcie_blocks`` and ``bytes_inter_gpu``.
    """

    def __init__(self, cfg: FabricConfig = FabricConfig()):
        self.cfg = cfg
        self.stats = FabricStats()
        self.shards: List[TSUShard] = [
            TSUShard(i, cfg, self.stats) for i in range(cfg.n_shards)]
        # weakly-held registries: a cache torn down elsewhere must not be
        # kept alive (or flushed) by the fabric
        self._caches: list = []          # weakrefs to client clocks (barrier)
        self._queues: list = []          # weakrefs to write queues

    # ------------------------------------------------------------ routing
    def shard_of(self, key) -> int:
        return stable_hash(key) % self.cfg.n_shards

    # ------------------------------------------------------------- access
    def read(self, key, home_shard: Optional[int] = None) -> Optional[LeaseGrant]:
        s = self.shard_of(key)
        self.stats.bump("l2_to_mm")
        self.stats.bump("bytes_l2_mm", BLOCK_BYTES)
        if home_shard is not None and s != home_shard:
            self.stats.bump("pcie_blocks")
            self.stats.bump("bytes_inter_gpu", BLOCK_BYTES)
        return self.shards[s].mm_read(key)

    def write(self, key, value, *, wr_lease: Optional[int] = None,
              home_shard: Optional[int] = None) -> LeaseGrant:
        s = self.shard_of(key)
        self.stats.bump("l2_to_mm")
        self.stats.bump("bytes_l2_mm", BLOCK_BYTES)
        self.stats.bump("write_throughs")
        if home_shard is not None and s != home_shard:
            self.stats.bump("pcie_blocks")
            self.stats.bump("bytes_inter_gpu", BLOCK_BYTES)
        return self.shards[s].mm_write(key, value, wr_lease)

    def memts(self, key) -> int:
        e = self.shards[self.shard_of(key)].entries.get(key)
        return 0 if e is None else e.memts

    def entries(self) -> Dict[Any, _Entry]:
        """Merged live view of every shard's MM+TSU rows."""
        out: Dict[Any, _Entry] = {}
        for sh in self.shards:
            out.update(sh.entries)
        return out

    # ------------------------------------------------------------ barrier
    def attach(self, cache) -> None:
        self._caches.append(weakref.ref(cache))

    def attach_queue(self, queue) -> None:
        self._queues.append(weakref.ref(queue))

    @staticmethod
    def _live(refs: list) -> list:
        alive = [(r, o) for r in refs if (o := r()) is not None]
        refs[:] = [r for r, _ in alive]          # prune dead registrations
        return [o for _, o in alive]

    def barrier(self) -> int:
        """Kernel-boundary fence (engine op 3): drain every in-flight write,
        then jump every attached clock to the global maximum cts."""
        for q in self._live(self._queues):
            q.flush()
        self.stats.bump("fences")
        caches = self._live(self._caches)
        gmax = max((c.cts for c in caches), default=0)
        for c in caches:
            c.cts = max(c.cts, gmax)
        return gmax
