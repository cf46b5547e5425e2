"""Lease-coherent prefix-KV cache for multi-replica serving, on torch.

The port of ``repro.coherence.kv_lease.BatchedKVLease``: prefill results
(prefix KV blocks) are shared across serving replicas; replicas
*self-invalidate* on lease expiry instead of receiving invalidation
messages when a prefix is republished.  ``BatchedKVLease`` is a thin
veneer over a ``FabricBackend`` — by default ``default_fabric()``: the
``ShardedArrayFabric`` when a ``torch.distributed`` group is initialised
and the TSU shards can spread over more than one rank, else the
single-device ``ArrayFabric``, on the CUDA card — whose
``get_batch``/``put_batch`` issue ONE batched lease probe per decode batch
instead of a Python call per key.

``AuthoritativeStore`` / ``LeaseKVCache`` are the HOST-OBJECT adapters
over the oracle fabric (``TSUFabric``, ``SharedCache``, ``ReplicaCache``):
the differential tests hold the array fabrics to them; they are not a
production path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.coherence.fabric import (FabricBackend, FabricConfig,
                                          ReplicaCache, SharedCache,
                                          TSUFabric, default_fabric)


class BatchedKVLease:
    """A serving replica's batched lease front end (the production path).

    One ``get_batch`` = one vectorized fabric probe for the whole decode
    batch (lease hits served in one ``state.tier_probe`` call, misses
    through the batched miss pass); one ``put_batch`` = the posted
    write-throughs for every freshly prefilled prefix.
    """

    def __init__(self, backend: Optional[FabricBackend] = None,
                 replica: int = 0, pipeline: Optional[str] = None,
                 device=None):
        """``pipeline`` ("batched" default, "scan" for the op scan) and
        ``device`` (None = the CUDA card) apply only when this adapter
        builds its own backend; an explicit ``backend`` already carries
        both, so passing them too is a conflict, not a silent no-op."""
        if backend is not None and (pipeline is not None
                                    or device is not None):
            raise ValueError(
                "pipeline=/device= only apply when BatchedKVLease builds "
                "its own fabric; construct the backend with them instead")
        self.backend = backend if backend is not None else default_fabric(
            FabricConfig(), pipeline=pipeline or "batched", device=device)
        self.replica = replica

    # ------------------------------------------------------------ batched
    def get_batch(self, keys: Sequence[str]) -> List:
        """[(value, version) | None] per key, one fabric round trip."""
        return self.backend.read_batch(keys, replica=self.replica)

    def get_batch_async(self, keys: Sequence[str]):
        """Enqueue ``get_batch``'s fabric work and defer the host-side
        payload decode: returns a ``ReadBatchHandle`` whose ``.result()``
        yields exactly ``get_batch``'s output.  Resolve before this
        replica's next write/fence."""
        return self.backend.read_batch_async(keys, replica=self.replica)

    def put_batch(self, items: Sequence[Tuple[str, Any]]) -> None:
        """Post every freshly prefilled prefix as ONE write batch."""
        self.backend.write_batch(items, replica=self.replica)

    # ------------------------------------------------------------- scalar
    def get(self, key: str):
        return self.backend.read(key, replica=self.replica)

    def put(self, key: str, value: Any) -> None:
        self.backend.write(key, value, replica=self.replica)

    def fence(self) -> int:
        return self.backend.fence()

    # ------------------------------------------------------------- views
    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter names, derived from the replica's fabric view."""
        s = self.backend.replica_stats(self.replica)
        return {"hits": s["l1_hits"],
                "coherence_misses": s["coh_miss_l1"],
                "compulsory": s["compulsory"],
                "refetches": s["refetches"],
                "capacity_evictions": s["capacity_evictions"]}

    @property
    def fabric_stats(self) -> Dict[str, int]:
        return self.backend.stats()


class AuthoritativeStore:
    """HOST-ORACLE adapter: the MM+TSU front door over the host fabric.

    Adapter over a host ``TSUFabric``; also owns the node-shared cache tier
    that every ``LeaseKVCache`` replica attached to this store reads
    through.  Used by the oracle half of the parity suite.
    """

    def __init__(self, rd_lease: Optional[int] = None,
                 wr_lease: Optional[int] = None,
                 fabric: Optional[TSUFabric] = None, node_id: int = 0):
        if fabric is None:
            fabric = TSUFabric(FabricConfig(
                n_shards=1, rd_lease=rd_lease if rd_lease is not None else 8,
                wr_lease=wr_lease if wr_lease is not None else 4,
                max_in_flight=0))
        elif ((rd_lease is not None and rd_lease != fabric.cfg.rd_lease)
              or (wr_lease is not None and wr_lease != fabric.cfg.wr_lease)):
            raise ValueError(
                "explicit rd_lease/wr_lease conflict with the supplied "
                f"fabric's config ({fabric.cfg.rd_lease}/{fabric.cfg.wr_lease})"
                "; set them on the FabricConfig instead")
        self.fabric = fabric
        self.rd_lease = self.fabric.cfg.rd_lease
        self.wr_lease = self.fabric.cfg.wr_lease
        # legacy stores write through synchronously (max_in_flight=0)
        self.shared = SharedCache(self.fabric, node_id=node_id,
                                  max_in_flight=0)

    @property
    def blocks(self) -> Dict[str, Any]:
        """Live view of the fabric's MM+TSU rows (``.value/.version/.memts``)."""
        return self.fabric.entries()

    def write(self, key: str, value: Any) -> Tuple[int, int]:
        """Publish around the replicas (upstream recompute / model refresh).
        The grant is adopted into the node tier so the node clock advances —
        otherwise a reader fencing past memts could be served the old value
        from a shared line whose lease never expires."""
        grant = self.fabric.write(key, value)
        self.shared.adopt(key, value, grant)
        return grant.wts, grant.rts

    def read(self, key: str) -> Optional[Tuple[Any, int, int, int]]:
        grant = self.fabric.read(key)
        if grant is None:
            return None
        return grant.value, grant.version, grant.wts, grant.rts


class LeaseKVCache:
    """HOST-ORACLE adapter: a replica's local cache with a logical clock.

    cts advances on every write-through this replica performs; reads hit
    while cts <= rts; expiry triggers a refetch from the node tier or the
    fabric — NO invalidation traffic ever flows between replicas.
    """

    _WAYS = 4

    def __init__(self, store: AuthoritativeStore, capacity: int = 128):
        self.store = store
        self.capacity = capacity
        self.replica = ReplicaCache(store.shared,
                                    sets=max(1, capacity // self._WAYS),
                                    ways=self._WAYS)

    # the legacy tests drive the replica clock directly (reader fence)
    @property
    def cts(self) -> int:
        return self.replica.cts

    @cts.setter
    def cts(self, v: int) -> None:
        self.replica.cts = int(v)

    def get(self, key: str):
        return self.replica.get(key)

    def put(self, key: str, value: Any) -> None:
        """Write-through: publish to the fabric, adopt its lease, and advance
        this replica's clock (cts = max(cts, wts))."""
        self.replica.put(key, value)

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counter names, derived from the replica's FabricStats."""
        s = self.replica.stats
        return {"hits": s.l1_hits,
                "coherence_misses": s.coh_miss_l1,
                "compulsory": s.compulsory,
                "refetches": s.refetches,
                "capacity_evictions": s.capacity_evictions}

    @property
    def fabric_stats(self):
        return self.replica.stats
