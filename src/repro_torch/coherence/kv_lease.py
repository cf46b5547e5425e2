"""Lease-coherent prefix-KV cache for multi-replica serving, on torch.

The port of ``repro.coherence.kv_lease.BatchedKVLease``: prefill results
(prefix KV blocks) are shared across serving replicas; replicas
*self-invalidate* on lease expiry instead of receiving invalidation
messages when a prefix is republished.  ``BatchedKVLease`` is a thin
veneer over a ``FabricBackend`` — by default ``default_fabric()``, the
single-device ``ArrayFabric`` on the CUDA card — whose
``get_batch``/``put_batch`` issue ONE batched lease probe per decode batch
instead of a Python call per key.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.coherence.fabric import (FabricBackend, FabricConfig,
                                          default_fabric)


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
