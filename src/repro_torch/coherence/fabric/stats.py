"""Unified coherence telemetry: one counter block for simulator and service.

The port's copy of ``repro.coherence.fabric.stats``: the fabric reports
the exact counter names of the hierarchy simulator
(``repro_torch.core.engine.COUNTERS``) plus a few service-level extras, so
a production trace and a simulated trace compare row for row.

Name mapping (service <-> simulator):
  l1_*  = replica tier (the CU's L1)
  l2_*  = node-shared tier (the GPU's L2)
  *_mm  = the sharded TSU + main-memory authority
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.engine import COUNTERS


@dataclasses.dataclass
class FabricStats:
    """Counter block; field names are a superset of ``COUNTERS``."""

    # --- simulator-compatible counters (COUNTERS) ---
    reads: int = 0            # client read ops
    writes: int = 0           # client write ops
    l1_hits: int = 0          # replica-tier lease hits
    l2_hits: int = 0          # shared-tier lease hits
    l1_to_l2: int = 0         # replica misses + write-throughs descending
    l2_to_mm: int = 0         # fabric (TSU+MM) accesses
    coh_miss_l1: int = 0      # replica tag hit, lease expired (self-inval)
    coh_miss_l2: int = 0      # shared tag hit, lease expired (self-inval)
    wb_evictions: int = 0     # always 0: the fabric is write-through
    inval_msgs: int = 0       # always 0: HALCONE sends no invalidations
    pcie_blocks: int = 0      # MM accesses routed to a non-home TSU shard
    bytes_l1_l2: int = 0      # replica<->shared link bytes
    bytes_l2_mm: int = 0      # shared<->TSU/MM link bytes
    bytes_inter_gpu: int = 0  # cross-shard (non-home TSU) link bytes
    # --- service extras ---
    write_throughs: int = 0   # queue drains that reached the fabric
    self_invalidations: int = 0  # expired lines dropped (coh_miss_l1 + l2)
    compulsory: int = 0       # replica misses with no tag present
    refetches: int = 0        # replica fills from below (shared or MM)
    capacity_evictions: int = 0  # victim-way displacements of live lines
    tsu_evictions: int = 0    # TSU set overflow victims (memts reinit to 0)
    overflow_reinits: int = 0 # 16-bit timestamp wraps (Algorithm: reinit)
    fences: int = 0           # barrier ops (kernel-boundary cts jump)
    fast_read_batches: int = 0  # read_batch calls served entirely by the
                              # replica tier (every key a lease hit)
    write_batches: int = 0    # non-empty write_batch calls

    def bump(self, name: str, by: int = 1) -> None:
        setattr(self, name, getattr(self, name) + by)

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def engine_view(self) -> Dict[str, int]:
        """Only the simulator-shared counters, in COUNTERS order."""
        d = self.to_dict()
        return {k: d[k] for k in COUNTERS}


_missing = set(COUNTERS) - {f.name for f in dataclasses.fields(FabricStats)}
assert not _missing, f"FabricStats lost engine counters: {_missing}"


# ----------------------------------------------- device counter-vector layout
# The fabric accumulates counters as one int32 vector per fabric / per
# replica; these tuples are the ONE definition of that vector's layout.
# wb_evictions / inval_msgs are 0 by construction and fast_read_batches /
# write_batches are host-side batch-boundary counts, so none appear here.
G_KEYS = ("reads", "writes", "l1_hits", "l2_hits", "l1_to_l2", "l2_to_mm",
          "coh_miss_l1", "coh_miss_l2", "pcie_blocks", "write_throughs",
          "self_invalidations", "compulsory", "refetches",
          "capacity_evictions", "tsu_evictions", "overflow_reinits",
          "fences", "bytes_l1_l2", "bytes_l2_mm", "bytes_inter_gpu")
# the per-replica mirror subset (host ReplicaCache.stats semantics)
R_KEYS = ("reads", "writes", "l1_hits", "l2_hits", "l1_to_l2",
          "coh_miss_l1", "coh_miss_l2", "self_invalidations", "compulsory",
          "refetches", "capacity_evictions", "write_throughs")
GI = {k: i for i, k in enumerate(G_KEYS)}
RI = {k: i for i, k in enumerate(R_KEYS)}

_unknown = (set(G_KEYS) | set(R_KEYS)) - {f.name for f in
                                          dataclasses.fields(FabricStats)}
assert not _unknown, f"counter-vector keys missing from FabricStats: {_unknown}"
