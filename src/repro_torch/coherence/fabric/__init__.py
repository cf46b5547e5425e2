"""Coherence fabric on torch: the sharded TSU service behind every lease.

  backend.py — FabricBackend: the one lease API (+ device resolution)
  arrays.py  — ArrayFabric: the single-device array-native backend (state
               as core.state tensors; op scan, fast read, batched passes);
               default_fabric()
  pipeline.py— the batched grant pipeline: round schedulers + the
               vectorized miss / write / fence passes
  tsu.py     — FabricConfig, LeaseGrant, stable_hash
  stats.py   — FabricStats: the simulator-compatible telemetry block
"""
from repro_torch.coherence.fabric.arrays import (ArrayFabric,  # noqa: F401
                                                 default_fabric)
from repro_torch.coherence.fabric.backend import (FabricBackend,  # noqa: F401
                                                  Op, ReadBatchHandle)
from repro_torch.coherence.fabric.stats import FabricStats  # noqa: F401
from repro_torch.coherence.fabric.tsu import (FabricConfig,  # noqa: F401
                                              LeaseGrant, stable_hash)
