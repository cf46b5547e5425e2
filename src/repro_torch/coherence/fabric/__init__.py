"""Coherence fabric on torch: the sharded TSU service behind every lease.

  backend.py — FabricBackend: the one lease API (+ device resolution);
               HostFabric = the host-object oracle behind it
  arrays.py  — ArrayFabric: the single-device array-native backend (state
               as core.state tensors; op scan, fast read, batched passes);
               ShardedArrayFabric: the TSU rows spread over the ranks of
               a torch.distributed group, one owner_gather a pass;
               default_fabric() picks between them
  pipeline.py— the batched grant pipeline: round schedulers + the
               vectorized miss / write / fence passes
  tsu.py     — TSUShard / TSUFabric: the host MM+TSU authority;
               FabricConfig, LeaseGrant, stable_hash
  cache.py   — ReplicaCache over SharedCache: the host L1-over-L2 tiers
  writeq.py  — WriteQueue: bounded posted write-throughs + fence
  stats.py   — FabricStats: the simulator-compatible telemetry block
"""
from repro_torch.coherence.fabric.arrays import (ArrayFabric,  # noqa: F401
                                                 ShardedArrayFabric,
                                                 default_fabric)
from repro_torch.coherence.fabric.backend import (FabricBackend,  # noqa: F401
                                                  HostFabric, Op,
                                                  ReadBatchHandle)
from repro_torch.coherence.fabric.cache import (ReplicaCache,  # noqa: F401
                                                SharedCache)
from repro_torch.coherence.fabric.stats import FabricStats  # noqa: F401
from repro_torch.coherence.fabric.tsu import (FabricConfig,  # noqa: F401
                                              LeaseGrant, TSUFabric,
                                              TSUShard, stable_hash)
from repro_torch.coherence.fabric.writeq import WriteQueue  # noqa: F401
