"""System configurations for the paper's five evaluated MGPU systems (§4.1).

The port's copy of ``repro.core.sysconfig``, with the same fields,
defaults and factories (the name encodes interconnect - L2 policy -
coherence):

  ===================  =========  =========  =============================
  name                 topology   L2 policy  coherence
  ===================  =========  =========  =============================
  RDMA-WB-NC           rdma       wb         none (baseline; explicit h2d
                                             copies, remote L2 over PCIe)
  RDMA-WB-C-HMG        rdma       wb         HMG: VI-style home directory,
                                             writer invalidates sharers
  SM-WB-NC             sm         wb         none (shared memory, no coh.)
  SM-WT-NC             sm         wt         none (the paper's perf target)
  SM-WT-C-HALCONE      sm         wt         HALCONE timestamps (§3)
  ===================  =========  =========  =============================

Geometry is Table 2's real sizes (64 B blocks): per-CU L1 16 KB 4-way
(l1_sets=64), per-GPU L2 256 KB 16-way x 8 banks (l2_sets=256), 8 HBM
stacks, TSU 8-way with 2048 sets per stack; latencies and service times
follow §4.1 at 1 GHz; the default leases are RdLease=10, WrLease=5 (§4.2).

**Meta fields** are structural (they fix array shapes and the round
step's branches); **data fields** are the numeric knobs.  Configs that
share ``static_key()`` stack with ``stack_configs`` into one config whose
data fields are ``[C]`` tensors, and ``core.engine.sweep`` runs them as
one group of cells.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str = "SM-WT-C-HALCONE"
    n_gpus: int = 4
    cus_per_gpu: int = 32
    topology: str = "sm"            # sm | rdma
    l2_policy: str = "wt"           # wt | wb
    protocol: str = "halcone"       # none | halcone | hmg
    rd_lease: int = 10
    wr_lease: int = 5
    # geometry (64 B blocks)
    l1_sets: int = 64
    l1_ways: int = 4
    l2_banks: int = 8
    l2_sets: int = 256
    l2_ways: int = 16
    n_hbm: int = 8
    tsu_sets: int = 2048
    tsu_ways: int = 8
    page_blocks: int = 64           # 4 KB pages interleaved across modules
    # latencies (cycles @ 1 GHz)
    l1_lat: float = 4.0
    l2_lat: float = 28.0
    mm_lat: float = 200.0           # incl. the calibrated 100-cycle MC
    tsu_lat: float = 50.0           # parallel with DRAM -> off critical path
    pcie_lat: float = 600.0
    # per-64B-block service times (queuing): cycles/block
    l2_service: float = 6.0         # effective bank occupancy per access
    mm_service: float = 3.0         # row activation + 1TB/s aggregate
    pcie_service: float = 2.0       # 32 GB/s = 32 B/cycle -> 2 cyc/block
    mlp: float = 4.0                # per-CU memory-level parallelism: a CU's
                                    # wavefronts overlap ~4 outstanding misses

    @property
    def n_cus(self) -> int:
        return self.n_gpus * self.cus_per_gpu

    @property
    def coherent(self) -> bool:
        return self.protocol == "halcone"


META_FIELDS = ("name", "n_gpus", "cus_per_gpu", "topology", "l2_policy",
               "protocol", "l1_sets", "l1_ways", "l2_banks", "l2_sets",
               "l2_ways", "n_hbm", "tsu_sets", "tsu_ways", "page_blocks")
DATA_FIELDS = ("rd_lease", "wr_lease", "l1_lat", "l2_lat", "mm_lat",
               "tsu_lat", "pcie_lat", "l2_service", "mm_service",
               "pcie_service", "mlp")


def static_key(cfg: SystemConfig) -> tuple:
    """Hashable structural signature.  Configs with equal keys (ignoring
    ``name``) share one round step and may be stacked into one group."""
    return tuple(getattr(cfg, f) for f in META_FIELDS if f != "name")


def _stack(values) -> torch.Tensor:
    """Python numbers as one CPU tensor, typed as ``jnp.stack`` types
    them: int32 when every value is an int, else float32."""
    ints = all(isinstance(v, int) for v in values)
    return torch.tensor(values, dtype=torch.int32 if ints else torch.float32)


def stack_configs(cfgs) -> SystemConfig:
    """Stack configs sharing static structure into one config whose data
    fields are ``[C]`` CPU tensors (int32 leases, float32 latencies) and
    whose name joins theirs; raises ``ValueError`` on mixed structure."""
    cfgs = list(cfgs)
    base = static_key(cfgs[0])
    for c in cfgs[1:]:
        if static_key(c) != base:
            raise ValueError(f"config {c.name} has different static "
                             f"structure than {cfgs[0].name}; use "
                             "engine.sweep to mix static groups")
    return dataclasses.replace(
        cfgs[0], name="|".join(c.name for c in cfgs),
        **{f: _stack([getattr(c, f) for c in cfgs]) for f in DATA_FIELDS})


def rdma_wb_nc(**kw) -> SystemConfig:
    return SystemConfig(name="RDMA-WB-NC", topology="rdma", l2_policy="wb",
                        protocol="none", **kw)


def rdma_wb_hmg(**kw) -> SystemConfig:
    return SystemConfig(name="RDMA-WB-C-HMG", topology="rdma", l2_policy="wb",
                        protocol="hmg", **kw)


def sm_wb_nc(**kw) -> SystemConfig:
    return SystemConfig(name="SM-WB-NC", topology="sm", l2_policy="wb",
                        protocol="none", **kw)


def sm_wt_nc(**kw) -> SystemConfig:
    return SystemConfig(name="SM-WT-NC", topology="sm", l2_policy="wt",
                        protocol="none", **kw)


def sm_wt_halcone(**kw) -> SystemConfig:
    return SystemConfig(name="SM-WT-C-HALCONE", topology="sm", l2_policy="wt",
                        protocol="halcone", **kw)


ALL_CONFIGS = (rdma_wb_nc, rdma_wb_hmg, sm_wb_nc, sm_wt_nc, sm_wt_halcone)
