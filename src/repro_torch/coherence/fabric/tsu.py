"""The fabric's configuration, grant record and key hash.

Copied byte for byte from ``repro.coherence.fabric.tsu`` (``FabricConfig``,
``LeaseGrant``, ``stable_hash``) so keys route to the same shards and sets
in both packages.  The host-object TSU (``TSUShard``/``TSUFabric``) stays
in ``repro`` as the oracle the tests drive.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, NamedTuple, Optional


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


def stable_hash(key) -> int:
    """Process-independent key hash (python's hash() is salted per run)."""
    if not isinstance(key, bytes):
        key = str(key).encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "big")
