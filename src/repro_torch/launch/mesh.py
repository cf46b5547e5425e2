"""The coherence fabric's process group: the counterpart of
``repro.launch.mesh.make_fabric_mesh``.

A function, never a module-level constant, so importing this module
never touches ``torch.distributed`` state.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def fabric_ranks(n_shards: int, ranks: Sequence[int]) -> list:
    """The ranks the fabric spreads over: the LARGEST leading run of
    ``ranks`` whose length divides ``n_shards``, so every rank owns an
    equal contiguous run of shards and shard ``s`` lives on rank
    ``s // (n_shards / D)``."""
    d = len(ranks)
    while d > 1 and n_shards % d:
        d -= 1
    return list(ranks[:d])


def make_fabric_group(n_shards: int, backend: Optional[str] = None,
                      ranks: Optional[Sequence[int]] = None):
    """The 1-axis fabric group over the initialised default group: TSU
    shard ``s`` lives on group rank ``s // (n_shards / D)``, D the largest
    count of ``ranks`` (default: every rank) that divides ``n_shards``.
    With one rank it degenerates to a group of one.

    ``backend`` follows the device by default: NCCL when CUDA is
    available, gloo on the CPU.  An explicit ``backend="gloo"`` carries
    CUDA tensors too (two ranks on one card, which NCCL refuses).  The
    group never switches backend on an error.  Like
    ``torch.distributed.new_group``, every rank of the world must call it;
    a rank outside the group gets ``GroupMember.NON_GROUP_MEMBER``.  When
    the group is the whole world on the default group's backend, the
    default group itself is returned."""
    if not dist.is_initialized():
        raise RuntimeError("make_fabric_group needs an initialised "
                           "torch.distributed default group")
    world = list(range(dist.get_world_size()))
    members = fabric_ranks(n_shards, world if ranks is None else list(ranks))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if members == world and backend == dist.get_backend():
        return dist.group.WORLD
    return dist.new_group(members, backend=backend)
