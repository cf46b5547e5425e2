"""Process groups: the coherence fabric's (the counterpart of
``repro.launch.mesh.make_fabric_mesh``) and the model's (data, model)
mesh (``make_production_mesh`` / ``make_host_mesh``).

Functions, never module-level constants, so importing this module never
touches ``torch.distributed`` state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of ``torch.distributed`` ranks: the counterpart of a
    ``jax.sharding.Mesh`` (``make_model_mesh``).  Rank ``r`` sits at the
    row-major coordinates of ``r`` in ``shape`` (``(data d, model m)`` for
    ``r = d * M + m``), the device order of ``jax.make_mesh``, so a rank
    holds the shard the reference's device ``r`` holds.  ``group(axes)``
    is the process group of the ranks that differ from this one only
    along ``axes`` (group rank = row-major index over ``axes``)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Any]
    backend: str

    def axis_size(self, axes: Sequence[str]) -> int:
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in axes)

    def group(self, axes: Sequence[str]):
        """The group along ``axes`` (in the mesh's axis order) through
        this rank; () is this rank alone (None)."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self.groups[key] if key else None


def axis_subsets(axis_names: Sequence[str]) -> List[Tuple[str, ...]]:
    """Every non-empty subset of the axes, each in the mesh's order: the
    order in which ``make_model_mesh`` makes their groups."""
    n = len(axis_names)
    subsets = [tuple(a for i, a in enumerate(axis_names) if bits >> i & 1)
               for bits in range(1, 1 << n)]
    return sorted(subsets, key=lambda s: (len(s),
                                          [axis_names.index(a) for a in s]))


def make_model_mesh(shape: Sequence[int],
                    axis_names: Sequence[str] = ("data", "model"),
                    backend: Optional[str] = None) -> Mesh:
    """The counterpart of ``repro.launch.mesh.make_production_mesh`` and
    ``make_host_mesh`` over the initialised default group, whose world
    size must be the product of ``shape``.  Makes one process group for
    every line of every subset of the axes; every rank creates all of
    them in one fixed order, as ``torch.distributed.new_group`` requires,
    and keeps those through itself.  ``backend`` follows
    ``make_fabric_group``'s rule: NCCL with CUDA, gloo on the CPU, an
    explicit ``"gloo"`` for ranks that share one card; it never switches
    on an error."""
    if not dist.is_initialized():
        raise RuntimeError("make_model_mesh needs an initialised "
                           "torch.distributed default group")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         "length")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups: Dict[Tuple[str, ...], Any] = {}
    for axes in axis_subsets(axis_names):
        dims = [axis_names.index(a) for a in axes]
        for members in _lines(shape, dims):
            if members == list(range(world)) \
                    and backend == dist.get_backend():
                g = dist.group.WORLD
            else:
                g = dist.new_group(members, backend=backend)
            if rank in members:
                groups[axes] = g
    return Mesh(axis_names, shape, coords, groups, backend)


def _lines(shape, dims) -> List[List[int]]:
    """The rank lists of the lines along ``dims``: one for each
    coordinate of the other dims (row-major), its ranks ascending."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    others = [d for d in range(len(shape)) if d not in dims]
    moved = np.moveaxis(ranks, others + dims, range(len(shape)))
    n = math.prod(shape[d] for d in dims)
    return [sorted(int(r) for r in row) for row in moved.reshape(-1, n)]
