"""Parameter spec trees: one declaration drives real init and the cache
layout — the port's copy of ``repro.models.params`` (``P``,
``tree_paths``, ``stack_specs``, ``materialize``, ``pspecs``,
``count_params``, and ``abstract`` as meta tensors), with
``shard_params`` and ``materialize_shard`` for a rank of a mesh.

``materialize`` seeds each leaf from the caller's generator and a stable
hash of the leaf's path (``zlib.crc32``).  The reference folds Python's
``hash(path)`` into its key, which is randomised per process, so its init
differs from run to run; tests therefore carry weights across
(``models.convert``) instead of comparing inits.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Tuple

import torch

from repro_torch.sharding import local_shard, partition_spec


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axes + init rule."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | fan_in | a_log
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _is_leaf(x):
    return isinstance(x, P)


def tree_paths(spec, prefix=""):
    if _is_leaf(spec):
        yield prefix, spec
        return
    for k in sorted(spec):
        yield from tree_paths(spec[k], f"{prefix}/{k}")


def map_with_path(spec, fn, prefix=""):
    if _is_leaf(spec):
        return fn(prefix, spec)
    return {k: map_with_path(v, fn, f"{prefix}/{k}") for k, v in spec.items()}


def leaf_seed(base: int, path: str) -> int:
    """The seed of one leaf: the caller's seed and the path's CRC-32."""
    return (base * 0x9E3779B1 + zlib.crc32(path.encode())) % (2 ** 63)


def _draw(path: str, p: P, base: int, dev, dtype):
    """One leaf as ``materialize`` draws it."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=dev)
    g = torch.Generator(dev).manual_seed(leaf_seed(base, path))
    if p.init == "a_log":   # mamba2 A in (-1, 0): A = -exp(A_log)
        u = torch.rand(p.shape, generator=g, dtype=dtype, device=dev)
        return torch.log(1.0 + 15.0 * u)
    x = torch.randn(p.shape, generator=g, dtype=dtype, device=dev)
    if p.init == "fan_in":
        fan = p.shape[0] if len(p.shape) > 1 else 1
        return x / math.sqrt(max(1, fan))
    return x * p.scale


def materialize(spec, gen: torch.Generator, dtype=torch.float32):
    """Real tensors on ``gen``'s device, each leaf drawn from its own
    generator seeded by ``leaf_seed(gen.initial_seed(), path)``, so a
    leaf's values depend on the seed and its path only."""
    base, dev = gen.initial_seed(), gen.device
    return map_with_path(spec, lambda path, p: _draw(path, p, base, dev,
                                                     dtype))


def abstract(spec, dtype=torch.float32, shapes=None):
    """The tree as meta tensors, with shapes and dtypes and no memory (the
    dry run's inputs).  ``shapes`` (a tree of shapes over the same keys)
    overrides each leaf's global shape, e.g. with a rank's shard's."""

    def walk(sp, sh):
        if isinstance(sp, P):
            return torch.empty(sp.shape if sh is None else sh, dtype=dtype,
                               device="meta")
        return {k: walk(sp[k], None if sh is None else sh[k]) for k in sp}

    return walk(spec, shapes)


def count_params(spec) -> int:
    return sum(math.prod(p.shape) for _, p in tree_paths(spec))


def pspecs(spec, mesh, rules=None):
    """Every leaf's partition spec under ``mesh`` (a tree of
    ``sharding.partition_spec`` tuples of ``spec``'s structure)."""
    return map_with_path(
        spec, lambda _, p: partition_spec(mesh, p.shape, p.axes, rules))


def shard_params(params, specs, mesh):
    """This rank's slice of every leaf of a global tree under ``specs``
    (a tree of spec tuples over the same keys), each a contiguous tensor
    of its own; a leaf whose spec is () is kept as it is."""
    if isinstance(params, dict):
        return {k: shard_params(params[k], specs[k], mesh) for k in params}
    return local_shard(params, specs, mesh).clone() if specs else params


def materialize_shard(spec, specs, gen: torch.Generator, mesh,
                      dtype=torch.float32):
    """``shard_params(materialize(spec, gen, dtype), specs, mesh)``, one
    leaf at a time: each leaf is drawn whole, as ``materialize`` draws it,
    and only this rank's slice is kept, so no more than one whole leaf is
    resident at once (deepseek-v2's expert stacks are 2.5 GB each)."""
    base, dev = gen.initial_seed(), gen.device

    def walk(sp, sh, path):
        if isinstance(sp, P):
            x = _draw(path, sp, base, dev, dtype)
            return local_shard(x, sh, mesh).clone() if sh else x
        return {k: walk(sp[k], sh[k], f"{path}/{k}") for k in sp}

    return walk(spec, specs, "")


def stack_specs(spec, n: int):
    """Prepend a 'stack' dim of size n to every leaf in the subtree."""
    def leaf(_, p: P):
        return P((n,) + p.shape, ("stack",) + p.axes, p.init, p.scale)
    return map_with_path(spec, leaf)
