"""Parameter spec trees: one declaration drives real init and the cache
layout — the port's copy of ``repro.models.params`` (``P``,
``tree_paths``, ``stack_specs``, ``materialize``).

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


def materialize(spec, gen: torch.Generator, dtype=torch.float32):
    """Real tensors on ``gen``'s device, each leaf drawn from its own
    generator seeded by ``leaf_seed(gen.initial_seed(), path)``, so a
    leaf's values depend on the seed and its path only."""
    base, dev = gen.initial_seed(), gen.device

    def leaf(path: str, p: P):
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

    return map_with_path(spec, leaf)


def stack_specs(spec, n: int):
    """Prepend a 'stack' dim of size n to every leaf in the subtree."""
    def leaf(_, p: P):
        return P((n,) + p.shape, ("stack",) + p.axes, p.init, p.scale)
    return map_with_path(spec, leaf)
