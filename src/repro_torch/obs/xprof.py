"""Collective accounting at the ``c10d`` layer: the counterpart of
``repro.obs.xprof.jaxpr_collectives``.

The reference counts collective primitives in a traced jaxpr; the port
runs eagerly, so ``collective_counts(fn, *args)`` runs the call and
counts the ``c10d`` operators it issues (``c10d.allgather_``,
``c10d.broadcast_``, ...) as the dispatcher sees them, under a
``TorchDispatchMode`` — not through a counter the fabric keeps itself.
The mode sees every operator of the call, so a counted call runs slower;
nothing on the fabric's path imports this module.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Tuple

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["collective_counts"]


class _C10dCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_op: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            self.by_op[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def collective_counts(fn, *args, **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` and count the ``c10d`` collectives it
    issues.  Returns ``(result, {"total": n, "by_op": {name: n}})``; an
    asynchronous collective counts where it is issued."""
    with _C10dCounter() as mode:
        out = fn(*args, **kwargs)
    by_op = dict(mode.by_op)
    return out, {"total": sum(by_op.values()), "by_op": by_op}
