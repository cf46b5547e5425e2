"""MetricsRegistry: per-(fabric, scenario) histograms + FabricStats deltas
— the port's copy of ``repro.obs.registry``.

The fabric's counter block (``FabricStats`` / ``backend.stats()``) is
cumulative over a backend's lifetime; benchmark scenarios and — per the
ROADMAP's multi-tenant item — per-tenant accounting need *windows*: what
did THIS scenario/batch/tenant add?  The registry layers exactly that on
top without touching the fabric:

  * ``histogram(key, phase)`` — get-or-create a ``LatencyHistogram``
    under an arbitrary hashable key (the convention is a ``(fabric_name,
    scenario)`` tuple; a tenant id slots in as a third element unchanged).
  * ``snapshot(key, stats)`` — capture a counter block (a dict, or any
    object with ``.stats()`` — every port ``FabricBackend`` qualifies).
  * ``delta(key, stats)`` — counters accumulated since the last snapshot
    for ``key``; by default advances the snapshot so successive deltas
    tile the timeline without gaps or double counting.

``summary()`` flattens everything into one JSON-able dict, the shape the
benchmark writes next to its throughput rows.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Optional, Tuple

from repro_torch.obs.metrics import LatencyHistogram

__all__ = ["MetricsRegistry"]


def _stats_dict(stats: Any) -> Dict[str, int]:
    """Accept a plain counter dict or anything with ``.stats()`` (the
    ``FabricBackend`` surface)."""
    if hasattr(stats, "stats") and callable(stats.stats):
        stats = stats.stats()
    if not isinstance(stats, dict):
        raise TypeError(f"expected a counter dict or a backend, "
                        f"got {type(stats).__name__}")
    return dict(stats)


def _key_str(key: Hashable) -> str:
    if isinstance(key, tuple):
        return "/".join(str(k) for k in key)
    return str(key)


class MetricsRegistry:
    """Windowed metrics over cumulative fabric counters + phase latency."""

    def __init__(self, **hist_kwargs):
        self._hist_kwargs = hist_kwargs
        self._hists: Dict[Tuple[Hashable, str], LatencyHistogram] = {}
        self._snaps: Dict[Hashable, Dict[str, int]] = {}

    # ---------------------------------------------------------- histograms
    def histogram(self, key: Hashable,
                  phase: str = "total") -> LatencyHistogram:
        h = self._hists.get((key, phase))
        if h is None:
            h = self._hists[(key, phase)] = LatencyHistogram(
                **self._hist_kwargs)
        return h

    def observe(self, key: Hashable, phase: str, seconds: float) -> None:
        self.histogram(key, phase).record(seconds)

    # ---------------------------------------------------------- snapshots
    def snapshot(self, key: Hashable, stats: Any) -> Dict[str, int]:
        """Capture the cumulative counter block for ``key``; returns the
        captured copy.  The next ``delta(key, ...)`` is relative to it."""
        snap = _stats_dict(stats)
        self._snaps[key] = snap
        return dict(snap)

    def delta(self, key: Hashable, stats: Any,
              advance: bool = True) -> Dict[str, int]:
        """Counters accumulated since ``key``'s last snapshot.  Counters
        with no prior snapshot diff against zero (a fresh backend's delta
        is its whole block).  ``advance=True`` (default) re-snapshots so
        back-to-back deltas partition the timeline."""
        now = _stats_dict(stats)
        base = self._snaps.get(key, {})
        d = {k: v - base.get(k, 0) for k, v in now.items()}
        if advance:
            self._snaps[key] = now
        return d

    def last_snapshot(self, key: Hashable) -> Optional[Dict[str, int]]:
        snap = self._snaps.get(key)
        return dict(snap) if snap is not None else None

    # ------------------------------------------------------------ export
    def summary(self) -> Dict[str, Dict[str, Any]]:
        """``{key: {"latency": {phase: histogram summary},
        "counters": last snapshot}}`` — one JSON-able block."""
        out: Dict[str, Dict[str, Any]] = {}
        for (key, phase), h in self._hists.items():
            out.setdefault(_key_str(key), {}).setdefault(
                "latency", {})[phase] = h.summary()
        for key, snap in self._snaps.items():
            out.setdefault(_key_str(key), {})["counters"] = dict(snap)
        return out
