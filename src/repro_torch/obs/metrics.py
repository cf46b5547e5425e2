"""Latency histograms: log-bucketed shape, exact percentile summaries —
the port's copy of ``repro.obs.metrics`` (numpy only).

``LatencyHistogram`` records durations in seconds and serves two readers:

  * **log buckets** — geometric bucket boundaries (default 1µs · 2^k, 40
    buckets ≈ 1µs..10min) for cheap export/merge and long-horizon shape;
    the bucket layer is what a future per-tenant split aggregates over.
  * **exact percentiles** — samples are additionally retained (bounded by
    ``sample_cap``) so ``percentile(p)`` matches ``numpy.percentile``
    bit-for-bit up to the cap (tests/test_torch_obs_metrics.py); past the cap
    it degrades to log-linear interpolation inside the bucket, which is
    the standard histogram-quantile estimate and is flagged by
    ``summary()["exact"] = False``.

Benchmark rows report ``p50/p95/p99`` from this class, so a latency
tail — the thing an SLO cares about — cannot hide behind a good median.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Log-bucketed latency histogram over seconds."""

    def __init__(self, base: float = 1e-6, growth: float = 2.0,
                 n_buckets: int = 40, sample_cap: int = 65536):
        if base <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("need base > 0, growth > 1, n_buckets >= 2")
        self._bounds = base * growth ** np.arange(n_buckets, dtype=np.float64)
        self._counts = np.zeros(n_buckets + 1, np.int64)   # +1: overflow
        self._samples: List[float] = []
        self._cap = sample_cap
        self.count = 0
        self.sum_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    # ------------------------------------------------------------- record
    def record(self, seconds: float) -> None:
        s = float(seconds)
        if s < 0:
            raise ValueError(f"negative latency {s}")
        self.count += 1
        self.sum_s += s
        self.min_s = min(self.min_s, s)
        self.max_s = max(self.max_s, s)
        self._counts[int(np.searchsorted(self._bounds, s, side="left"))] += 1
        if len(self._samples) < self._cap:
            self._samples.append(s)

    def record_many(self, seconds: Iterable[float]) -> "LatencyHistogram":
        for s in seconds:
            self.record(s)
        return self

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if not np.array_equal(self._bounds, other._bounds):
            raise ValueError("bucket layouts differ")
        self._counts += other._counts
        self.count += other.count
        self.sum_s += other.sum_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)
        room = self._cap - len(self._samples)
        self._samples.extend(other._samples[:room])
        return self

    # ------------------------------------------------------------- views
    @property
    def exact(self) -> bool:
        """True while every recorded sample is retained — percentiles are
        then numpy-exact rather than bucket-interpolated."""
        return len(self._samples) == self.count

    def buckets(self) -> List[Tuple[float, int]]:
        """``[(le_seconds, cumulative_count)]`` rows, Prometheus-style;
        the final row is ``(inf, count)``."""
        cum = np.cumsum(self._counts)
        rows = [(float(b), int(c)) for b, c in zip(self._bounds, cum[:-1])]
        rows.append((float("inf"), int(cum[-1])))
        return rows

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> seconds.  Exact (``numpy.percentile`` with the
        default linear interpolation) while samples are retained;
        log-linear within-bucket interpolation past the cap."""
        if self.count == 0:
            return 0.0
        if self.exact:
            return float(np.percentile(np.asarray(self._samples), p))
        # bucket-interpolated fallback: find the bucket holding rank r
        cum = np.cumsum(self._counts)
        r = (p / 100.0) * (self.count - 1)
        i = int(np.searchsorted(cum, r + 1, side="left"))
        i = min(i, len(self._bounds))
        lo = self._bounds[i - 1] if i > 0 else 0.0
        hi = self._bounds[i] if i < len(self._bounds) else self.max_s
        prev = cum[i - 1] if i > 0 else 0
        inside = max(int(self._counts[i]), 1)
        frac = (r + 1 - prev) / inside
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    def summary(self) -> Dict[str, float]:
        """The benchmark-row block: count, mean/p50/p95/p99/max in µs."""
        if self.count == 0:
            return {"count": 0, "mean_us": 0.0, "p50_us": 0.0,
                    "p95_us": 0.0, "p99_us": 0.0, "max_us": 0.0,
                    "exact": True}
        return {
            "count": self.count,
            "mean_us": round(self.sum_s / self.count * 1e6, 2),
            "p50_us": round(self.percentile(50) * 1e6, 2),
            "p95_us": round(self.percentile(95) * 1e6, 2),
            "p99_us": round(self.percentile(99) * 1e6, 2),
            "max_us": round(self.max_s * 1e6, 2),
            "exact": self.exact,
        }
