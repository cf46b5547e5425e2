"""Open-loop load generation: bounded-Zipf key popularity + arrival
processes + recordable request traces.

The PyTorch port's copy of ``repro.runtime.loadgen`` (numpy only), kept
identical so both packages replay a trace the same way.

Every closed-loop driver in ``benchmarks/`` forms its next batch only
after the previous one returns — the workload shape the paper benchmarks,
but not what a serving stack sees.  This module synthesizes (or replays)
*arrival-timestamped* request streams: each request is a (t_arrive,
key_id) pair, keys drawn from a properly **bounded** Zipf and timestamps
from Poisson / diurnal / bursty processes.  ``runtime/scheduler.py``
replays a trace open-loop against a ``FabricBackend``;
``benchmarks/replay_bench.py`` sweeps offered load and reports
p50/p95/p99 + SLO goodput (BENCH_serving.json).

Bounded Zipf: ``numpy``'s ``rng.zipf(a)``
samples the UNBOUNDED Zipf distribution; the previously idiomatic
``rng.zipf(a) % n`` wraps the infinite tail back onto ``[0, n)``, which
silently FLATTENS the skew — rank 0 receives every tail sample that is
``0 mod n``, rank 1 every ``1 mod n``, and so on, so the wrapped pmf is
the true head pmf plus an almost-uniform wrap term.  ``BoundedZipf``
instead samples the *truncated* distribution exactly: pmf(k) ∝ 1/(k+1)^a
on ranks ``0..n-1`` via inverse-CDF over the precomputed normalized
weights.  Everything in this repo that draws skewed keys goes through it
(``benchmarks/fabric_bench.py``, ``data/pipeline.py``).

This module is numpy-only (no jax) so traces can be generated/loaded in
drivers, tests, and CI without touching the device runtime.
"""
from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Dict, Optional, Union

import numpy as np


# ----------------------------------------------------------- key popularity
class BoundedZipf:
    """Exact truncated Zipf over ranks ``0..n-1``: pmf(k) ∝ 1/(k+1)^a.

    Inverse-CDF sampling over the precomputed normalized weight table —
    no unbounded tail, no modulo wrap, O(log n) per draw.
    """

    def __init__(self, n: int, a: float = 1.5):
        if n < 1:
            raise ValueError(f"need n >= 1 ranks, got {n}")
        if a <= 0:
            raise ValueError(f"need skew a > 0, got {a}")
        self.n, self.a = int(n), float(a)
        w = np.arange(1, self.n + 1, dtype=np.float64) ** -self.a
        self._pmf = w / w.sum()
        self._cdf = np.cumsum(self._pmf)
        self._cdf[-1] = 1.0                    # guard fp round-down

    def pmf(self) -> np.ndarray:
        """Exact probability of each rank, [n] float64 (sums to 1)."""
        return self._pmf.copy()

    def sample(self, rng: np.random.Generator,
               size: Optional[int] = None) -> Union[int, np.ndarray]:
        """Draw ranks in ``[0, n)``; scalar int when ``size`` is None."""
        u = rng.random(size)
        out = np.searchsorted(self._cdf, u, side="right").astype(np.int64)
        return int(out) if size is None else out


@functools.lru_cache(maxsize=64)
def bounded_zipf(n: int, a: float = 1.5) -> BoundedZipf:
    """Memoized ``BoundedZipf`` — callers that draw per-item (e.g. the
    synthetic-corpus doc generator) amortize the CDF build."""
    return BoundedZipf(n, a)


# --------------------------------------------------------- arrival processes
def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """Homogeneous Poisson: iid exponential gaps at ``rate`` req/s."""
    if rate <= 0:
        raise ValueError(f"need rate > 0, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def diurnal_arrivals(rng: np.random.Generator, n: int, rate: float,
                     period_s: Optional[float] = None,
                     amplitude: float = 0.85,
                     cycles: float = 3.0) -> np.ndarray:
    """Inhomogeneous Poisson with a sinusoidal (day/night) rate:
    ``rate(t) = rate * (1 + amplitude*sin(2π t/period))`` — peaks at
    ``(1+A)x`` the mean, troughs at ``(1-A)x``.  Generated sequentially
    (each gap drawn at the current instantaneous rate), which is the
    standard piecewise approximation and exact in the period >> gap
    regime the bench runs in.  Default period spans ``cycles`` full
    day/night swings over the n requests."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"need 0 <= amplitude < 1, got {amplitude}")
    if period_s is None:
        period_s = n / (rate * cycles)
    t, out = 0.0, np.empty(n, np.float64)
    gaps = rng.exponential(1.0, size=n)        # unit-rate, rescaled per gap
    w = 2.0 * np.pi / period_s
    for i in range(n):
        lam = rate * (1.0 + amplitude * np.sin(w * t))
        t += gaps[i] / max(lam, 1e-12)
        out[i] = t
    return out


def burst_arrivals(rng: np.random.Generator, n: int, rate: float,
                   burst: float = 8.0, p_burst: float = 0.02,
                   mean_burst_len: int = 32) -> np.ndarray:
    """Markov-modulated Poisson (flash crowds): a two-state chain flips
    between the base ``rate`` and ``burst * rate``; bursts start with
    probability ``p_burst`` per arrival and last ``mean_burst_len``
    arrivals in expectation (geometric)."""
    if burst < 1.0:
        raise ValueError(f"need burst >= 1, got {burst}")
    p_exit = 1.0 / max(mean_burst_len, 1)
    gaps = rng.exponential(1.0, size=n)
    flips = rng.random(n)
    t, hot, out = 0.0, False, np.empty(n, np.float64)
    for i in range(n):
        hot = (flips[i] >= p_exit) if hot else (flips[i] < p_burst)
        t += gaps[i] / (rate * burst if hot else rate)
        out[i] = t
    return out


PROCESSES = {"poisson": poisson_arrivals, "diurnal": diurnal_arrivals,
             "burst": burst_arrivals}


# ------------------------------------------------------------ request traces
@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """An arrival-timestamped key stream: request ``i`` asks for key
    ``kid[i]`` at ``t[i]`` seconds (nondecreasing float64).  ``n_keys``
    bounds the key-id space (kids are ranks of the popularity law)."""

    t: np.ndarray                 # [n] float64, nondecreasing
    kid: np.ndarray               # [n] int32 in [0, n_keys)
    n_keys: int
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if len(self.t) != len(self.kid):
            raise ValueError("t and kid length mismatch")
        if len(self.t) and np.any(np.diff(self.t) < 0):
            raise ValueError("arrival timestamps must be nondecreasing")
        if len(self.kid) and (self.kid.min() < 0
                              or self.kid.max() >= self.n_keys):
            raise ValueError("key ids out of [0, n_keys)")

    def __len__(self) -> int:
        return len(self.t)

    @property
    def offered_rps(self) -> float:
        """Mean offered load of the trace as recorded."""
        return len(self.t) / max(float(self.t[-1]), 1e-12)

    def scaled(self, factor: float) -> "RequestTrace":
        """Rescale the TIME axis only (t/factor → factor x the offered
        rate).  The key sequence is untouched, so every offered-load
        point in a sweep replays the IDENTICAL key stream — the property
        the Fig-10 decomposition's 'same key stream' comparison needs."""
        if factor <= 0:
            raise ValueError(f"need factor > 0, got {factor}")
        return dataclasses.replace(
            self, t=self.t / factor,
            meta={**self.meta, "scaled_by": factor})

    # ----------------------------------------------------- record / replay
    def save(self, path) -> None:
        """Record the trace (npz) for later replay."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, t=self.t, kid=self.kid,
                            n_keys=np.int64(self.n_keys),
                            meta=np.frombuffer(
                                repr(self.meta).encode(), dtype=np.uint8))

    @staticmethod
    def load(path) -> "RequestTrace":
        with np.load(pathlib.Path(path)) as z:
            meta = {}
            if "meta" in z:
                import ast
                try:
                    meta = ast.literal_eval(bytes(z["meta"]).decode())
                except (ValueError, SyntaxError):
                    meta = {}
            return RequestTrace(t=z["t"].astype(np.float64),
                                kid=z["kid"].astype(np.int32),
                                n_keys=int(z["n_keys"]), meta=meta)


def synthesize(n_requests: int, n_keys: int, *, a: float = 1.2,
               process: str = "poisson", rate: float = 1.0,
               seed: int = 0, **proc_kw) -> RequestTrace:
    """One call = one million-user-shaped stream: ``n_requests`` keys from
    ``BoundedZipf(n_keys, a)`` with arrival timestamps from the named
    process at mean ``rate`` req/s.  Deterministic in ``seed``."""
    if process not in PROCESSES:
        raise ValueError(f"unknown process {process!r}; "
                         f"one of {sorted(PROCESSES)}")
    rng = np.random.default_rng(seed)
    t = PROCESSES[process](rng, n_requests, rate, **proc_kw)
    kid = BoundedZipf(n_keys, a).sample(rng, size=n_requests)
    return RequestTrace(
        t=np.asarray(t, np.float64), kid=kid.astype(np.int32),
        n_keys=n_keys,
        meta={"process": process, "rate": rate, "a": a, "seed": seed,
              **proc_kw})
