"""Continuous deadline-driven batch formation + open-loop trace replay.

The PyTorch port's copy of ``repro.runtime.scheduler`` (numpy only), kept
identical so both packages replay a trace the same way.

``Server`` and every fabric bench form FIXED-SIZE waves: the next batch
exists only when enough requests are already in hand, so a trickle of
arrivals either starves waiting for the wave to fill or is served in
tiny batches that waste the one-collective grant pipeline.  This module
replaces that with **admit-by-deadline** formation driven by a
``loadgen.RequestTrace``'s arrival timestamps:

  * requests accumulate in an arrival queue;
  * a wave fires when it reaches ``max_batch`` (full fire) OR when the
    oldest queued request has waited ``max_wait_s`` (deadline fire) —
    under ``mode="fixed"`` only full fires happen (plus one final
    partial wave when the stream ends), which is exactly the old
    fixed-size-wave behavior, kept as the measured baseline;
  * in-flight waves overlap through the fabric's existing
    ``read_batch_async`` boundary with ``serve_stream``'s schedule —
    wave N+1 is FORMED (admission bookkeeping, host work) while wave N's
    device batch is in flight, and N resolves before N+1 dispatches, so
    at most one handle is ever outstanding and the backend's ordering
    contract (resolve before the next write/fence) holds by
    construction;
  * formed waves are padded onto POW2 SHAPE BUCKETS
    (``max(min_bucket, next_pow2(b))``, pads cycle the wave's own keys,
    pad results discarded) so variable batch sizes never touch the
    jit recompile path — the fabric's phase-1 probe is shape-specialized
    on the key-vector length.

The replay clock is VIRTUAL: it advances by the measured wall of each
fabric call and jumps across idle gaps, so a trace recorded at any rate
replays open-loop — arrivals land at trace time whether or not the
fabric keeps up, and per-request latency = resolve time − arrival time
measures queueing honestly (the closed-loop drivers can't).  Passing
``service_model`` replaces measured walls with a deterministic cost
function — replays become exactly reproducible (tests, and the
continuous-vs-fixed property is provable there rather than flaky).

``form_waves`` is the Server integration: the same firing rules applied
arrival-only (no service feedback), yielding variable-size waves for
``Server.serve_stream`` in place of its fixed-size grouping.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.loadgen import RequestTrace


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Wave-formation policy.

    mode        "continuous" (max-batch OR deadline fires) or "fixed"
                (full waves only + one final partial — the old Server
                behavior, the measured baseline)
    max_batch   wave size cap (a full queue fires immediately)
    max_wait_s  deadline budget: the oldest queued request never waits
                longer than this before its wave fires (continuous only)
    bucket      pad waves onto pow2 shape buckets (recompile-free)
    min_bucket  smallest bucket (matches the fabric's apply() floor)
    """

    mode: str = "continuous"
    max_batch: int = 64
    max_wait_s: float = 5e-3
    bucket: bool = True
    min_bucket: int = 8

    def __post_init__(self):
        if self.mode not in ("continuous", "fixed"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")


def pad_to_bucket(keys: Sequence, policy: BatchPolicy) -> List:
    """Pad a formed wave to its pow2 shape bucket by cycling the wave's
    own keys (no new keys → no spurious compulsory misses); callers
    discard the pad rows' results."""
    if not policy.bucket or not keys:
        return list(keys)
    m = max(policy.min_bucket, _next_pow2(len(keys)))
    return [keys[j % len(keys)] for j in range(m)]


@dataclasses.dataclass
class ReplayResult:
    """One open-loop replay: per-request latencies + wave telemetry +
    the exact served event stream (for the Fig-10 engine decomposition)."""

    latency_s: np.ndarray         # [n] seconds, resolve − arrival
    t_end: float                  # virtual makespan (last resolve)
    batch_sizes: List[int]        # real (pre-pad) wave sizes
    padded_sizes: List[int]       # bucketed sizes actually probed
    fires: Dict[str, int]         # full / deadline / final counts
    walls: Dict[str, float]       # dispatch / resolve / republish seconds
    events: List[Tuple]           # ("read", kids) | ("write", kids) |
                                  # ("fence",) in served order, pads incl.

    @property
    def n_requests(self) -> int:
        return len(self.latency_s)

    def goodput(self, slo_s: float) -> Tuple[int, float]:
        """(# completions meeting the SLO, attained fraction)."""
        ok = int(np.sum(self.latency_s <= slo_s))
        return ok, ok / max(len(self.latency_s), 1)


def replay(backend, trace: RequestTrace, policy: BatchPolicy, *,
           replica: int = 1, writer: int = 0,
           key_of: Optional[Callable[[int], str]] = None,
           republish_every: int = 0, republish_n: int = 16,
           service_model: Optional[Callable[[int], float]] = None,
           ) -> ReplayResult:
    """Replay ``trace`` open-loop against a ``FabricBackend``.

    A model-refresh write storm (``republish_n`` keys round-robin) +
    fence precedes the first wave and then every ``republish_every``
    SERVED REQUESTS — the outstanding read handle resolves first
    (ordering contract), and the republish keeps reader leases churning
    so replayed traffic carries real per-link bytes for the Fig-10
    decomposition instead of a pure replica-tier hit stream.  The
    cadence is per-request, not per-wave, on purpose: continuous mode
    fires more, smaller waves than fixed mode at the same offered load,
    and a per-wave cadence would bill it proportionally more storm
    overhead — an unfair comparison between the two policies.

    ``service_model(padded_size) -> seconds`` makes the virtual clock
    deterministic (fabric calls still execute; only their time charge is
    modeled).  Default: measured wall clock.
    """
    key_of = key_of or (lambda k: f"prefix/{k}")
    t_arr, kids, n = trace.t, trace.kid, len(trace)
    q: collections.deque = collections.deque()   # admitted request indices
    i = 0                                        # next unadmitted arrival
    now = 0.0
    done = np.full(n, np.nan)
    pending: Optional[Tuple[List[int], object]] = None
    events: List[Tuple] = []
    batch_sizes: List[int] = []
    padded_sizes: List[int] = []
    fires = {"full": 0, "deadline": 0, "final": 0}
    walls = {"dispatch_s": 0.0, "resolve_s": 0.0, "republish_s": 0.0}
    n_waves = served = next_storm_at = n_storms = 0

    def timed(fn, modeled: float) -> float:
        t0 = time.perf_counter()
        fn()
        w = time.perf_counter() - t0
        return w if service_model is None else modeled

    def admit() -> None:
        nonlocal i
        while i < n and t_arr[i] <= now:
            q.append(i)
            i += 1

    def resolve_pending() -> None:
        nonlocal pending, now
        members, handle = pending
        w = timed(handle.result, 0.0)
        now += w
        walls["resolve_s"] += w
        for r in members:
            done[r] = now
        pending = None

    def try_fire() -> Optional[Tuple[List[int], str]]:
        if not q:
            return None
        if len(q) >= policy.max_batch:
            kind = "full"
        elif (policy.mode == "continuous"
              and now - t_arr[q[0]] >= policy.max_wait_s - 1e-12):
            kind = "deadline"
        elif i >= n and pending is None:
            kind = "final"                       # end-of-stream drain
        else:
            return None
        take = min(len(q), policy.max_batch)
        return [q.popleft() for _ in range(take)], kind

    def next_fire_time() -> Optional[float]:
        """Earliest virtual time a wave can fire, absent service."""
        cands = []
        if policy.mode == "continuous":
            if q:
                cands.append(t_arr[q[0]] + policy.max_wait_s)
            elif i < n:
                cands.append(t_arr[i] + policy.max_wait_s)
        need = policy.max_batch - len(q)
        if i + need - 1 < n:
            cands.append(t_arr[i + need - 1])    # the wave-filling arrival
        elif i < n:
            cands.append(t_arr[n - 1])           # last arrival → final drain
        return min(cands) if cands else None

    while True:
        admit()
        fired = try_fire()
        if fired is None:
            if pending is not None:
                resolve_pending()                # drain the in-flight wave
                continue
            nft = next_fire_time()
            if nft is None:
                break
            now = max(now, nft)                  # idle: jump the clock
            continue
        members, kind = fired
        fires[kind] += 1
        if republish_every and served >= next_storm_at:
            if pending is not None:
                resolve_pending()                # handle before write/fence
            sl = [(n_storms * republish_n + j)
                  % trace.n_keys for j in range(republish_n)]
            w = timed(
                lambda: (backend.write_batch(
                    [(key_of(k), f"v@{n_waves}") for k in sl],
                    replica=writer), backend.fence()),
                service_model(len(sl)) if service_model else 0.0)
            now += w
            walls["republish_s"] += w
            events.append(("write", sl))
            events.append(("fence",))
            n_storms += 1
            next_storm_at += republish_every
        ks = [int(kids[r]) for r in members]
        padded = pad_to_bucket(ks, policy)
        if pending is not None:
            resolve_pending()                    # N resolves before N+1
        holder = {}
        w = timed(
            lambda: holder.update(h=backend.read_batch_async(
                [key_of(k) for k in padded], replica=replica)),
            service_model(len(padded)) if service_model else 0.0)
        now += w
        walls["dispatch_s"] += w
        events.append(("read", list(padded)))
        batch_sizes.append(len(ks))
        padded_sizes.append(len(padded))
        pending = (members, holder["h"])
        n_waves += 1
        served += len(members)
    if pending is not None:
        resolve_pending()

    assert not np.isnan(done).any(), "replay lost requests"
    return ReplayResult(latency_s=done - t_arr, t_end=now,
                        batch_sizes=batch_sizes, padded_sizes=padded_sizes,
                        fires=fires, walls=walls, events=events)


def form_waves(t_arrive: Sequence[float], items: Sequence,
               policy: BatchPolicy) -> List[List]:
    """Arrival-driven wave formation only (no service feedback): group
    timestamped ``items`` into waves under the policy's firing rules.
    This is the ``Server`` integration — feed the result straight to
    ``Server.serve_stream`` in place of fixed-size request waves (the
    stream path pads each wave into decode groups itself and tolerates
    empty/partial/non-pow2 waves)."""
    t = np.asarray(t_arrive, np.float64)
    if len(t) != len(items):
        raise ValueError("t_arrive and items length mismatch")
    if len(t) and np.any(np.diff(t) < 0):
        raise ValueError("arrival timestamps must be nondecreasing")
    waves: List[List] = []
    q: collections.deque = collections.deque()
    i, n, now = 0, len(items), 0.0
    while i < n or q:
        while i < n and t[i] <= now:
            q.append(i)
            i += 1
        if len(q) >= policy.max_batch:
            waves.append([items[q.popleft()]
                          for _ in range(policy.max_batch)])
            continue
        if q and ((policy.mode == "continuous"
                   and now - t[q[0]] >= policy.max_wait_s - 1e-12)
                  or i >= n):
            waves.append([items[q.popleft()] for _ in range(len(q))])
            continue
        cands = []
        if policy.mode == "continuous":
            if q:
                cands.append(t[q[0]] + policy.max_wait_s)
            elif i < n:                  # next arrival's own deadline —
                cands.append(t[i] + policy.max_wait_s)   # never skip it
        need = policy.max_batch - len(q)
        cands.append(t[min(i + need - 1, n - 1)])
        now = max(now, min(cands))
    return waves
