"""Low-overhead host-side span tracer with Chrome-trace export.

The port's copy of ``repro.obs.trace``.  The tracer wraps the fabric batch
lifecycle phases (``fabric.pack`` → ``fabric.fast_probe`` /
``fabric.scan`` → ``fabric.miss_pass`` / ``fabric.write_pass`` →
``fabric.decode``) and exports them as Chrome-trace JSON — openable in
``chrome://tracing`` / Perfetto.

Design constraints, in priority order:

  1. **Disabled is free.**  Tracing is OFF by default; a disabled
     ``span()`` call is one module-global load, one attribute check and a
     ``with`` on a shared no-op singleton — a few hundred nanoseconds
     against batch phases measured in hundreds of microseconds.  The <1%
     overhead gate (the paper's own bar) bounds this:
     spans-per-batch × disabled-span-cost must stay under 1% of the
     batched serving path's per-batch latency.  Disabled tracing also
     never fences: ``fence()`` returns its value untouched, so the
     async-dispatch pipeline is exactly the untraced one.
  2. **Spans are a strict stack.**  ``span()`` is a context manager; per
     thread, exits happen in reverse entry order, so the exported trace
     is always a well-formed forest (children strictly contained in their
     parents — schema-validated in tests).
  3. **Dispatch vs execute.**  CUDA launches return as soon as the work
     is enqueued.  ``fence(value, name)`` closes the gap: inside an
     enclosing phase span it opens a child span, runs
     ``torch.cuda.synchronize()``, and closes it — so the enclosing span's
     self-time is the launch cost and the child is the device execution
     tail.

Events are recorded as flat tuples on the hot path and only shaped into
Chrome-trace dicts at export time.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Tracer", "span", "fence", "instant", "enable", "disable",
           "get_tracer", "set_tracer", "disabled_span_cost_ns"]

# one event = (name, cat, tid, t0_ns, dur_ns, depth, args)
_Event = Tuple[str, str, int, int, int, int, Optional[Dict[str, Any]]]


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records entry/exit timestamps on the tracer."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0", "_depth")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        stack = self._tr._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        popped = self._tr._stack().pop()
        assert popped is self, "span exits out of order"
        self._tr._events.append(
            (self._name, self._cat, threading.get_ident(),
             self._t0, t1 - self._t0, self._depth, self._args))
        return False


class Tracer:
    """A span recorder; one per process is the norm (module default below).

    Thread-safe in the sense that each thread keeps its own span stack and
    event appends are atomic list ops; exported timestamps share one
    monotonic clock (``time.perf_counter_ns``).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: List[_Event] = []
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # ------------------------------------------------------------- record
    def span(self, name: str, cat: str = "fabric", **args):
        """Context manager timing one phase.  No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def fence(self, value, name: str = "device_execute",
              cat: str = "device"):
        """Block on ``value`` inside a child span — the device-execute
        tail of the enclosing dispatch span.  When disabled, returns the
        value untouched (no blocking: the untraced pipeline keeps its
        async dispatch)."""
        if not self.enabled:
            return value
        with _Span(self, name, cat, None):
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        return value

    def instant(self, name: str, cat: str = "fabric", **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        t = time.perf_counter_ns()
        self._events.append((name, cat, threading.get_ident(), t, 0,
                             len(self._stack()), args or None))

    # ------------------------------------------------------------- views
    @property
    def events(self) -> List[_Event]:
        return self._events

    def clear(self) -> None:
        self._events = []

    def phase_totals(self, prefix: str = "") -> Dict[str, Dict[str, float]]:
        """Aggregate inclusive time per span name: ``{name: {count,
        total_us}}``.  Inclusive means a parent's total contains its
        children's; names in the taxonomy are distinct per nesting level,
        so per-name sums stay interpretable."""
        out: Dict[str, Dict[str, float]] = {}
        for name, _cat, _tid, _t0, dur, _d, _a in self._events:
            if prefix and not name.startswith(prefix):
                continue
            row = out.setdefault(name, {"count": 0, "total_us": 0.0})
            row["count"] += 1
            row["total_us"] += dur / 1e3
        for row in out.values():
            row["total_us"] = round(row["total_us"], 1)
        return out

    # ------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome-trace JSON object: complete ("ph": "X")
        events with microsecond ``ts``/``dur`` on the shared monotonic
        clock, one ``pid``, real thread ids."""
        pid = os.getpid()
        events = []
        for name, cat, tid, t0, dur, _depth, args in self._events:
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": "X",
                "ts": t0 / 1e3, "dur": dur / 1e3,
                "pid": pid, "tid": tid,
            }
            if args:
                ev["args"] = args
            events.append(ev)
        events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"tracer": "repro_torch.obs.trace"}}

    def export(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), indent=1))
        return path


# ------------------------------------------------------- module-level default
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests, scoped captures); returns the old."""
    global _tracer
    old, _tracer = _tracer, tracer
    return old


def enable() -> Tracer:
    _tracer.enabled = True
    return _tracer


def disable() -> Tracer:
    _tracer.enabled = False
    return _tracer


def span(name: str, cat: str = "fabric", **args):
    """Module-level span on the process tracer — the instrumentation entry
    point the fabric/server/engine call sites use.  Disabled path: one
    global load + one attribute check + a shared no-op ``with``."""
    tr = _tracer
    if not tr.enabled:
        return _NULL_SPAN
    return _Span(tr, name, cat, args or None)


def fence(value, name: str = "device_execute", cat: str = "device"):
    tr = _tracer
    if not tr.enabled:
        return value
    return tr.fence(value, name, cat)


def instant(name: str, cat: str = "fabric", **args) -> None:
    tr = _tracer
    if tr.enabled:
        tr.instant(name, cat, **args)


def disabled_span_cost_ns(iters: int = 20000) -> float:
    """Measured per-call cost of a DISABLED module-level span — the number
    the <1% overhead gate multiplies by spans-per-batch.  Runs with the
    process tracer forced off for the measurement window."""
    tr = _tracer
    was = tr.enabled
    tr.enabled = False
    try:
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            with span("obs.overhead_probe"):
                pass
        return (time.perf_counter_ns() - t0) / iters
    finally:
        tr.enabled = was
