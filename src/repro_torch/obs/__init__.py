"""Fabric observability: the host-side span tracer, latency histograms
and the windowed metrics registry (``xprof``, the ``c10d`` collective
counter, is imported on its own)."""
from repro_torch.obs.metrics import LatencyHistogram  # noqa: F401
from repro_torch.obs.registry import MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import (Tracer, disable, enable,  # noqa: F401
                                   get_tracer, set_tracer)
