"""Fabric observability: the host-side span tracer."""
from repro_torch.obs.trace import (Tracer, disable, enable,  # noqa: F401
                                   get_tracer, set_tracer)
