"""The port's telemetry layer, copied from ``repro.obs``.

- :mod:`repro_torch.obs.metrics`: labeled Counter/Gauge/Histogram registry
  with snapshot/merge and Prometheus/JSON exporters;
- :mod:`repro_torch.obs.trace`: span-based tracing emitting Chrome
  trace-event JSON (Perfetto-loadable);
- :mod:`repro_torch.obs.logs`: stdlib ``logging`` setup with a run id
  shared with the tracer.

All three are stdlib only.
"""

from repro_torch.obs.logs import setup_logging
from repro_torch.obs.metrics import MetricsRegistry, get_registry
from repro_torch.obs.trace import Tracer, get_tracer

__all__ = ["MetricsRegistry", "get_registry", "Tracer", "get_tracer",
           "setup_logging"]
