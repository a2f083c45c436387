"""`repro_torch.obs` — span tracing, metrics and the live GPSL invariant
monitor (copies of :mod:`repro.obs.trace`, :mod:`repro.obs.metrics` and
:mod:`repro.obs.monitor`)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, P2Quantile,
                                     group_percentiles, percentiles)
from repro_torch.obs.monitor import (GPSLMonitor, MonitorSummary,
                                     monitor_from_spec)
from repro_torch.obs.trace import (NullTracer, Tracer, maybe_profiler,
                                   null_tracer, tracer_from_spec,
                                   write_outputs)

__all__ = [
    "Tracer", "NullTracer", "null_tracer", "tracer_from_spec",
    "write_outputs", "maybe_profiler",
    "GPSLMonitor", "MonitorSummary", "monitor_from_spec",
    "percentiles", "group_percentiles", "P2Quantile", "Counter", "Gauge",
    "Histogram", "MetricsRegistry",
]
