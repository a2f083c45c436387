"""`repro_torch.obs` — span tracing and metrics for the port's serving
runtime (copies of :mod:`repro.obs.trace` and :mod:`repro.obs.metrics`)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, P2Quantile,
                                     group_percentiles, percentiles)
from repro_torch.obs.trace import (NullTracer, Tracer, check_profiler,
                                   null_tracer, tracer_from_spec,
                                   write_outputs)

__all__ = [
    "Tracer", "NullTracer", "null_tracer", "tracer_from_spec",
    "write_outputs", "check_profiler",
    "percentiles", "group_percentiles", "P2Quantile", "Counter", "Gauge",
    "Histogram", "MetricsRegistry",
]
