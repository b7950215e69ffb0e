"""Observability of the port: metrics registry, span tracing, and profiler
capture with the serve step's ranges (counterpart of ``repro/obs``)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     default_registry, parse_exposition)
from repro_torch.obs.profiling import RANGES, profile_capture, range_times
from repro_torch.obs.trace import NOOP, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "parse_exposition",
    "Span", "Tracer", "NOOP",
    "RANGES", "profile_capture", "range_times",
]
