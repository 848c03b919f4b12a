"""Metrics, span tracing and their exporters for the port.

The port's own copies of the JAX package's ``obs/metrics.py``,
``obs/export.py`` and ``obs/trace.py`` (it imports nothing of that
package); the tracer's profiler bridge is ``torch.profiler.record_function``.

  metrics.py  thread-safe registry of counters / gauges / fixed-boundary
              histograms with p50/p95/p99 derivation; labelled series;
              near-zero-cost when disabled; duplicate-registration guard.
  trace.py    ring-buffered span tracer with a Chrome/Perfetto exporter.
  export.py   JSON snapshot + Prometheus text exposition, stdlib-only.
  flight.py   SLO flight recorder for the serve engine — bounded ring of
              recent waves, breach counters, debug bundles (metrics
              snapshot + Perfetto trace) on breach/exception/demand.
  prof.py     traversal profiler — sampled shadow passes over the live
              workload measuring §3.6's d_µ / speculation waste / lane
              occupancy / leaf-hit drift, feeding the tuner measured values
              instead of priors.

Every evaluator owns a private :class:`Registry` by default and accepts
``registry=`` / ``tracer=`` to share one.
"""

from repro_torch.obs.export import prometheus_text, snapshot, write_json_snapshot
from repro_torch.obs.flight import FlightPolicy, FlightRecorder
from repro_torch.obs.metrics import (
    DEFAULT_MS_BOUNDARIES,
    DEFAULT_RATIO_BOUNDARIES,
    Counter,
    DuplicateMetricError,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    set_default_registry,
)
from repro_torch.obs.prof import (
    BucketProfile,
    ProfilePolicy,
    TraversalProfiler,
    leaf_drift_distance,
    survival_from_classes,
)
from repro_torch.obs.trace import NULL_TRACER, SpanEvent, Tracer, write_chrome_trace

__all__ = [
    "BucketProfile",
    "Counter",
    "DEFAULT_MS_BOUNDARIES",
    "DEFAULT_RATIO_BOUNDARIES",
    "DuplicateMetricError",
    "FlightPolicy",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "NULL_TRACER",
    "ProfilePolicy",
    "Registry",
    "SpanEvent",
    "Tracer",
    "TraversalProfiler",
    "default_registry",
    "leaf_drift_distance",
    "prometheus_text",
    "set_default_registry",
    "snapshot",
    "survival_from_classes",
    "write_chrome_trace",
    "write_json_snapshot",
]
