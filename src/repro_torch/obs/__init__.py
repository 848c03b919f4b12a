"""Metrics, span tracing and their exporters for the port.

The port's own copies of the JAX package's ``obs/metrics.py``,
``obs/export.py`` and ``obs/trace.py`` (it imports nothing of that
package); the tracer's profiler bridge is ``torch.profiler.record_function``.

  metrics.py  thread-safe registry of counters / gauges / fixed-boundary
              histograms with p50/p95/p99 derivation; labelled series;
              near-zero-cost when disabled; duplicate-registration guard.
  trace.py    ring-buffered span tracer with a Chrome/Perfetto exporter.
  export.py   JSON snapshot + Prometheus text exposition, stdlib-only.

Every evaluator owns a private :class:`Registry` by default and accepts
``registry=`` / ``tracer=`` to share one.
"""

from repro_torch.obs.export import prometheus_text, snapshot, write_json_snapshot
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
from repro_torch.obs.trace import NULL_TRACER, SpanEvent, Tracer, write_chrome_trace

__all__ = [
    "Counter",
    "DEFAULT_MS_BOUNDARIES",
    "DEFAULT_RATIO_BOUNDARIES",
    "DuplicateMetricError",
    "Gauge",
    "Histogram",
    "NULL_TRACER",
    "Registry",
    "SpanEvent",
    "Tracer",
    "default_registry",
    "prometheus_text",
    "set_default_registry",
    "snapshot",
    "write_chrome_trace",
    "write_json_snapshot",
]
