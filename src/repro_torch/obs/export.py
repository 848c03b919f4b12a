"""Exporters: JSON snapshot and Prometheus-style text exposition.

Two consumers, two formats:

* :func:`snapshot` — a JSON-ready dict of every series, histograms with
  derived p50/p95/p99, for result files, tests and introspection;
* :func:`prometheus_text` — the text exposition format (``# TYPE`` headers,
  ``_bucket{le=...}``/``_sum``/``_count`` histogram triplets) a Prometheus
  scraper ingests directly.  Metric names are sanitised (dots → underscores)
  per the exposition grammar; the dotted originals stay in the snapshot.

Both are pure functions of a :class:`repro_torch.obs.metrics.Registry` —
stdlib only — the port's own copy of the JAX package's ``obs/export.py``.
"""

from __future__ import annotations

import json
import math
import re
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.obs.metrics import Registry

__all__ = ["prometheus_text", "snapshot", "series_name", "write_json_snapshot"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_labels(labelnames, labelvalues) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(  # OpenMetrics: no whitespace between label pairs
        f'{_prom_name(k)}="{_escape(v)}"' for k, v in zip(labelnames, labelvalues)
    )
    return "{" + pairs + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def series_name(name: str, labelnames, labelvalues) -> str:
    """Human/JSON series id: ``name{label="value",...}`` (dotted name kept)."""
    if not labelnames:
        return name
    pairs = ",".join(f'{k}="{_escape(v)}"' for k, v in zip(labelnames, labelvalues))
    return f"{name}{{{pairs}}}"


def snapshot(registry: "Registry") -> dict:
    """JSON-ready state of every series in ``registry``.

    Layout::

        {"counters":   {series: value, ...},
         "gauges":     {series: value, ...},
         "histograms": {series: {count, sum, min, max, p50, p95, p99,
                                 boundaries, bucket_counts}, ...}}

    Histogram percentiles are interpolated from the fixed buckets (see
    :meth:`repro_torch.obs.metrics.Histogram.quantile`); an empty histogram
    reports ``null`` percentiles rather than NaN so the dict round-trips
    through strict JSON.
    """
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for metric in registry.metrics():
        for labelvalues, series in metric.series():
            key = series_name(metric.name, metric.labelnames, labelvalues)
            if metric.kind == "counter":
                out["counters"][key] = series.value
            elif metric.kind == "gauge":
                out["gauges"][key] = series.value
            elif metric.kind == "histogram":
                state = series.state()
                state.update(series.percentiles())
                out["histograms"][key] = state
    return out


def write_json_snapshot(registry: "Registry", path) -> None:
    """Serialise :func:`snapshot` to ``path`` (strict JSON, sorted keys)."""
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1, sort_keys=True)
        f.write("\n")


def prometheus_text(registry: "Registry") -> str:
    """The Prometheus text exposition of every series in ``registry``."""
    lines: list[str] = []
    for metric in registry.metrics():
        pname = _prom_name(metric.name)
        if metric.help:
            lines.append(f"# HELP {pname} {metric.help}")
        lines.append(f"# TYPE {pname} {metric.kind}")
        for labelvalues, series in metric.series():
            labels = _prom_labels(metric.labelnames, labelvalues)
            if metric.kind in ("counter", "gauge"):
                lines.append(f"{pname}{labels} {_fmt(series.value)}")
                continue
            state = series.state()
            cum = 0
            for b, c in zip(state["boundaries"], state["bucket_counts"]):
                cum += c
                le = 'le="' + _fmt(b) + '"'
                lines.append(f"{pname}_bucket{_merge(labels, le)} {cum}")
            cum += state["bucket_counts"][-1]
            inf = 'le="+Inf"'
            lines.append(f"{pname}_bucket{_merge(labels, inf)} {cum}")
            lines.append(f"{pname}_sum{labels} {_fmt(state['sum'])}")
            lines.append(f"{pname}_count{labels} {state['count']}")
    return "\n".join(lines) + "\n"


def _merge(labels: str, extra: str) -> str:
    if not labels:
        return "{" + extra + "}"
    return labels[:-1] + "," + extra + "}"


def _fmt(v: float) -> str:
    if v != v or math.isinf(v):  # exposition format spells these out
        return "+Inf" if v > 0 else ("-Inf" if v < 0 else "NaN")
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))
