"""SLO flight recorder: a bounded ring of recent waves + crash-dump bundles.

The port's own copy of the JAX package's ``obs/flight.py``.

A serve engine under load is the one place a perf bug is both most costly
and hardest to reproduce after the fact — by the time someone looks, the
offending wave is gone.  :class:`FlightRecorder` keeps a bounded in-memory
ring of the engine's most recent wave records (latency, bucket, sizes,
caller-supplied annotations) and, when something goes wrong — a wave
breaching the latency SLO, an exception escaping the eval path, or an
explicit ``engine.dump_flight()`` — writes a self-contained debug bundle
to disk:

* ``flight.json`` — the dump reason, the policy, the wave ring, and a full
  metrics-registry snapshot (via :func:`repro_torch.obs.export.snapshot`);
* ``trace.json`` — the tracer's Chrome/Perfetto trace of the same window,
  loadable in ``ui.perfetto.dev``.

Breaches and dumps are themselves counted in the registry
(``flight.slo_breaches``, ``flight.dumps``) so a fleet exporter sees them
without reading disk.  Dumping is rate-limited (``min_dump_interval_s``)
so a sustained breach storm produces one bundle, not thousands.

Stdlib-only (plus the sibling obs modules) — importable without torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional

from .export import snapshot
from .metrics import Registry
from .trace import NULL_TRACER, Tracer

__all__ = ["FlightPolicy", "FlightRecorder"]


@dataclasses.dataclass(frozen=True)
class FlightPolicy:
    """What the recorder keeps, what trips it, and where bundles land.

    ``slo_ms=None`` disables breach detection (the ring and manual dumps
    still work).  ``capacity`` bounds the wave ring.  Bundles are written
    under ``out_dir`` as ``flight-<engine>-<seq>-<reason>/``; the default is
    ``repro_torch_flight`` in the process's temporary directory.
    """

    slo_ms: Optional[float] = None
    capacity: int = 256
    out_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_flight"))
    min_dump_interval_s: float = 30.0
    dump_on_breach: bool = True
    dump_on_exception: bool = True


class FlightRecorder:
    """Bounded wave ring + breach accounting + debug-bundle dumps.

    One recorder serves one engine; engines call :meth:`note_wave` after
    each wave and :meth:`note_exception` when eval raises.  Thread-safe —
    serve engines may run waves from worker threads.
    """

    def __init__(
        self,
        policy: Optional[FlightPolicy] = None,
        *,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        engine: str = "serve",
    ):
        self.policy = policy or FlightPolicy()
        self.engine = engine
        self._registry = registry
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._ring: deque = deque(maxlen=max(1, int(self.policy.capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump_t: Optional[float] = None
        if registry is not None:
            self._m_breaches = registry.counter(
                "flight.slo_breaches",
                "Waves whose latency exceeded the flight-recorder SLO",
                ("engine",),
            ).labels(engine=engine)
            self._m_dumps = registry.counter(
                "flight.dumps",
                "Flight-recorder debug bundles written, by trigger",
                ("engine", "reason"),
            )
        else:
            self._m_breaches = None
            self._m_dumps = None

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def note_wave(self, *, latency_ms: float, bucket: str = "",
                  records: int = 0, requests: int = 0, **annotations) -> bool:
        """Record one completed wave; returns True if it breached the SLO.

        A breach increments ``flight.slo_breaches`` and (policy permitting,
        rate limit permitting) dumps a bundle.
        """
        rec = {
            "t": time.time(),
            "latency_ms": float(latency_ms),
            "bucket": str(bucket),
            "records": int(records),
            "requests": int(requests),
        }
        if annotations:
            rec.update({k: _jsonable(v) for k, v in annotations.items()})
        slo = self.policy.slo_ms
        breached = slo is not None and latency_ms > slo
        rec["breach"] = breached
        with self._lock:
            self._ring.append(rec)
        if breached:
            if self._m_breaches is not None:
                self._m_breaches.inc()
            if self.policy.dump_on_breach:
                self._maybe_dump("slo_breach")
        return breached

    def note_drift(self, *, bucket: str = "", distance: float = 0.0,
                   **annotations) -> None:
        """Record a traversal-drift event in the wave ring.

        Drift is context, not an emergency: the record rides the ring so the
        *next* bundle (whatever triggers it) shows that the workload's leaf
        distribution moved — no dump of its own.
        """
        rec = {
            "t": time.time(),
            "drift": True,
            "bucket": str(bucket),
            "distance": float(distance),
        }
        if annotations:
            rec.update({k: _jsonable(v) for k, v in annotations.items()})
        with self._lock:
            self._ring.append(rec)

    def note_exception(self, exc: BaseException) -> None:
        """Record an exception escaping the eval path; dump if configured."""
        rec = {
            "t": time.time(),
            "exception": type(exc).__name__,
            "message": str(exc),
        }
        with self._lock:
            self._ring.append(rec)
        if self.policy.dump_on_exception:
            self._maybe_dump("exception")

    # ------------------------------------------------------------------
    # dumping
    # ------------------------------------------------------------------

    def _maybe_dump(self, reason: str) -> Optional[Path]:
        """Dump unless within the rate-limit window (manual dumps bypass it)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_t
            if last is not None and now - last < self.policy.min_dump_interval_s:
                return None
            self._last_dump_t = now
        return self.dump(reason, _stamp=False)

    def dump(self, reason: str = "manual", *, _stamp: bool = True) -> Path:
        """Write a ``flight-<engine>-<seq>-<reason>/`` bundle; returns its path."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            ring = list(self._ring)
            if _stamp:
                self._last_dump_t = time.monotonic()
        out = Path(self.policy.out_dir) / f"flight-{self.engine}-{seq:04d}-{reason}"
        out.mkdir(parents=True, exist_ok=True)
        bundle = {
            "engine": self.engine,
            "reason": reason,
            "ts": time.time(),
            "policy": dataclasses.asdict(self.policy),
            "waves": ring,
            "metrics": snapshot(self._registry) if self._registry is not None else None,
        }
        (out / "flight.json").write_text(json.dumps(bundle, indent=2, sort_keys=True))
        (out / "trace.json").write_text(json.dumps(self._tracer.chrome_trace()))
        if self._m_dumps is not None:
            self._m_dumps.labels(engine=self.engine, reason=reason).inc()
        return out

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def waves(self) -> list:
        """A copy of the current wave ring, oldest first."""
        with self._lock:
            return list(self._ring)


def _jsonable(v):
    """Coerce an annotation value to something json.dumps accepts."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
