"""Thread-safe metrics registry: counters, gauges, fixed-boundary histograms.

The port's own copy of the JAX package's ``obs/metrics.py`` (stdlib plus
numpy; the port imports nothing of that package).  The storage layer of the
port's telemetry:

* :class:`Counter` — monotonically increasing float (locked add);
* :class:`Gauge`   — last-write-wins float (locked set);
* :class:`Histogram` — fixed-boundary bucket counts with sum/min/max and
  p50/p95/p99 derivation by linear interpolation inside the bucket.

All instruments support *labels*: an instrument created with ``labelnames``
is a parent whose :meth:`~Instrument.labels` call returns (and memoises) a
child series per label-value tuple — the cascade's per-stage latency
histogram is one parent with one child per stage.

Concurrency: every mutation takes the instrument's own lock, so counters
shared between a request thread and a worker thread cannot lose
increments.  Reads take the same lock and therefore observe a consistent
(count, sum, buckets) triple.

Cost when disabled: each mutation is one attribute load and a branch —
``Registry(enabled=False)`` makes a component observation-free without any
call-site changes.

Duplicate protection: re-requesting an instrument with the identical
definition returns the existing one (evaluators sharing a registry
deliberately share series); re-registering a name with a different kind,
help string, label set or boundaries raises :class:`DuplicateMetricError`.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Sequence

try:  # numpy is optional here: the registry itself stays stdlib-only, but
    # array-sized bulk observations (observe_many) vectorise when it exists
    import numpy as _np
except ImportError:  # pragma: no cover - numpy is always present in-repo
    _np = None

__all__ = [
    "Counter",
    "DEFAULT_MS_BOUNDARIES",
    "DEFAULT_RATIO_BOUNDARIES",
    "DuplicateMetricError",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "set_default_registry",
]


class DuplicateMetricError(ValueError):
    """A metric name was re-registered with a conflicting definition."""


# Latency histograms default to a geometric ms grid spanning sub-kernel
# dispatch (~50 µs) to multi-second waves; ratio histograms (overlap, pad
# fraction, confidence) to a uniform [0, 1] grid.
DEFAULT_MS_BOUNDARIES: tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)
DEFAULT_RATIO_BOUNDARIES: tuple[float, ...] = tuple(i / 10.0 for i in range(11))


class Instrument:
    """Common parent/child plumbing for all instrument kinds.

    A parent (created through the registry) may carry ``labelnames``; its
    children (one per label-value tuple, via :meth:`labels`) do the actual
    recording.  An unlabelled instrument is its own single series.
    """

    kind = "instrument"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], "Instrument"] = {}

    # -- labels -------------------------------------------------------------

    def _make_child(self) -> "Instrument":
        raise NotImplementedError

    def labels(self, **labelvalues: object) -> "Instrument":
        """The child series for these label values (created on first use)."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def series(self) -> Iterator[tuple[tuple[str, ...], "Instrument"]]:
        """(label-values, series) pairs — the instrument itself if unlabelled."""
        if self.labelnames:
            with self._lock:
                items = sorted(self._children.items())
            yield from items
        else:
            yield (), self

    def _definition(self) -> tuple:
        return (self.kind, self.help, self.labelnames)


class Counter(Instrument):
    """Monotonically increasing value (float; ``inc`` by any amount ≥ 0)."""

    kind = "counter"

    def __init__(self, registry, name, help="", labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self._registry, self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease ({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(Instrument):
    """Last-write-wins value (``set``/``add``)."""

    kind = "gauge"

    def __init__(self, registry, name, help="", labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self._registry, self.name, self.help)

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(Instrument):
    """Fixed-boundary histogram with quantile derivation.

    ``boundaries`` are the ascending upper bucket edges; an implicit +Inf
    bucket catches overflow.  ``quantile(q)`` interpolates linearly inside
    the bucket holding the q-th observation — exact enough for p50/p95/p99
    over latency grids while storing O(len(boundaries)) state, never the
    raw samples.
    """

    kind = "histogram"

    def __init__(self, registry, name, help="", labelnames=(),
                 boundaries: Sequence[float] = DEFAULT_MS_BOUNDARIES):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(float(b) for b in boundaries)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"boundaries must be ascending and non-empty: {bs}")
        self.boundaries = bs
        self._counts = [0] * (len(bs) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def _make_child(self) -> "Histogram":
        return Histogram(self._registry, self.name, self.help,
                         boundaries=self.boundaries)

    def _definition(self) -> tuple:
        return (self.kind, self.help, self.labelnames, self.boundaries)

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        v = float(value)
        i = 0
        for b in self.boundaries:          # ≤ ~17 comparisons; no bisect import
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values) -> None:
        """Bulk-observe an iterable (e.g. per-record confidences or margins)
        under one lock acquisition — the hot-path form for array-sized
        observations; vectorised via numpy when available."""
        if not self._registry.enabled:
            return
        bs = self.boundaries
        if _np is not None:
            arr = _np.asarray(values, dtype=float).ravel()
            if arr.size == 0:
                return
            # searchsorted(side="left"): first index i with v <= bs[i] —
            # exactly observe()'s bucket rule; i == len(bs) is the overflow
            idx = _np.searchsorted(bs, arr, side="left")
            adds = _np.bincount(idx, minlength=len(bs) + 1)
            n, total = int(arr.size), float(arr.sum())
            mn, mx = float(arr.min()), float(arr.max())
        else:
            vs = [float(v) for v in values]
            if not vs:
                return
            adds = [0] * (len(bs) + 1)
            for v in vs:
                i = 0
                for b in bs:
                    if v <= b:
                        break
                    i += 1
                adds[i] += 1
            n, total = len(vs), sum(vs)
            mn, mx = min(vs), max(vs)
        with self._lock:
            for i, a in enumerate(adds):
                self._counts[i] += int(a)
            self._count += n
            self._sum += total
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (0 ≤ q ≤ 1) by in-bucket interpolation; None if empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            counts, total = list(self._counts), self._count
            lo, hi = self._min, self._max
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= rank and c > 0:
                # bucket edges, clamped to the observed [min, max] range: a
                # bucket holding samples always has lo ≤ its samples ≤ hi
                lower = self.boundaries[i - 1] if i > 0 else lo
                upper = self.boundaries[i] if i < len(self.boundaries) else hi
                lower, upper = max(lower, lo), min(upper, hi)
                if upper <= lower:
                    return upper
                frac = (rank - cum) / c
                return lower + frac * (upper - lower)
            cum += c
        return hi

    def percentiles(self) -> dict[str, Optional[float]]:
        return {"p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def state(self) -> dict:
        """A consistent snapshot of the full histogram state."""
        with self._lock:
            counts = list(self._counts)
            count, s = self._count, self._sum
            mn = self._min if self._count else None
            mx = self._max if self._count else None
        return {"count": count, "sum": s, "min": mn, "max": mx,
                "boundaries": list(self.boundaries), "bucket_counts": counts}


class Registry:
    """One namespace of instruments; thread-safe get-or-create registration.

    ``enabled`` gates every mutation (reads always work): a disabled
    registry's instruments are inert no-ops, so components instrumented
    unconditionally cost one branch per would-be observation.  Flipping
    ``enabled`` later re-activates the same instruments — handles cached by
    components stay valid either way.
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, Instrument] = {}

    # -- lifecycle ----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- registration -------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                want = cls(self, name, help, labelnames, **kw)._definition()
                if existing._definition() != want:
                    raise DuplicateMetricError(
                        f"metric {name!r} already registered as {existing._definition()}, "
                        f"re-registered as {want}"
                    )
                return existing
            inst = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  boundaries: Sequence[float] = DEFAULT_MS_BOUNDARIES) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   boundaries=boundaries)

    # -- introspection ------------------------------------------------------

    def metrics(self) -> list[Instrument]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict:
        """JSON-ready state of every series (see :mod:`repro_torch.obs.export`)."""
        from repro_torch.obs.export import snapshot  # local: export imports metrics

        return snapshot(self)


_DEFAULT = Registry()
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> Registry:
    """The process-wide default registry (cross-cutting tune/dist counters).

    Components that cannot be handed a registry explicitly (one-shot
    functional APIs, module-level tuner calls) record here; engines default
    to their own private registry so per-engine stats views stay exact.
    """
    return _DEFAULT


def set_default_registry(registry: Registry) -> Registry:
    """Swap the process default (tests); returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, registry
    return prev
