"""Traversal profiler: sampled shadow passes feeding the §3.6 cost model.

The port's own copy of the JAX package's ``obs/prof.py``.  The metrics
around the kernels (latency histograms, spans) say how long; this module
looks *inside* them.  A :class:`TraversalProfiler` rides a serve engine's
wave loop: 1-in-N waves (policy-controlled, like ``RetunePolicy``) get a
*shadow pass* — the profiling descent of
:mod:`repro_torch.kernels.tree_eval.profile`, run off the request path on a
bounded record sample — whose device-side reductions yield the quantities
the paper's runtime model (§3.6) otherwise only *assumes*:

* measured mean traversal depth **d_µ** per shape bucket (vs the
  ``tune/heuristic.py`` geometry prior),
* the **speculation-waste ratio** ``N / d_µ`` — node evaluations the
  speculative all-nodes pass pays per record over the divergent descent,
* per-level **active-lane fractions** (SIMD occupancy by round),
* per-leaf **hit histograms**, windowed into a **drift detector**: when
  live traffic stops landing where it used to, the bucket's tuned winner
  and cascade plan were chosen for a workload that no longer exists, so
  drift raises an event that (via the engine's ``on_drift`` hook) forces a
  background re-tune and is recorded in flight bundles.

Everything is published twice: through the shared :class:`~repro_torch.obs.
metrics.Registry` (gauges + histograms + counters, Prometheus-exportable)
and as Perfetto *counter tracks* via :meth:`~repro_torch.obs.trace.Tracer.
counter`, so d_µ / waste / survival render as stepped timelines alongside
the wave spans.

The feedback loop closes in ``tune/dispatch.py``: evaluators consult
:meth:`TraversalProfiler.d_mu` / :meth:`survival` before falling back to
host sampling or the geometry prior, with provenance counters mirroring
``tune.heuristic_agreement``.

Drift thresholding is noise-aware: a fixed floor until enough history
exists, then ``max(floor, median + k·MAD)`` of the bucket's own past
distances — quiet buckets get tight thresholds, noisy ones are not flagged
for breathing.

The module imports no torch: a profile's fields may be tensors on any
device, and are brought to the host here (``_host``).
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.metrics import DEFAULT_RATIO_BOUNDARIES, Registry
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = [
    "BucketProfile",
    "ProfilePolicy",
    "TraversalProfiler",
    "leaf_drift_distance",
    "survival_from_classes",
]

# Exit-depth histogram grid: unit steps through the depths real CART trees
# reach, geometric past that (the descent is O(depth) rounds, capped ~64).
DEPTH_BOUNDARIES: tuple[float, ...] = (
    1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 16.0, 20.0, 24.0,
    32.0, 48.0, 64.0,
)


@dataclasses.dataclass(frozen=True)
class ProfilePolicy:
    """When and how much to shadow-profile (engine-level, like RetunePolicy).

    Attributes:
      sample_every: profile every k-th wave of each bucket (the first wave
        always profiles so a fresh bucket gets measured d_µ before its
        first background re-tune).  ``<= 0`` disables profiling entirely.
        The default (64) keeps the request-path median clean on CPU-only
        hosts, where a shadow pass co-running with serving steals compute
        from the wave being served — sampled waves pay a few ms of
        co-run cost, the rest pay one counter increment.
      sample_records: per-pass record cap — the shadow descent runs on at
        most this many records of the sampled wave (bounds its cost
        independently of ``max_batch``).
      max_concurrent: shadow passes in flight at once; further sampled
        waves are skipped, not queued (profiling must never back-pressure
        serving).
      synchronous: run the pass inline in ``note_wave`` instead of a
        worker thread — deterministic, for tests and the chip smoke.
      drift_window: leaf-histogram window length per bucket.
      drift_min_samples: histograms required before drift is evaluated.
      drift_threshold: χ² distance floor that always counts as drift.
      drift_k_mad: noise multiplier — with enough history the effective
        threshold is ``max(drift_threshold, median + k·MAD)`` of the
        bucket's past distances.
    """

    sample_every: int = 64
    sample_records: int = 512
    max_concurrent: int = 1
    synchronous: bool = False
    drift_window: int = 8
    drift_min_samples: int = 4
    drift_threshold: float = 0.25
    drift_k_mad: float = 5.0


@dataclasses.dataclass
class BucketProfile:
    """Latest measured traversal statistics for one shape bucket."""

    d_mu: float                      # measured mean traversal depth
    waste_ratio: float               # N / d_mu (§3.6 speculative waste)
    survival: Optional[float]        # measured cascade survival (forests)
    samples: int                     # shadow passes contributing
    records: int                     # records profiled in total
    level_active: np.ndarray         # (max_depth,) active-lane fraction
    leaf_hist: np.ndarray            # (N,) latest leaf-hit counts


def _host(x) -> np.ndarray:
    """A profile field (a tensor on any device, or an array) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaf_drift_distance(p: np.ndarray, q: np.ndarray) -> float:
    """Symmetric χ² distance between two leaf-hit distributions.

    ``0.5 · Σ (p_i − q_i)² / (p_i + q_i)`` over the normalised histograms —
    bounded [0, 1], zero iff identical, and (unlike KL) defined when leaves
    go unvisited.  Mismatched lengths are padded with zeros (a re-encoded
    tree changes its leaf count; the mass moved is what matters).
    """
    p = np.asarray(p, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    n = max(p.size, q.size)
    if p.size < n:
        p = np.pad(p, (0, n - p.size))
    if q.size < n:
        q = np.pad(q, (0, n - q.size))
    ps, qs = p.sum(), q.sum()
    if ps <= 0 or qs <= 0:
        return 0.0 if ps == qs else 1.0
    p, q = p / ps, q / qs
    denom = p + q
    mask = denom > 0
    return float(0.5 * np.sum((p[mask] - q[mask]) ** 2 / denom[mask]))


def survival_from_classes(
    classes: np.ndarray, n_classes: int, *, stages: int = 2, bound: float = 1.0
) -> Optional[float]:
    """Measured per-stage cascade survival from profiled per-tree votes.

    Replays the margin-exit rule of :mod:`repro_torch.kernels.tree_eval.cascade`
    on the shadow pass's (T, M) per-tree classes: trees split into
    ``stages`` even prefixes, a record survives a stage while its vote
    margin can still be flipped (``margin <= bound · remaining``).  Returns
    the mean fraction alive entering stages 2..S — the quantity
    ``measured_survival_rate`` estimates with an extra evaluation, now free
    with every profile.  ``None`` when there is no ensemble to cascade
    (single tree or fewer than 2 trees/stages).
    """
    classes = np.asarray(classes)
    if classes.ndim != 2 or classes.shape[0] < 2 or stages < 2:
        return None
    t, m = classes.shape
    stages = min(stages, t)
    votes = np.zeros((m, int(n_classes)), np.int64)
    cut_prev = 0
    alive_fracs = []
    for s in range(1, stages):
        cut = (t * s) // stages
        for ti in range(cut_prev, cut):
            np.add.at(votes, (np.arange(m), np.clip(classes[ti], 0, n_classes - 1)), 1)
        cut_prev = cut
        part = np.sort(votes, axis=1)
        margin = part[:, -1] - part[:, -2]
        remaining = t - cut
        alive_fracs.append(float((margin <= bound * remaining).mean()))
    return float(np.mean(alive_fracs)) if alive_fracs else None


class TraversalProfiler:
    """Sampled shadow-pass profiler attached to a serve engine's wave loop.

    Args:
      profile_fn: ``batch -> TreeProfile | ForestProfile`` — the engine
        binds :func:`~repro_torch.kernels.tree_eval.profile.profile_tree_eval`
        or ``profile_forest_eval`` over its model (kept a closure so this
        module stays torch-free and testable with fakes).
      policy: sampling/drift policy; ``None`` → default :class:`ProfilePolicy`.
      registry / tracer: the engine's obs pair; metrics land under
        ``prof.*`` and counter tracks under ``prof.<stat>/<bucket>``.
      n_nodes: node-table size N for the waste ratio; inferred from the
        profile's hit arrays when omitted.
      n_classes: enables measured cascade survival on (T, M) profiles.
      on_drift: ``(bucket_key, distance, records) -> None`` — the engine
        wires this to flight-recorder annotation + forced re-tune.
      engine: label stamped on spans/bundle annotations.
    """

    def __init__(
        self,
        profile_fn: Callable[[np.ndarray], object],
        policy: Optional[ProfilePolicy] = None,
        *,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        n_nodes: Optional[int] = None,
        n_classes: Optional[int] = None,
        on_drift: Optional[Callable[[str, float, np.ndarray], None]] = None,
        engine: str = "engine",
    ):
        self.profile_fn = profile_fn
        self.policy = policy if policy is not None else ProfilePolicy()
        self.obs = registry if registry is not None else Registry(enabled=False)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.n_nodes = n_nodes
        self.n_classes = n_classes
        self.on_drift = on_drift
        self.engine = engine

        self._lock = threading.Lock()
        self._wave_counts: dict[str, int] = {}
        self._profiles: dict[str, BucketProfile] = {}
        # drift state per bucket: window of normalised hists + past distances
        self._windows: dict[str, deque] = {}
        self._distances: dict[str, list[float]] = {}
        self._threads: list[threading.Thread] = []

        r = self.obs
        self.m_waves = r.counter("prof.waves", "waves seen by the profiler")
        self.m_sampled = r.counter("prof.sampled", "shadow profile passes run")
        self.m_skipped = r.counter(
            "prof.skipped", "sampled waves skipped (pass already in flight)")
        self.m_records = r.counter("prof.records", "records shadow-profiled")
        self.m_errors = r.counter("prof.errors", "shadow passes that raised")
        self.m_drift = r.counter(
            "prof.drift_events", "leaf-histogram drift events", ("bucket",))
        self.m_exit_depth = r.histogram(
            "prof.exit_depth", "per-record traversal depth (measured)",
            boundaries=DEPTH_BOUNDARIES)
        self.m_active = r.histogram(
            "prof.active_fraction", "active-lane fraction per descent level",
            boundaries=DEFAULT_RATIO_BOUNDARIES)
        self.m_d_mu = r.gauge(
            "prof.d_mu", "measured mean traversal depth per bucket", ("bucket",))
        self.m_waste = r.gauge(
            "prof.waste_ratio", "speculation waste N/d_mu per bucket (§3.6)",
            ("bucket",))
        self.m_survival = r.gauge(
            "prof.survival", "measured cascade survival per bucket", ("bucket",))
        self.m_drift_dist = r.gauge(
            "prof.drift_distance", "latest leaf-histogram chi^2 distance",
            ("bucket",))

    # -- wave hook (request thread; must stay cheap) -------------------------

    def note_wave(self, key: str, batch) -> bool:
        """Engine wave-end hook; returns True when a shadow pass was started.

        Sampling is per bucket: wave counts are tracked per ``key`` and the
        first wave of every bucket profiles immediately (measured d_µ should
        exist before the bucket's first re-tune), then every
        ``sample_every``-th wave after that.  The sampled slice is copied
        before handing off — the engine may reuse its batch buffer.
        """
        pol = self.policy
        if pol.sample_every <= 0:
            return False
        self.m_waves.inc()
        with self._lock:
            n = self._wave_counts.get(key, 0) + 1
            self._wave_counts[key] = n
            if (n - 1) % pol.sample_every != 0:
                return False
            self._threads = [t for t in self._threads if t.is_alive()]
            if not pol.synchronous and len(self._threads) >= pol.max_concurrent:
                self.m_skipped.inc()
                return False
            snap = np.array(batch[: pol.sample_records], np.float32, copy=True)
            if pol.synchronous:
                worker = None
            else:
                worker = threading.Thread(
                    target=self._work, args=(key, snap),
                    name=f"profile:{key}", daemon=True)
                self._threads.append(worker)
        if worker is None:
            self._work(key, snap)
        else:
            worker.start()
        return True

    def drain(self, timeout: float = 10.0) -> None:
        """Join in-flight shadow passes (tests / engine shutdown)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    # -- feedback API (consumed by tune/dispatch.py) -------------------------

    def profile(self, key: str) -> Optional[BucketProfile]:
        """Latest :class:`BucketProfile` for ``key`` (None: never profiled)."""
        with self._lock:
            return self._profiles.get(key)

    def keys(self) -> list[str]:
        """Every bucket with at least one completed shadow pass, sorted."""
        with self._lock:
            return sorted(self._profiles)

    def d_mu(self, key: str) -> Optional[float]:
        """Measured d_µ for ``key``, or None when the bucket is unprofiled."""
        p = self.profile(key)
        return p.d_mu if p is not None else None

    def survival(self, key: str) -> Optional[float]:
        """Measured cascade survival for ``key`` (None when unprofiled/1-tree)."""
        p = self.profile(key)
        return p.survival if p is not None else None

    # -- shadow pass (worker thread unless policy.synchronous) ---------------

    def _work(self, key: str, snap: np.ndarray) -> None:
        try:
            with self.tracer.span("prof.shadow", cat="prof", bucket=key,
                                  engine=self.engine, records=snap.shape[0]):
                prof = self.profile_fn(snap)
            self._publish(key, snap, prof)
        except Exception:
            self.m_errors.inc()

    def _publish(self, key: str, snap: np.ndarray, prof) -> None:
        exit_depth = _host(prof.exit_depth).ravel()
        node_hits = _host(prof.node_hits)
        if hasattr(prof, "leaf_histogram"):           # ForestProfile
            leaf_hist = prof.leaf_histogram()
            level_active = prof.mean_level_active()
        else:                                         # TreeProfile
            leaf_hist = _host(prof.leaf_hits)
            level_active = _host(prof.level_active)
        d_mu = float(exit_depth.mean()) if exit_depth.size else 0.0
        n_nodes = self.n_nodes if self.n_nodes is not None else node_hits.shape[-1]
        waste = float(n_nodes) / max(d_mu, 1.0)
        survival = None
        if self.n_classes is not None:
            classes = _host(prof.classes)
            survival = survival_from_classes(classes, self.n_classes)

        self.m_sampled.inc()
        self.m_records.inc(exit_depth.size)
        self.m_exit_depth.observe_many(exit_depth)
        self.m_active.observe_many(level_active)
        self.m_d_mu.labels(bucket=key).set(d_mu)
        self.m_waste.labels(bucket=key).set(waste)
        if survival is not None:
            self.m_survival.labels(bucket=key).set(survival)
        self.tracer.counter(f"prof.d_mu/{key}", d_mu, series="d_mu")
        self.tracer.counter(f"prof.waste/{key}", waste, series="waste_ratio")
        if survival is not None:
            self.tracer.counter(f"prof.survival/{key}", survival,
                                series="survival")

        drift_dist = self._note_drift(key, leaf_hist, snap)
        with self._lock:
            prev = self._profiles.get(key)
            self._profiles[key] = BucketProfile(
                d_mu=d_mu,
                waste_ratio=waste,
                survival=survival,
                samples=(prev.samples + 1) if prev else 1,
                records=(prev.records if prev else 0) + int(exit_depth.size),
                level_active=level_active,
                leaf_hist=leaf_hist,
            )
        if drift_dist is not None and self.on_drift is not None:
            self.on_drift(key, drift_dist, snap)

    def _note_drift(self, key: str, leaf_hist: np.ndarray,
                    snap: np.ndarray) -> Optional[float]:
        """Update the bucket's windowed leaf histograms; distance on drift.

        Baseline = elementwise mean of the window; distance = χ² of the new
        histogram against it.  Threshold is the policy floor until the
        bucket has ≥ 2 past distances, then ``max(floor, median + k·MAD)``
        of those — the perf-gate's noise-aware rule applied to drift.  On
        drift the window re-anchors on the new distribution, so a sustained
        shift fires once, not every pass thereafter.
        """
        total = float(np.asarray(leaf_hist, np.float64).sum())
        if total <= 0:
            return None
        hist = np.asarray(leaf_hist, np.float64) / total
        pol = self.policy
        with self._lock:
            window = self._windows.get(key)
            if window is None:
                window = self._windows[key] = deque(maxlen=pol.drift_window)
                self._distances[key] = []
            past = self._distances[key]
            if len(window) < pol.drift_min_samples:
                window.append(hist)
                return None
            baseline = np.mean(np.stack(list(window)), axis=0)
            dist = leaf_drift_distance(hist, baseline)
            if len(past) >= 2:
                med = statistics.median(past)
                mad = statistics.median(abs(d - med) for d in past)
                threshold = max(pol.drift_threshold, med + pol.drift_k_mad * mad)
            else:
                threshold = pol.drift_threshold
            self.m_drift_dist.labels(bucket=key).set(dist)
            if dist > threshold:
                window.clear()
                window.append(hist)
                past.clear()
                drifted = True
            else:
                window.append(hist)
                past.append(dist)
                drifted = False
        if drifted:
            self.m_drift.labels(bucket=key).inc()
            self.tracer.instant("prof.drift", cat="prof", bucket=key,
                                distance=dist, engine=self.engine)
            return dist
        return None
