"""Wave-batched tree-classification serving on the card.

The port's counterpart of the JAX package's ``serve/engine.py``, for its
tree-classification path: :class:`TreeServeEngine` coalesces requests into
waves of up to ``max_batch`` records and classifies each wave with one call
of a :class:`repro_torch.tune.TunedEvaluator`, which routes it through the
cached-best kernel variant for its shape bucket.  Around the wave loop:

* a :class:`BackgroundRetuner` re-measures buckets that prove hot under a
  :class:`RetunePolicy` on a worker thread and promotes the winner
  atomically;
* a :class:`repro_torch.obs.TraversalProfiler` shadow-profiles sampled waves
  (measured d_µ for the §3.6 heuristic, leaf-hit drift that forces a
  re-tune);
* an optional :class:`repro_torch.obs.FlightRecorder` keeps the recent waves
  and writes debug bundles.

Streams.  The request thread runs its waves on the current stream of the
card (the default stream) and makes one device→host copy per wave.  The
retuner's measurements and the profiler's shadow passes run on streams of
their own, one each per engine: their CUDA-event timing and their host
copies wait on their own stream only, so a worker never waits on serving
kernels and never prices them into a candidate's median, and the request
thread never waits on a worker.  The kernels of both streams share the card,
so a measurement taken while waves are served sees their contention.

Not ported here: the JAX package's LM ``ServeEngine`` (it waits for the LM
substrates) and its ``ForestServeEngine`` / ``AnytimePolicy`` (they serve
through the dist executor, which waits for the dist slice).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import _device, obs


def _make_flight(flight, registry, tracer, engine: str):
    """Coerce the ``flight=`` argument (policy or ready recorder) into a
    :class:`repro_torch.obs.FlightRecorder` sharing the engine's registry and
    tracer."""
    if flight is None:
        return None
    if isinstance(flight, obs.FlightRecorder):
        return flight
    return obs.FlightRecorder(flight, registry=registry, tracer=tracer, engine=engine)


def _worker_stream(device: torch.device) -> Callable[[], contextlib.AbstractContextManager]:
    """A context factory that runs a worker's device work on a stream of its own
    (a no-op off the card)."""
    if device.type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.Stream(device=device)
    return lambda: torch.cuda.stream(stream)


# ---------------------------------------------------------------------------
# Background re-tune policy (hot-bucket re-measurement, off the request path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetunePolicy:
    """When and how a serve engine re-measures hot shape buckets.

    The tune-on-first-miss policy (``autotune=True``) blocks the first wave
    of every new bucket on a full measurement sweep — fine for benches,
    wrong for serving.  Under this policy the engine resolves new buckets
    instantly (cache hit or §3.6 heuristic) and *promotes* buckets that
    prove hot: once a bucket has served ``hot_waves`` waves, a background
    thread re-measures its candidate space with the real wave data and
    atomically swaps the winner in.  Requests never wait on a measurement,
    and because every candidate is exact, a swap mid-traffic cannot change
    any result — only its latency.

    Attributes:
      hot_waves: waves a bucket must serve before it is re-measured.
      warmup / iters: measurement discipline forwarded to the tuner
        (kept small — the measurement shares the card with live traffic).
      max_concurrent: measurement threads allowed at once; a hot bucket
        that cannot start immediately retries on its next wave.
    """

    hot_waves: int = 32
    warmup: int = 1
    iters: int = 3
    max_concurrent: int = 1


class BackgroundRetuner:
    """Drives :class:`RetunePolicy` for one engine: counts bucket hits,
    launches measurement threads, promotes winners.

    ``measure(batch)`` must run the tuner (persisting the winner to the
    shared cache) and return the winning entry; ``promote(key, entry)``
    must atomically swap the engine's evaluator onto it (see
    ``TunedEvaluator.promote``).  Both run on the worker thread — the
    request path only pays a counter increment.  A measurement that raises
    never takes serving down: it is counted (``serve.retune.failed``) and
    kept in ``errors``.
    """

    def __init__(self, measure: Callable, promote: Callable, policy: RetunePolicy,
                 *, registry: obs.Registry | None = None,
                 tracer: obs.Tracer | None = None):
        self.measure = measure
        self.promote = promote
        self.policy = policy
        self.hits: dict[str, int] = {}
        self.started: set[str] = set()
        self.done: list[tuple[str, object]] = []     # (bucket key, winning entry)
        self.errors: list[tuple[str, Exception]] = []
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        r = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.m_launched = r.counter(
            "serve.retune.launched", "background re-tune measurements started")
        self.m_completed = r.counter(
            "serve.retune.completed", "background re-tunes promoted")
        self.m_failed = r.counter(
            "serve.retune.failed", "background re-tunes that raised")
        self.m_forced = r.counter(
            "serve.retune.forced", "re-tunes forced by the drift detector")
        self.m_measure_ms = r.histogram(
            "serve.retune.measure_ms", "background measurement wall time")

    def _launch(self, key: str, batch: np.ndarray) -> threading.Thread:
        """Start a measurement thread for ``key`` (caller holds ``_lock``)."""
        self.started.add(key)
        snap = np.array(batch, copy=True)  # the wave buffer is reused
        th = threading.Thread(target=self._work, args=(key, snap), daemon=True,
                              name=f"retune:{key}")
        self._threads.append(th)
        return th

    def force(self, key: str, batch: np.ndarray) -> bool:
        """Launch a re-tune for ``key`` immediately (drift detector hook).

        Bypasses the hot-waves gate *and* the once-per-bucket ``started``
        guard — a drifted bucket was tuned for traffic that no longer
        exists.  Still respects ``max_concurrent`` and never runs two
        measurements of the same bucket at once; returns False when no
        worker slot was available.
        """
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            if len(self._threads) >= self.policy.max_concurrent:
                return False
            if any(t.name == f"retune:{key}" for t in self._threads):
                return False
            th = self._launch(key, batch)
        self.m_launched.inc()
        self.m_forced.inc()
        th.start()
        return True

    def note(self, key: str, batch: np.ndarray) -> None:
        """Record one served wave for ``key``; maybe launch a re-tune."""
        with self._lock:
            n = self.hits[key] = self.hits.get(key, 0) + 1
            if n < self.policy.hot_waves or key in self.started:
                return
            self._threads = [t for t in self._threads if t.is_alive()]
            if len(self._threads) >= self.policy.max_concurrent:
                return  # retried on the bucket's next wave
            th = self._launch(key, batch)
        self.m_launched.inc()
        th.start()

    def _work(self, key: str, batch: np.ndarray) -> None:
        try:
            t0 = time.perf_counter()
            with self.tracer.span("serve.retune.measure", cat="serve", bucket=key):
                entry = self.measure(batch)
            self.m_measure_ms.observe((time.perf_counter() - t0) * 1e3)
            with self.tracer.span("serve.retune.promote", cat="serve", bucket=key):
                self.promote(key, entry)
            self.m_completed.inc()
            with self._lock:
                self.done.append((key, entry))
        except Exception as e:  # a failed re-tune must never take serving down
            self.m_failed.inc()
            with self._lock:
                self.errors.append((key, e))

    def drain(self, timeout: float | None = None) -> None:
        """Join outstanding measurement threads (tests / shutdown)."""
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    @property
    def retunes(self) -> int:
        with self._lock:
            return len(self.done)


# ---------------------------------------------------------------------------
# Tree-classification serving (the paper's workload as a service)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeRequest:
    """One classification request: a batch of records to assign classes."""

    uid: int
    records: np.ndarray                 # (m, A) float32
    out: Optional[np.ndarray] = None    # (m,) int32 once served
    done: bool = False
    # anytime serving only: per-record answer confidence in [0, 1]
    confidence: Optional[np.ndarray] = None


def _next_wave(queue: deque, max_batch: int) -> tuple[list, int]:
    """Pop the next record-count-bounded wave off the request queue.

    Greedy prefix up to ``max_batch`` total records; an oversize request
    forms a singleton wave (it cannot split across waves)."""
    wave, total = [], 0
    while queue and (not wave or total + queue[0].records.shape[0] <= max_batch):
        r = queue.popleft()
        wave.append(r)
        total += r.records.shape[0]
    return wave, total


class _ClassifierStatsBase:
    """Shared serve-engine instruments.

    One parent instrument per metric, labelled by ``engine`` so a registry
    shared across engines keeps the series apart; each stats object holds
    its engine's labelled children as ``m_*`` handles.  Read properties give
    the plain counts — including ``retunes``, which the
    :class:`BackgroundRetuner` worker increments concurrently with the
    request thread.
    """

    _engine = "classifier"

    def __init__(self, registry: obs.Registry | None = None):
        self.registry = registry if registry is not None else obs.Registry()
        r, eng = self.registry, self._engine
        lbl = {"engine": eng}
        self.m_waves = r.counter(
            "serve.waves", "classification waves served", ("engine",)).labels(**lbl)
        self.m_records = r.counter(
            "serve.records", "records served", ("engine",)).labels(**lbl)
        self.m_eval_s = r.counter(
            "serve.eval_s", "wave evaluation seconds", ("engine",)).labels(**lbl)
        self.m_padded_slots = r.counter(
            "serve.padded_record_slots",
            "bucket-padding rows (the wave's idle lanes)", ("engine",)).labels(**lbl)
        self.m_retunes = r.counter(
            "serve.retunes", "background winner promotions completed",
            ("engine",)).labels(**lbl)
        self._bucket_waves = r.counter(
            "serve.bucket_waves", "waves served per shape bucket",
            ("engine", "bucket"))
        self._wave_ms = r.histogram(
            "serve.wave_ms", "wave latency per shape bucket", ("engine", "bucket"))
        self.m_queue_wait_ms = r.histogram(
            "serve.queue_wait_ms",
            "time a request waited in the queue before its wave started",
            ("engine",)).labels(**lbl)
        self.m_pad_fraction = r.histogram(
            "serve.pad_fraction", "padding rows / bucket rows per wave",
            ("engine",), boundaries=obs.DEFAULT_RATIO_BOUNDARIES).labels(**lbl)

    def wave_ms(self, bucket: str) -> obs.Histogram:
        """The wave-latency histogram series for one shape bucket."""
        return self._wave_ms.labels(engine=self._engine, bucket=bucket)

    def note_bucket_wave(self, bucket: str) -> None:
        self._bucket_waves.labels(engine=self._engine, bucket=bucket).inc()

    @property
    def waves(self) -> int:
        return int(self.m_waves.value)

    @property
    def records(self) -> int:
        return int(self.m_records.value)

    @property
    def eval_s(self) -> float:
        return self.m_eval_s.value

    @property
    def padded_record_slots(self) -> int:
        return int(self.m_padded_slots.value)

    @property
    def retunes(self) -> int:
        return int(self.m_retunes.value)

    @property
    def bucket_waves(self) -> dict:
        """{bucket key: waves served} — reconstructed from the labelled series."""
        return {
            labels[1]: int(series.value)
            for labels, series in self._bucket_waves.series()
            if labels[0] == self._engine
        }


class TreeEngineStats(_ClassifierStatsBase):
    _engine = "tree"


class TreeServeEngine:
    """Wave-batched classification over one tree via autotuned dispatch.

    Requests are coalesced into waves of up to ``max_batch`` records and
    evaluated with one :class:`repro_torch.tune.TunedEvaluator` call, which
    routes each wave through the cached-best kernel variant for its shape
    bucket (padded to the bucket's M on the card; the padding rows are
    recorded in the stats as the wave's idle-lane cost).  Each wave's classes
    come back to the host in one device→host copy.

    Kernel selection policy: a new bucket resolves instantly (cache hit or
    the §3.6 heuristic); buckets that prove *hot* under the ``retune``
    policy are re-measured on a background thread with real wave data and
    the winner is swapped in atomically (:class:`RetunePolicy`).  The
    blocking tune-on-first-miss behaviour remains available as
    ``autotune=True``.  ``device``: where the tree is served; default the
    card (without one, pass ``device="cpu"``).  ``sweeps`` keeps each
    bucket's latest background measurements.
    """

    def __init__(self, tree, *, max_batch: int = 4096, cache=None,
                 autotune: bool = False, engines=None,
                 retune: RetunePolicy | None = RetunePolicy(),
                 profile: "obs.ProfilePolicy | None" = obs.ProfilePolicy(),
                 registry: obs.Registry | None = None,
                 tracer: obs.Tracer | None = None,
                 flight: "obs.FlightPolicy | obs.FlightRecorder | None" = None,
                 device=None):
        from repro_torch.kernels.tree_eval.profile import TreeProfile, profile_tree_eval
        from repro_torch.tune.dispatch import TunedEvaluator
        from repro_torch.tune.measure import tune_workload
        from repro_torch.tune.space import Candidate, WorkloadShape, backend_tag

        self.device = _device.resolve(None, device)
        self._backend = backend_tag(self.device)
        self._shape_of = WorkloadShape.of
        self.obs = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.flight = _make_flight(flight, self.obs, self.tracer, "tree")
        self.tree = tree
        self.max_batch = max_batch
        self.stats = TreeEngineStats(self.obs)
        self.sweeps: dict[str, list] = {}
        self.retuner: BackgroundRetuner | None = None
        self.profiler: obs.TraversalProfiler | None = None
        if profile is not None:
            profile_stream = _worker_stream(self.device)

            def _profile_fn(batch):
                # on the profiler's stream, brought to the host there: the
                # shadow pass never waits on the waves being served
                with profile_stream():
                    prof = profile_tree_eval(batch, tree, device=self.device)
                    return TreeProfile(*(x.cpu() for x in prof))

            def _on_drift(key, distance, records):
                # drift = the bucket's tuned winner was picked for traffic
                # that no longer exists: annotate the flight ring and force
                # a background re-measurement on the drifted records
                if self.flight is not None:
                    self.flight.note_drift(bucket=key, distance=distance, engine="tree")
                if self.retuner is not None:
                    self.retuner.force(key, records)

            self.profiler = obs.TraversalProfiler(
                _profile_fn, profile, registry=self.obs, tracer=self.tracer,
                n_nodes=int(tree.n_nodes), on_drift=_on_drift, engine="tree")
        self._eval = TunedEvaluator(
            tree, cache=cache, autotune=autotune, engines=engines,
            registry=self.obs, tracer=self.tracer, profiler=self.profiler,
            device=self.device,
        )
        if retune is not None:
            retune_stream = _worker_stream(self.device)

            def measure(batch):
                with retune_stream():
                    entry, sweep = tune_workload(
                        batch, tree, cache=self._eval.cache, engines=engines,
                        warmup=retune.warmup, iters=retune.iters,
                        registry=self.obs, device=self.device,
                    )
                self.sweeps[self._key(batch)] = sweep
                return entry

            def promote(key, entry):
                self._eval.promote(key, Candidate.make(entry.variant, **entry.params))
                # locked counter: this runs on the retuner worker
                # concurrently with the request thread
                self.stats.m_retunes.inc()

            self.retuner = BackgroundRetuner(
                measure, promote, retune, registry=self.obs, tracer=self.tracer)

    def _key(self, batch: np.ndarray) -> str:
        """The shape-bucket key of a wave (the evaluator's and profiler's)."""
        return self._shape_of(batch, self.tree, self._eval.depth).key(self._backend)

    def run(self, requests: list[TreeRequest]) -> list[TreeRequest]:
        """Serve all requests in record-count-bounded waves."""
        queue = deque(requests)
        t_enq = time.perf_counter()
        for r in queue:
            r._t_enqueue = t_enq
        while queue:
            self._run_wave(*_next_wave(queue, self.max_batch))
        return requests

    def _run_wave(self, wave: list[TreeRequest], total: int) -> None:
        t_wave = time.perf_counter()
        for r in wave:
            enq = getattr(r, "_t_enqueue", None)
            if enq is not None:
                self.stats.m_queue_wait_ms.observe((t_wave - enq) * 1e3)
        self.stats.m_waves.inc()
        self.stats.m_records.inc(total)
        batch = np.concatenate([r.records for r in wave], axis=0).astype(np.float32)
        shape = self._shape_of(batch, self.tree, self._eval.depth)
        key = shape.key(self._backend)
        bucket_m = shape.bucket().m
        self.stats.m_padded_slots.inc(bucket_m - total)
        self.stats.m_pad_fraction.observe((bucket_m - total) / max(bucket_m, 1))
        with self.tracer.span("serve.wave", cat="serve", engine="tree",
                              requests=len(wave), records=total, bucket=key):
            t0 = time.perf_counter()
            try:
                with self.tracer.span("kernel.dispatch", cat="kernel", bucket=key):
                    out = self._eval(batch).cpu().numpy()   # the wave's one copy back
            except BaseException as exc:
                if self.flight is not None:
                    self.flight.note_exception(exc)
                raise
            dt = time.perf_counter() - t0
        self.stats.m_eval_s.inc(dt)
        self.stats.wave_ms(key).observe(dt * 1e3)
        if self.flight is not None:
            self.flight.note_wave(latency_ms=dt * 1e3, bucket=key,
                                  records=total, requests=len(wave))
        off = 0
        for r in wave:
            m = r.records.shape[0]
            r.out = out[off:off + m]
            r.done = True
            off += m
        self.stats.note_bucket_wave(key)
        if self.profiler is not None:
            self.profiler.note_wave(key, batch)
        if self.retuner is not None:
            self.retuner.note(key, batch)

    def dump_flight(self, reason: str = "manual"):
        """Write a flight-recorder debug bundle now; returns its path.

        Requires the engine to have been built with ``flight=``.
        """
        if self.flight is None:
            raise RuntimeError("engine built without flight= recorder")
        return self.flight.dump(reason)
