"""Wave-batched tree and forest classification serving on the card.

The port's counterpart of the JAX package's ``serve/engine.py``, for its
classification paths.  :class:`TreeServeEngine` coalesces requests into
waves of up to ``max_batch`` records and classifies each wave with one call
of a :class:`repro_torch.tune.TunedEvaluator`, which routes it through the
cached-best kernel variant for its shape bucket.
:class:`ForestServeEngine` does the same for a forest: each wave streams
through the :mod:`repro_torch.dist` executor behind a
:class:`~repro_torch.dist.StreamingChunker` (pinned, double-buffered copies
on a copy stream), then a majority vote; under an :class:`AnytimePolicy` a
wave runs instead through the early-exit cascade with the SLO as its
deadline.  Around the wave loops:

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
substrates).
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

_STAGE_BOUNDARIES = tuple(float(i) for i in range(1, 9))


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
    # anytime serving only: per-record answer confidence in [0, 1], and the
    # cascade stage each record exited at (-1: it never cleared the bound)
    confidence: Optional[np.ndarray] = None
    exit_stage: Optional[np.ndarray] = None


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


# ---------------------------------------------------------------------------
# Sharded-forest serving (repro_torch.dist as a service)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnytimePolicy:
    """Anytime serving: answer within an SLO by truncating cascade stages.

    The engine evaluates each wave through an early-exit cascade
    (:class:`repro_torch.kernels.tree_eval.CascadeEvaluator`) with the SLO as
    the per-wave deadline: stage 0 always runs, and each later stage runs
    only if its predicted latency (per-stage EMA) fits the remaining budget.
    Requests report per-record ``confidence`` — 1.0 where the class is
    provably final, the partial-margin ratio where the deadline cut the
    forest short.

    Attributes:
      slo_ms: per-wave latency budget in milliseconds.
      stages: cascade stage count (more stages = finer truncation grain).
      bound: early-exit bound; 1.0 keeps non-truncated answers exact.
      calibration_sample: records from the first wave used to rank trees.
      algorithm / jump_mode: the stage kernels' (K5 speculative in either
        form, K6 data-parallel); the default is the cascade's own.
    """

    slo_ms: float
    stages: int = 3
    bound: float = 1.0
    calibration_sample: int = 512
    algorithm: str = "speculative"
    jump_mode: str = "gather"


class ForestEngineStats(_ClassifierStatsBase):
    _engine = "forest"

    def __init__(self, registry: obs.Registry | None = None):
        super().__init__(registry)
        r = self.registry
        lbl = {"engine": self._engine}
        self.m_chunks = r.counter(
            "serve.chunks", "streaming chunks across all waves",
            ("engine",)).labels(**lbl)
        self.m_chunk_ms = r.histogram(
            "serve.chunk_ms", "per-chunk latency", ("engine",)).labels(**lbl)
        self.m_anytime_waves = r.counter(
            "serve.anytime.waves", "waves served through the anytime cascade")
        self.m_anytime_truncations = r.counter(
            "serve.anytime.truncations",
            "waves the SLO stopped before the last stage")
        self.m_anytime_stages = r.histogram(
            "serve.anytime.stages_run", "cascade stages run per anytime wave",
            boundaries=_STAGE_BOUNDARIES)
        self.m_anytime_confidence = r.histogram(
            "serve.anytime.confidence", "per-record answer confidence",
            boundaries=obs.DEFAULT_RATIO_BOUNDARIES)
        # raw per-chunk / per-wave sequences survive as plain lists — benches
        # take medians over them and tests index into them
        self.chunk_ms: list = []
        self.anytime_stages: list = []

    @property
    def chunks(self) -> int:
        return int(self.m_chunks.value)

    @property
    def anytime_waves(self) -> int:
        return int(self.m_anytime_waves.value)

    @property
    def anytime_truncations(self) -> int:
        return int(self.m_anytime_truncations.value)


class ForestServeEngine:
    """Wave-batched forest classification over a device grid.

    The forest analogue of :class:`TreeServeEngine`: requests coalesce into
    waves of up to ``max_batch`` records, each wave runs through the
    ``repro_torch.dist`` sharded executor behind a streaming chunker, so the
    host→device copy of one chunk overlaps evaluation of the previous
    (double buffering through pinned memory).  Per-chunk latencies land in
    ``stats.chunk_ms``.  With ``n_classes`` set, requests get majority-vote
    classes (m,); otherwise per-tree assignments (T, m).

    Hot forest buckets are re-measured in the background under the
    ``retune`` policy (all three forest candidate families on one device, the
    fused kernels at the shard shape on a grid; real wave data cut to the
    chunker's chunk size, which is the batch the executor resolves; on a
    stream of the worker's own); the freshly stored winner is picked up atomically
    via ``ShardedForestEvaluator.invalidate_resolution`` — see
    :class:`RetunePolicy`.  ``sweeps`` keeps each bucket's latest
    measurements.

    ``devices`` (default every card; ``("cpu",)`` serves on the host) names
    the devices the planner may lay its grid over; ``mesh``/``plan``/
    ``decomposition`` pin the grid.  The vote, the cascade and the shadow profiler run on the
    grid's first device.
    """

    def __init__(self, forest, *, max_batch: int = 65536, chunk_records: int = 8192,
                 n_classes: Optional[int] = None, mesh=None, plan=None,
                 decomposition=None, cache=None, autotune: bool = False, engines=None,
                 layouts=None,
                 retune: RetunePolicy | None = RetunePolicy(),
                 anytime: AnytimePolicy | None = None,
                 profile: "obs.ProfilePolicy | None" = obs.ProfilePolicy(),
                 registry: obs.Registry | None = None,
                 tracer: obs.Tracer | None = None,
                 flight: "obs.FlightPolicy | obs.FlightRecorder | None" = None,
                 devices=None):
        from repro_torch.dist import ShardedForestEvaluator, StreamingChunker
        from repro_torch.tune.space import backend_tag

        if anytime is not None and n_classes is None:
            raise ValueError("anytime serving needs n_classes (it votes classes)")
        self.obs = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.flight = _make_flight(flight, self.obs, self.tracer, "forest")
        self.profiler: obs.TraversalProfiler | None = None
        self.retuner: BackgroundRetuner | None = None
        self.sweeps: dict[str, list] = {}
        self._eval = ShardedForestEvaluator(
            forest, mesh=mesh, plan=plan, decomposition=decomposition,
            devices=devices,
            cache=cache, autotune=autotune, engines=engines, layouts=layouts,
            registry=self.obs, tracer=self.tracer,
        )
        self.forest = self._eval.forest
        self.device = self._eval.device
        self._backend = backend_tag(self.device)
        if profile is not None:
            from repro_torch.kernels.tree_eval.profile import ForestProfile, profile_forest_eval

            profile_stream = _worker_stream(self.device)

            def _profile_fn(batch):
                # on the profiler's stream, brought to the host there: the
                # shadow pass never waits on the waves being served
                with profile_stream():
                    prof = profile_forest_eval(batch, self.forest, device=self.device)
                    return ForestProfile(*(x.cpu() for x in prof))

            def _on_drift(key, distance, records):
                if self.flight is not None:
                    self.flight.note_drift(bucket=key, distance=distance, engine="forest")
                if self.retuner is not None:
                    self.retuner.force(key, records)

            self.profiler = obs.TraversalProfiler(
                _profile_fn, profile, registry=self.obs, tracer=self.tracer,
                n_classes=n_classes, on_drift=_on_drift, engine="forest")
            # measured per-bucket d_µ / survival flow into the forest
            # evaluator's heuristic resolutions
            self._eval.profiler = self.profiler
        self._chunker = StreamingChunker(
            self._eval, chunk_records=chunk_records,
            registry=self.obs, tracer=self.tracer,
        )
        self.max_batch = max_batch
        self.n_classes = n_classes
        self.anytime = anytime
        self._cascade = None   # built lazily: calibrated on the first wave
        self.stats = ForestEngineStats(self.obs)
        if retune is not None:
            retune_stream = _worker_stream(self.device)

            def measure(batch):
                # the executor owns key consistency: single-device measures
                # the forest bucket, a grid measures the *shard* operating
                # point — either way the winner lands where the next
                # resolution looks
                # at the chunk size the chunker runs: its chunks, not the
                # whole wave, are what the executor resolves
                with retune_stream():
                    entry = self._eval.retune(batch[: self._chunker.effective_chunk_records],
                                              warmup=retune.warmup, iters=retune.iters)
                self.sweeps[self._key(batch)] = self._eval.last_sweep
                return entry

            def promote(key, entry):
                # the measurement already stored the winner; dropping
                # resolution state makes the next wave pick it up — the
                # executor-level analogue of TunedEvaluator.promote
                self._eval.invalidate_resolution()
                # locked counter: this runs on the retuner worker
                # concurrently with the request thread
                self.stats.m_retunes.inc()

            self.retuner = BackgroundRetuner(
                measure, promote, retune, registry=self.obs, tracer=self.tracer)

    @property
    def plan(self):
        """The executor's chosen ShardPlan (None until the first wave)."""
        return self._eval.plan

    def _key(self, batch: np.ndarray) -> str:
        """The forest-bucket key of a wave (the evaluator's and profiler's)."""
        return self._eval._forest_evaluator().shape_of(batch).key(self._backend)

    def run(self, requests: list[TreeRequest]) -> list[TreeRequest]:
        """Serve all requests in record-count-bounded waves."""
        queue = deque(requests)
        t_enq = time.perf_counter()
        for r in queue:
            r._t_enqueue = t_enq
        while queue:
            self._run_wave(*_next_wave(queue, self.max_batch))
        return requests

    def _anytime_cascade(self, batch: np.ndarray):
        """The wave cascade, built once and calibrated on the first wave."""
        if self._cascade is None:
            from repro_torch.kernels.tree_eval import CascadeEvaluator

            pol = self.anytime
            self._cascade = CascadeEvaluator(
                self.forest,
                n_classes=self.n_classes,
                bound=pol.bound,
                stages=pol.stages,
                algorithm=pol.algorithm,
                jump_mode=pol.jump_mode,
                calibration=batch[: pol.calibration_sample],
                registry=self.obs,
                tracer=self.tracer,
                device=self.device,
            )
        return self._cascade

    def _run_wave(self, wave: list[TreeRequest], total: int) -> None:
        try:
            self._run_wave_inner(wave, total)
        except BaseException as exc:
            if self.flight is not None:
                self.flight.note_exception(exc)
            raise

    def _run_wave_inner(self, wave: list[TreeRequest], total: int) -> None:
        t_wave = time.perf_counter()
        for r in wave:
            enq = getattr(r, "_t_enqueue", None)
            if enq is not None:
                self.stats.m_queue_wait_ms.observe((t_wave - enq) * 1e3)
        self.stats.m_waves.inc()
        self.stats.m_records.inc(total)
        batch = np.concatenate([r.records for r in wave], axis=0).astype(np.float32)
        wspan = self.tracer.span(
            "serve.wave", cat="serve", engine="forest",
            requests=len(wave), records=total,
            mode="anytime" if self.anytime is not None else "stream",
        )
        with wspan:
            if self.anytime is not None:
                # anytime path: the cascade owns staging/early exit, so the
                # wave bypasses the chunker — the SLO check needs whole-stage
                # latencies
                cascade = self._anytime_cascade(batch)
                t0 = time.perf_counter()
                res = cascade(batch, deadline_ms=self.anytime.slo_ms)
                classes = res.classes.cpu().numpy()
                confidence = res.confidence.cpu().numpy()
                exit_stage = res.exit_stage.cpu().numpy()
                trees_evaluated = res.trees_evaluated.cpu().numpy()
                dt = time.perf_counter() - t0
                self.stats.m_eval_s.inc(dt)
                self.stats.m_anytime_waves.inc()
                self.stats.m_anytime_stages.observe(res.stages_run)
                self.stats.anytime_stages.append(res.stages_run)
                # truncation = the deadline (not the exit bound) stopped the
                # run: some record never cleared the bound yet has trees left
                # unvoted
                truncated = res.stages_run < cascade.plan.n_stages and bool(
                    np.any((exit_stage < 0) & (trees_evaluated < cascade.plan.n_trees))
                )
                if truncated:
                    self.stats.m_anytime_truncations.inc()
                self.stats.m_anytime_confidence.observe_many(confidence.astype(np.float64))
                wspan.set(stages_run=res.stages_run, truncated=truncated)
                off = 0
                for r in wave:
                    m = r.records.shape[0]
                    r.out = classes[off:off + m]
                    r.confidence = confidence[off:off + m]
                    r.exit_stage = exit_stage[off:off + m]
                    r.done = True
                    off += m
            else:
                def on_chunk(latency_ms: float, n: int) -> None:
                    self.stats.m_chunks.inc()
                    self.stats.m_chunk_ms.observe(latency_ms)
                    self.stats.chunk_ms.append(latency_ms)

                t0 = time.perf_counter()
                per_tree = self._chunker.eval(batch, on_chunk=on_chunk)   # (T, total)
                if self.n_classes is not None:
                    from repro_torch.core.forest import majority_vote

                    with self.tracer.span("serve.vote", cat="serve", records=total):
                        out = majority_vote(torch.from_numpy(per_tree), self.n_classes).numpy()
                else:
                    out = per_tree
                dt = time.perf_counter() - t0
                self.stats.m_eval_s.inc(dt)
                off = 0
                for r in wave:
                    m = r.records.shape[0]
                    r.out = out[off:off + m] if self.n_classes is not None else out[:, off:off + m]
                    r.done = True
                    off += m
            key = self._key(batch)
            wspan.set(bucket=key)
        self.stats.wave_ms(key).observe(dt * 1e3)
        self.stats.note_bucket_wave(key)
        if self.flight is not None:
            self.flight.note_wave(
                latency_ms=dt * 1e3, bucket=key, records=total,
                requests=len(wave),
                mode="anytime" if self.anytime is not None else "stream",
            )
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

