"""Candidate timing: warmup, synchronised runs, medians, scores.

The paper's measurement discipline applied to each candidate: warm the
candidate outside the timed region, time each call to its completion on the
device, and take the *median* over several calls so one-off scheduling noise
doesn't crown the wrong variant.

On the card a sample is the call's device time with the host's enqueue
hidden: a spin on the device (``torch.cuda._sleep``) goes ahead of the start
event, so the stream reaches the start event only after the host has
enqueued the call and its end event, and the window holds the call's device
work and nothing of the host.  Each sample is checked: if the start event
has already completed when the end event is enqueued, the spin ran out
before the host was done, the window may hold host time (a wait for the
interpreter lock on a worker thread), and the sample is retaken with a
spin ``SPIN_GROWTH`` times longer, ``SPIN_TRIES`` times at most before
:class:`HostNotHidden` is raised; a contaminated sample is never scored.
The events are recorded on the stream the candidate runs on (the calling
thread's current stream) and the host waits on the end event only, so a
tuner measuring on a worker thread's own stream neither waits on nor prices
the kernels a request thread runs meanwhile (though they share the card).

Device time alone would price a per-tree family's sixteen launches as one,
so a candidate's **score** adds the host cost of its launches:
``score_ms = median_ms + launches a call × launch_cost_ms``, with the cost of
one launch measured once per process and device through the kernels' ctypes
path (``kernel.launch_cost_ms``).  Candidates are ranked by the score.  The
class level (majority vote against cascades) keeps events around the whole
call, host included: a cascade reads its survivor count back every stage,
so its host loop is its cost and no spin could hide it.  On the host the
clock brackets each call and the score is the median.

A candidate that cannot run at the shape — its record tile does not fit a
CTA (``kernel.TileError``) — measures as ∞ and loses.  Any other exception
(a failed ``nvcc`` build, a launch error, a poisoned CUDA context)
propagates: it is a fault, never a slow candidate.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import _device, obs
from repro_torch.kernels.tree_eval import kernel as _k
from repro_torch.kernels.tree_eval.cascade import MAJORITY_FAMILY, get_cascade_variant
from repro_torch.kernels.tree_eval.ops import (
    PER_TREE_FAMILY,
    PackedForest,
    PackedTree,
    get_forest_variant,
    get_variant,
)
from repro_torch.kernels.tree_eval.quant import QuantizedForest, forest_table_bytes
from repro_torch.launch import roofline
from repro_torch.tune.cache import TuneCache, TuneEntry
from repro_torch.tune.space import (
    Candidate,
    ForestShape,
    WorkloadShape,
    backend_tag,
    cascade_search_space,
    forest_search_space,
    search_space,
)


@dataclasses.dataclass(frozen=True)
class Measurement:
    candidate: Candidate
    median_ms: float
    samples_ms: tuple[float, ...]
    # Analytic cost of the call — ``{"flops", "bytes", "roofline_frac"}``
    # from ``launch.roofline.tree_eval_cost`` (flops: the compares), or None
    # for candidates without one packed target (per-tree family, cascades).
    cost: dict | None = None
    # Device-resident node-table bytes of the candidate's layout, or None
    # for candidates without a packed target (per-tree family).
    table_bytes: float | None = None
    # Kernel launches of this candidate's calls, by ``kernel.LAUNCHES`` key
    # (this thread's only, warmup and retaken samples included); empty for
    # the torch engine.
    launches: dict = dataclasses.field(default_factory=dict)
    # What the tuner ranks by: the median plus the host cost of a call's
    # launches (see the module docstring); ∞ for a failed candidate.
    score_ms: float = float("inf")

    @property
    def failed(self) -> bool:
        return not self.samples_ms

    @property
    def mad_ms(self) -> float:
        """Median absolute deviation of the samples (the noise floor)."""
        if not self.samples_ms:
            return 0.0
        med = _median(self.samples_ms)
        return _median([abs(s - med) for s in self.samples_ms])


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def candidate_cost(m: int, a: int, t: int, n: int, depth: int, *,
                   median_ms: float | None = None, table_bytes: float | None = None) -> dict:
    """Bytes / compares / roofline fraction of one call at this shape.

    The analytic count of :func:`repro_torch.launch.roofline.tree_eval_cost`
    (the one ``chip_smoke.py`` bounds its kernels with), with the compares'
    upper bound ``m·t·depth``: the tuner does not walk the records to count
    their depths.
    """
    cost = roofline.tree_eval_cost(m, a, t, n, m * t * depth, table_bytes=table_bytes)
    out = {"flops": cost["ops"], "bytes": cost["bytes"]}
    if median_ms is not None:
        out["roofline_frac"] = roofline.roofline_fraction(cost["bytes"], cost["ops"], median_ms)
    return out


def _note_measurements(registry, level: str, measurements) -> None:
    """Record one sweep's outcomes: per-candidate medians and failure count.

    Levels mirror the dispatch ladder (``tree`` / ``forest`` / ``classes``);
    without an explicit registry the sweep lands in the process default.
    """
    r = registry if registry is not None else obs.default_registry()
    measured = r.counter(
        "tune.measurements", "candidates measured per sweep", ("level",))
    failed = r.counter(
        "tune.failed_candidates",
        "candidates whose tile did not fit (scored as infinitely slow)", ("level",))
    ms = r.histogram(
        "tune.measure_ms", "per-candidate median measurement time",
        ("level",)).labels(level=level)
    g_median = r.gauge(
        "tune.candidate_median_ms", "latest median of each measured candidate",
        ("level", "variant", "params"))
    g_score = r.gauge(
        "tune.candidate_score_ms",
        "latest score of each measured candidate (median + launches x launch cost)",
        ("level", "variant", "params"))
    g_flops = r.gauge(
        "tune.candidate_flops", "analytic compares of the measured candidate's call",
        ("level", "variant"))
    g_bytes = r.gauge(
        "tune.candidate_bytes", "analytic bytes of the measured candidate's call",
        ("level", "variant"))
    g_roof = r.gauge(
        "tune.roofline_frac",
        "achieved fraction of the H100 bound (see launch/roofline.py)",
        ("level", "variant"))
    g_tbytes = r.gauge(
        "tune.candidate_table_bytes",
        "node-table bytes the candidate's layout keeps device-resident",
        ("level", "variant"))
    for m in measurements:
        measured.labels(level=level).inc()
        v = m.candidate.variant
        if m.failed:
            failed.labels(level=level).inc()
        else:
            ms.observe(m.median_ms)
            g_median.labels(level=level, variant=v,
                            params=repr(m.candidate.param_dict)).set(m.median_ms)
            g_score.labels(level=level, variant=v,
                           params=repr(m.candidate.param_dict)).set(m.score_ms)
        if m.cost is not None:
            g_flops.labels(level=level, variant=v).set(m.cost["flops"])
            g_bytes.labels(level=level, variant=v).set(m.cost["bytes"])
            g_roof.labels(level=level, variant=v).set(m.cost.get("roofline_frac", 0.0))
        if m.table_bytes is not None:
            g_tbytes.labels(level=level, variant=v).set(m.table_bytes)


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


SPIN_MS = 1.0        # device spin ahead of a sample's start event, first try
SPIN_GROWTH = 4      # a sample whose spin ran out is retaken with a spin this much longer
SPIN_TRIES = 6       # tries a sample gets before HostNotHidden (1 ms … 1,024 ms of spin)
SPIN_CYCLES_PER_MS = 2_000_000   # clock cycles a millisecond of spin asks for (≤ 2 GHz: at least that long)


class HostNotHidden(RuntimeError):
    """The host's enqueue of a call outlasted every spin a sample may take."""


def _spin(ms: float) -> None:
    torch.cuda._sleep(int(ms * SPIN_CYCLES_PER_MS))


def _event():
    return torch.cuda.Event(enable_timing=True)


def hidden_sample(fn, *, spin_ms: float = SPIN_MS, tries: int = SPIN_TRIES,
                  spin=_spin, event=_event) -> tuple[float, float]:
    """One device-time sample of ``fn()`` with the host's enqueue hidden.

    Enqueues a spin of ``spin_ms``, the start event, ``fn()`` and the end
    event on the current stream.  If the start event is still pending once
    the end event is enqueued, the window holds device work only and its
    time is the sample; otherwise the sample is dropped and retaken with a
    spin ``SPIN_GROWTH`` times longer.  ``spin``/``event`` are injectable
    for tests.

    Returns:
      (milliseconds, the spin that hid the enqueue) — callers pass the spin
      on to the next sample.

    Raises:
      HostNotHidden: after ``tries`` contaminated samples.
    """
    for _ in range(tries):
        start, end = event(), event()
        spin(spin_ms)
        start.record()
        fn()
        end.record()
        hidden = not start.query()
        end.synchronize()
        if hidden:
            return start.elapsed_time(end), spin_ms
        spin_ms *= SPIN_GROWTH
    raise HostNotHidden(
        f"the host's enqueue outlasted a {spin_ms / SPIN_GROWTH:g} ms spin in {tries} tries"
    )


def time_callable(fn, *, warmup: int = 2, iters: int = 5, device=None,
                  hide_host: bool = True) -> tuple[float, ...]:
    """Millisecond samples of ``fn()``, each timed to its completion.

    Args:
      fn: zero-argument callable; called ``warmup`` times un-timed (build,
        caches) then ``iters`` times timed.
      warmup/iters: the measurement discipline (see module docstring).
      device: where ``fn`` runs.  On a CUDA device each sample is the call's
        device time (:func:`hidden_sample`), or with ``hide_host=False`` the
        events bracket the call as the host makes it (for calls that wait on
        the device themselves); elsewhere the host clock brackets each call.

    Returns:
      ``iters`` samples in milliseconds.
    """
    if _is_cuda(device):
        with torch.cuda.device(torch.device(device)):
            for _ in range(warmup):
                fn()
            samples, spin_ms = [], SPIN_MS
            for _ in range(iters):
                if hide_host:
                    ms, spin_ms = hidden_sample(fn, spin_ms=spin_ms)
                else:
                    start, end = _event(), _event()
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                samples.append(ms)
            return tuple(samples)
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return tuple(samples)


def score_ms(median_ms: float, launches: int, calls: int, launch_cost_ms: float) -> float:
    """A candidate's rank: its median plus the host cost of the launches one
    call makes (``launches`` over ``calls`` calls)."""
    return median_ms + launches / max(calls, 1) * launch_cost_ms


def interleaved_samples(
    fns: dict[str, object], *, warmup: int = 2, iters: int = 7, device=None
) -> dict[str, list[float]]:
    """Millisecond samples per callable, interleaved round-robin.

    Interleaving puts every contender in the same time window, and rotating
    the within-round order each iteration cancels the warm-cache advantage
    of running later in a round.  Sample i of each key comes from the same
    round, so per-round ratios (``a[i]/b[i]``) are paired statistics.
    """
    for fn in fns.values():
        time_callable(fn, warmup=warmup, iters=0, device=device)
    samples: dict[str, list[float]] = {k: [] for k in fns}
    keys = list(fns)
    for i in range(iters):
        for k in keys[i % len(keys):] + keys[: i % len(keys)]:
            samples[k] += time_callable(fns[k], warmup=0, iters=1, device=device)
    return samples


def interleaved_medians(fns: dict[str, object], *, warmup: int = 2, iters: int = 7,
                        device=None) -> dict[str, float]:
    """Median ms per callable over interleaved samples."""
    samples = interleaved_samples(fns, warmup=warmup, iters=iters, device=device)
    return {k: _median(v) for k, v in samples.items()}


def bucket_pad_records(records: torch.Tensor, bucket_m: int, *,
                       tracer: obs.Tracer = obs.NULL_TRACER) -> torch.Tensor:
    """Zero-pad the record batch up to the bucket's M, on its device.

    Rows past the real M cost what real rows cost, which is exactly what the
    bucket entry must price in.  Returned as-is when M already equals
    ``bucket_m``; the copy is a ``tune.pad`` span whose ``padded`` arg
    counts the rows added.
    """
    m = records.shape[0]
    if m == bucket_m:
        return records
    with tracer.span("tune.pad", cat="tune", records=m, padded=bucket_m - m):
        out = torch.zeros((bucket_m, records.shape[1]), dtype=records.dtype, device=records.device)
        out[:m] = records
        return out


def _measured(candidate: Candidate, run, device, warmup: int, iters: int, *,
              hide_host: bool = True, **extra) -> Measurement:
    """Time ``run`` for ``candidate`` and score it; a tile refusal scores ∞."""
    calls = 0

    def counted():
        nonlocal calls
        calls += 1
        return run()

    try:
        with _k.thread_launches() as launches:
            samples = time_callable(counted, warmup=warmup, iters=iters, device=device,
                                    hide_host=hide_host)
    except _k.TileError:
        return Measurement(candidate, float("inf"), (), launches=dict(launches))
    median = _median(samples)
    n_launches = sum(launches.values())
    cost = _k.launch_cost_ms(device) if hide_host and n_launches and _is_cuda(device) else 0.0
    return Measurement(candidate, median, samples, launches=dict(launches),
                       score_ms=score_ms(median, n_launches, calls, cost), **extra)


def measure_candidate(
    candidate: Candidate,
    records: torch.Tensor,
    enc,
    *,
    max_depth: int,
    warmup: int = 2,
    iters: int = 5,
) -> Measurement:
    """Median time of one candidate on ``records`` (already bucket-padded).

    A kernel candidate gets the tree packed on the records' device once,
    outside the timed region.  Only a tile refusal scores ∞; any other
    exception propagates.
    """
    spec = get_variant(candidate.variant)
    params = candidate.param_dict
    target = enc
    if spec.engine == "cuda":
        target = PackedTree(enc, records.shape[1], max_depth=max_depth, device=records.device)
    m = _measured(
        candidate, lambda: spec.fn(records, target, max_depth=max_depth, **params),
        records.device, warmup, iters)
    if m.failed:
        return m
    cost = candidate_cost(records.shape[0], records.shape[1], 1, int(enc.n_nodes), max_depth,
                          median_ms=m.median_ms)
    return dataclasses.replace(m, cost=cost)


def tune_workload(
    records,
    enc,
    *,
    cache: TuneCache | None = None,
    engines: tuple[str, ...] | None = None,
    warmup: int = 2,
    iters: int = 5,
    backend: str | None = None,
    verbose: bool = False,
    registry: obs.Registry | None = None,
    device=None,
) -> tuple[TuneEntry, list[Measurement]]:
    """Time every valid candidate for this workload and record the winner.

    Records go to ``device`` (default: where they lie, else CUDA) and are
    zero-padded to the shape bucket's M before timing, so the stored median
    prices the bucket (what dispatch will actually run).  Returns the
    winning entry (written to ``cache`` under the bucket key when a cache is
    given) plus all measurements.
    """
    dev = _device.resolve(records, device)
    backend = backend or backend_tag(dev)
    rec = _device.as_tensor(records, torch.float32, dev)
    shape = WorkloadShape.of(rec, enc)
    rec = bucket_pad_records(rec, shape.bucket().m)
    depth = max(shape.depth, 1)

    measurements = [
        measure_candidate(c, rec, enc, max_depth=depth, warmup=warmup, iters=iters)
        for c in search_space(shape, engines=engines, device=dev)
    ]
    _note_measurements(registry, "tree", measurements)
    ok = [m for m in measurements if not m.failed]
    if not ok:
        raise RuntimeError(f"no candidate succeeded for shape {shape}")
    best = min(ok, key=lambda m: m.score_ms)
    if verbose:
        for m in sorted(ok, key=lambda m: m.score_ms):
            print(f"  {m.score_ms:10.3f} ms  {m.candidate.variant} {m.candidate.param_dict}")
    entry = TuneEntry(
        variant=best.candidate.variant,
        params=best.candidate.param_dict,
        median_ms=best.median_ms,
        shape=dataclasses.asdict(shape),
        backend=backend,
    )
    if cache is not None:
        cache.store(shape.key(backend), entry)
    return entry, measurements


# ---------------------------------------------------------------------------
# Forest-level measurement
# ---------------------------------------------------------------------------


def _forest_candidate_fn(
    candidate: Candidate, rec: torch.Tensor, forest, *, depth: int, cache, engines,
    autotune_trees: bool = False, measure_kw: dict | None = None,
):
    """Build the timed callable for one forest candidate (warm state outside
    the timed region: per-tree winners resolved — autotuned when
    ``autotune_trees`` — and the fused tables packed on the records' device).

    Returns ``(fn, table_bytes)``: the callable of the record batch plus the
    node-table bytes of the candidate's packed layout (None for the per-tree
    family)."""
    if candidate.variant == PER_TREE_FAMILY:
        from repro_torch.tune.dispatch import TunedEvaluator  # local: avoid cycle

        evs = [
            TunedEvaluator(forest.tree(i), cache=cache, engines=engines,
                           autotune=autotune_trees, measure_kw=measure_kw, device=rec.device)
            for i in range(forest.n_trees)
        ]
        for ev in evs:   # resolve (and maybe measure) every per-tree winner now
            ev(rec)
        return (lambda r: torch.stack([ev(r) for ev in evs])), None
    spec = get_forest_variant(candidate.variant)
    params = candidate.param_dict
    if spec.layout == "quant":
        # Universal mode (no calibration): bit-exact for every input, so the
        # tuner may hand this layout to dispatch without changing results.
        target = QuantizedForest(forest, rec.shape[1],
                                 thr_dtype=params.get("thr_dtype", "bfloat16"), device=rec.device)
    elif spec.family == "fused":
        target = PackedForest(forest, rec.shape[1], device=rec.device)
    else:
        target = forest
    tbytes = forest_table_bytes(target) if target is not forest else None
    return (lambda r: spec.fn(r, target, max_depth=depth, **params)), tbytes


def measure_forest_candidate(
    candidate: Candidate,
    records: torch.Tensor,
    forest,
    *,
    cache: TuneCache | None = None,
    engines: tuple[str, ...] | None = None,
    warmup: int = 2,
    iters: int = 5,
    autotune_trees: bool = False,
) -> Measurement:
    """Median time of one forest candidate on ``records`` (bucket-padded).

    Args:
      candidate: a :func:`repro_torch.tune.space.forest_search_space`
        candidate (``Candidate(PER_TREE_FAMILY)`` or a forest variant).
      cache/engines: per-tree resolution inputs for the ``per_tree`` family.
      autotune_trees: measure the ``per_tree`` family with per-tree
        autotuning (winners measured during set-up, persisted to ``cache``)
        instead of the heuristic.
    """
    depth = max(int(forest.max_depth), 1)
    try:
        fn, table_bytes = _forest_candidate_fn(
            candidate, records, forest, depth=depth, cache=cache, engines=engines,
            autotune_trees=autotune_trees, measure_kw={"warmup": warmup, "iters": iters},
        )
    except _k.TileError:
        return Measurement(candidate, float("inf"), ())
    m = _measured(candidate, lambda: fn(records), records.device, warmup, iters,
                  table_bytes=table_bytes)
    if m.failed or table_bytes is None:
        return m
    cost = candidate_cost(records.shape[0], records.shape[1], int(forest.n_trees),
                          int(forest.n_nodes), depth, median_ms=m.median_ms,
                          table_bytes=table_bytes if candidate.variant.endswith("_q") else None)
    return dataclasses.replace(m, cost=cost)


def tune_forest_workload(
    records,
    forest,
    *,
    cache: TuneCache | None = None,
    engines: tuple[str, ...] | None = None,
    families: tuple[str, ...] | None = None,
    layouts: tuple[str, ...] | None = None,
    warmup: int = 2,
    iters: int = 5,
    backend: str | None = None,
    verbose: bool = False,
    autotune_trees: bool = False,
    store: bool = True,
    registry: obs.Registry | None = None,
    device=None,
) -> tuple[TuneEntry, list[Measurement]]:
    """Time every valid forest candidate and record the winning family.

    The forest analogue of :func:`tune_workload`: records are zero-padded to
    the :class:`ForestShape` bucket's M before timing and every candidate of
    the three families — per-tree variant vector, shared-variant batched,
    fused kernel — is measured with the same discipline.

    Args:
      engines/families/layouts: restrict the candidate enumeration
        (``layouts`` defaults to the f32 tables; pass ``("f32", "quant")``
        to let the :class:`QuantizedForest` candidates compete).
      autotune_trees: give the ``per_tree`` family its tuned best.
      store: persist the winner under the forest bucket key.  Callers
        measuring a *restricted* family set pass False.

    Returns:
      (winning entry, all measurements).
    """
    dev = _device.resolve(records, device)
    backend = backend or backend_tag(dev)
    rec = _device.as_tensor(records, torch.float32, dev)
    shape = ForestShape.of(rec, forest)
    rec = bucket_pad_records(rec, shape.bucket().m)

    measurements = [
        measure_forest_candidate(
            c, rec, forest, cache=cache, engines=engines, warmup=warmup, iters=iters,
            autotune_trees=autotune_trees,
        )
        for c in forest_search_space(
            shape, engines=engines, families=families, layouts=layouts, device=dev)
    ]
    _note_measurements(registry, "forest", measurements)
    ok = [m for m in measurements if not m.failed]
    if not ok:
        raise RuntimeError(f"no forest candidate succeeded for shape {shape}")
    best = min(ok, key=lambda m: m.score_ms)
    if verbose:
        for m in sorted(ok, key=lambda m: m.score_ms):
            print(f"  {m.score_ms:10.3f} ms  {m.candidate.variant} {m.candidate.param_dict}")
    entry = TuneEntry(
        variant=best.candidate.variant,
        params=best.candidate.param_dict,
        median_ms=best.median_ms,
        shape=dataclasses.asdict(shape),
        backend=backend,
    )
    if cache is not None and store:
        cache.store(shape.key(backend), entry)
    return entry, measurements


# ---------------------------------------------------------------------------
# Class-level (majority vs cascade) measurement
# ---------------------------------------------------------------------------


def measure_cascade_candidate(
    candidate: Candidate,
    records: torch.Tensor,
    forest,
    n_classes: int,
    *,
    cache: TuneCache | None = None,
    engines: tuple[str, ...] | None = None,
    warmup: int = 2,
    iters: int = 5,
) -> Measurement:
    """Median time of one class-level candidate.

    ``Candidate(MAJORITY_FAMILY)`` prices the full path — the forest-level
    winner followed by ``majority_vote`` — through a warm
    :class:`repro_torch.tune.dispatch.ForestTunedEvaluator`; cascade
    candidates price a warm :class:`CascadeEvaluator` built at bound 1.0
    (every timed candidate must be exact).  Cascade timings include the
    host-side stage loop — that *is* the candidate's cost.
    """
    from repro_torch.core.forest import majority_vote

    if candidate.variant == MAJORITY_FAMILY:
        from repro_torch.tune.dispatch import ForestTunedEvaluator  # local: avoid cycle

        fte = ForestTunedEvaluator(forest, cache=cache, engines=engines, device=records.device)
        run = lambda: majority_vote(fte(records), n_classes)  # noqa: E731
    else:
        spec = get_cascade_variant(candidate.variant)
        params = candidate.param_dict
        try:
            ev = spec.build(
                forest,
                n_classes=n_classes,
                stages=int(params.get("stages", 2)),
                bound=1.0,
                block_m=params.get("block_m"),
                calibration=records,
                device=records.device,
            )
        except _k.TileError:
            return Measurement(candidate, float("inf"), ())
        run = lambda: ev(records).classes  # noqa: E731
    return _measured(candidate, run, records.device, warmup, iters, hide_host=False)


def tune_cascade_workload(
    records,
    forest,
    n_classes: int,
    *,
    cache: TuneCache | None = None,
    engines: tuple[str, ...] | None = None,
    warmup: int = 2,
    iters: int = 5,
    backend: str | None = None,
    verbose: bool = False,
    store: bool = True,
    registry: obs.Registry | None = None,
    device=None,
) -> tuple[TuneEntry, list[Measurement]]:
    """Time every class-level candidate and record the winner.

    Early-exit fractions — and therefore cascade timings — depend on the
    *actual* record mix, so candidates are timed on the un-bucketed batch
    and the winner is stored under the bucketed
    :meth:`ForestShape.classes_key`.
    """
    dev = _device.resolve(records, device)
    backend = backend or backend_tag(dev)
    rec = _device.as_tensor(records, torch.float32, dev)
    shape = ForestShape.of(rec, forest)

    measurements = [
        measure_cascade_candidate(
            c, rec, forest, n_classes,
            cache=cache, engines=engines, warmup=warmup, iters=iters,
        )
        for c in cascade_search_space(shape, n_classes, engines=engines, device=dev)
    ]
    _note_measurements(registry, "classes", measurements)
    ok = [m for m in measurements if not m.failed]
    if not ok:
        raise RuntimeError(f"no class-level candidate succeeded for shape {shape}")
    best = min(ok, key=lambda m: m.score_ms)
    if verbose:
        for m in sorted(ok, key=lambda m: m.score_ms):
            print(f"  {m.score_ms:10.3f} ms  {m.candidate.variant} {m.candidate.param_dict}")
    entry = TuneEntry(
        variant=best.candidate.variant,
        params=best.candidate.param_dict,
        median_ms=best.median_ms,
        shape=dataclasses.asdict(shape),
        backend=backend,
    )
    if cache is not None and store:
        cache.store(shape.classes_key(n_classes, backend), entry)
    return entry, measurements
