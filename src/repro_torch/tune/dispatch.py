"""Transparent variant dispatch: ``tuned_eval(records, tree)``.

Resolution order for each (device, shape-bucket):

  1. in-process memo (one dict probe on the hot path),
  2. persistent cache (:class:`repro_torch.tune.cache.TuneCache`),
  3. optional on-miss autotune (``autotune=True`` — measures the search
     space once and persists the winner),
  4. the §3.6-model heuristic (:mod:`repro_torch.tune.heuristic`).

Dispatch zero-pads the record batch up to the bucket's M on its device
before running the variant and slices the padding back off, so the timings
stored by the tuner price what dispatch runs.  All variants are exact
(bit-identical to the serial reference), so dispatch never changes results —
only which kernel produces them.

The port's evaluators differ from the JAX package's in three ways.  They
take ``device=None``: a tensor runs where it lies, anything else goes to the
card (or ``device="cpu"``).  They build the kernels' device tables
(``PackedTree`` / ``PackedForest`` / ``QuantizedForest``) once per device
and attribute count, not per call.  And a winner read from the cache runs
only if its engine is permitted here and its record tile fits the actual
tree; otherwise resolution goes on as on a miss.

:class:`ForestTunedEvaluator` lifts the same contract to whole forests: the
resolution unit is the (T, M, N_max, A, depth-profile) bucket and the
candidate space spans three families (per-tree variant vectors, the
shared-variant batched path, the fused kernels).  Both evaluators expose
``promote`` / ``invalidate`` — the atomic winner-swap hooks the serve
engine's background re-tune drives.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch import _device, obs
from repro_torch.core.tree import EncodedTree, tree_depth
from repro_torch.kernels.tree_eval.cascade import (
    CASCADE_VARIANTS,
    MAJORITY_FAMILY,
    get_cascade_variant,
)
from repro_torch.kernels.tree_eval.ops import (
    FOREST_VARIANTS,
    PER_TREE_FAMILY,
    VARIANTS,
    PackedForest,
    PackedTree,
    get_forest_variant,
    get_variant,
)
from repro_torch.kernels.tree_eval.quant import QuantizedForest
from repro_torch.tune.cache import TuneCache, TuneEntry
from repro_torch.tune.heuristic import (
    cascade_heuristic_candidate,
    default_d_mu,
    forest_heuristic_candidate,
    heuristic_candidate,
    measured_d_mu,
    measured_forest_d_mu,
    measured_survival_rate,
)
from repro_torch.tune.measure import (
    bucket_pad_records,
    tune_cascade_workload,
    tune_forest_workload,
    tune_workload,
)
from repro_torch.tune.space import (
    Candidate,
    ForestShape,
    WorkloadShape,
    backend_tag,
    default_engines,
    tile_fits,
)


class _TuneObs:
    """The tuner's shared instrument set on one registry.

    Levels: ``tree`` (per-tree variant resolution), ``forest`` (family
    resolution), ``classes`` (majority-vote vs cascade).  The agreement
    counter compares each *measured* winner against what the §3.6 heuristic
    would have picked for the same bucket.
    """

    def __init__(self, registry: obs.Registry | None,
                 tracer: obs.Tracer | None):
        self.registry = registry if registry is not None else obs.default_registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        r = self.registry
        self.resolutions = r.counter(
            "tune.resolutions", "kernel resolutions by level and source",
            ("level", "source"))
        self.swaps = r.counter(
            "tune.winner_swaps", "atomic winner promotions (background re-tune)",
            ("level",))
        self.agreement = r.counter(
            "tune.heuristic_agreement",
            "measured winner vs §3.6-heuristic pick, per autotune resolution",
            ("level", "agree"))
        self.d_mu_gauge = r.gauge(
            "tune.d_mu", "d_µ the §3.6 heuristic evaluated at, by provenance",
            ("level", "source"))
        self.d_mu_provenance = r.counter(
            "tune.d_mu_provenance",
            "heuristic resolutions by d_µ provenance "
            "(measured=traversal profiler, sampled=host descent, prior=geometry)",
            ("level", "source"))
        self.d_mu_agreement = r.counter(
            "tune.d_mu_agreement",
            "measured-d_µ heuristic pick vs geometry-prior pick, per resolution",
            ("level", "agree"))
        self.survival_provenance = r.counter(
            "tune.survival_provenance",
            "cascade-survival provenance at class-level resolutions",
            ("source",))

    def note_resolution(self, level: str, source: str) -> None:
        self.resolutions.labels(level=level, source=source).inc()

    def note_d_mu(self, level: str, source: str, value: float) -> None:
        self.d_mu_provenance.labels(level=level, source=source).inc()
        self.d_mu_gauge.labels(level=level, source=source).set(value)

    def note_d_mu_agreement(self, level: str, cand: Candidate, prior_pick) -> None:
        """Would the geometry prior have picked the same variant as the
        profiler-measured d_µ did?"""
        self._agree(self.d_mu_agreement, level, cand, prior_pick)

    def note_swap(self, level: str, key: str) -> None:
        self.swaps.labels(level=level).inc()
        self.tracer.instant("tune.promote", cat="tune", level=level, bucket=key)

    def note_agreement(self, level: str, measured: Candidate, heuristic_pick) -> None:
        self._agree(self.agreement, level, measured, heuristic_pick)

    @staticmethod
    def _agree(counter, level: str, cand: Candidate, pick) -> None:
        try:
            agree = "yes" if pick().variant == cand.variant else "no"
        except Exception:
            agree = "error"
        counter.labels(level=level, agree=agree).inc()


def _resolve_d_mu(kw: dict, *, profiler, key: str, measure: bool, sample_fn):
    """Fill ``kw["d_mu"]`` through the provenance ladder; returns the source.

    caller-supplied ``heuristic_kw`` override > traversal-profiler
    measurement for this bucket > host-sampled descent on the batch >
    geometry prior (``kw`` left without d_mu — the heuristic defaults it).
    """
    if "d_mu" in kw:
        return "caller"
    if profiler is not None:
        measured = profiler.d_mu(key)
        if measured is not None:
            kw["d_mu"] = measured
            return "measured"
    if measure:
        kw["d_mu"] = sample_fn()
        return "sampled"
    return "prior"


def _engines(engines, dev) -> tuple[str, ...]:
    return default_engines(dev) if engines is None else tuple(engines)


def _stamp_d_mu_provenance(cache: TuneCache, profiler, key: str, entry: TuneEntry) -> None:
    """Re-store an autotuned cache entry with the profiler's measured d_µ, so
    a later reader sees what traffic the winner was tuned under."""
    measured = profiler.d_mu(key) if profiler is not None else None
    if measured is not None:
        cache.store(key, dataclasses.replace(entry, d_mu=measured, d_mu_source="measured"))


class TunedEvaluator:
    """Reusable tuned dispatcher for one encoded tree.

    Prefer this over the functional :func:`tuned_eval` on hot paths (serving,
    forests): it owns the depth computation, the cache handle, the device
    tables and a per-bucket resolution memo, so steady-state calls do no
    lookup work.  ``device``: where to run; default where the records lie,
    else CUDA.
    """

    def __init__(
        self,
        enc: EncodedTree,
        *,
        cache: TuneCache | None = None,
        autotune: bool = False,
        engines: tuple[str, ...] | None = None,
        measure_kw: dict | None = None,
        measure_d_mu: bool = True,
        d_mu_sample: int = 256,
        heuristic_kw: dict | None = None,
        registry: obs.Registry | None = None,
        tracer: obs.Tracer | None = None,
        profiler=None,
        device=None,
    ):
        self.enc = enc
        self.cache = cache if cache is not None else TuneCache()
        self.autotune = autotune
        self.engines = engines
        self.device = device
        self._obs = _TuneObs(registry, tracer)
        # a TraversalProfiler (or anything with .d_mu(key)): measured d_µ
        # per bucket beats both the host sample and the geometry prior
        self.profiler = profiler
        self.measure_kw = dict(measure_kw or {})
        self.measure_d_mu = measure_d_mu
        self.d_mu_sample = d_mu_sample
        self.heuristic_kw = dict(heuristic_kw or {})
        self.depth = max(tree_depth(enc), 1)
        self._resolved: dict[str, tuple[Candidate, str]] = {}
        # (device, M, A) → (spec, params, bucket_m, tables): the steady-state
        # call does one dict probe, the padding and the kernel.
        self._fast: dict[tuple, tuple] = {}
        self._packed: dict[tuple, PackedTree] = {}   # (device, A) → tables
        # guards promote()/invalidate() against the resolve path; the fast
        # path itself stays lock-free (GIL-atomic dict probes).  _gen counts
        # swaps so a runner built from a pre-swap resolution is never cached
        # over a fresh promotion.
        self._swap_lock = threading.Lock()
        self._gen = 0

    def promote(self, key: str, cand: Candidate) -> None:
        """Atomically swap the winner for bucket ``key`` (background re-tune).

        Callers observe either the old winner or the new one, never a torn
        state, and every variant is exact, so results are identical either
        way.
        """
        with self._swap_lock:
            self._gen += 1
            self._resolved[key] = (cand, "retune")
            self._fast.clear()
        self._obs.note_swap("tree", key)

    def invalidate(self) -> None:
        """Drop all resolution memos so the next call re-reads the cache."""
        with self._swap_lock:
            self._gen += 1
            self._resolved.clear()
            self._fast.clear()

    def _runnable(self, cand: Candidate, dev, n_attrs: int) -> bool:
        """Whether a cached winner may run here: a registered variant of a
        permitted engine whose record tile fits this tree."""
        spec = VARIANTS.get(cand.variant)
        if spec is None or spec.engine not in _engines(self.engines, dev):
            return False
        bm = cand.param_dict.get("block_m")
        if spec.engine == "cuda" and bm is not None:
            return tile_fits(spec.algorithm, int(bm), int(self.enc.n_nodes), n_attrs, spec.jump_mode)
        return True

    def resolve(self, records, *, device=None) -> tuple[Candidate, str]:
        """Pick the candidate for this batch; returns (candidate, source)
        with source ∈ {"memo", "cache", "autotune", "heuristic"}."""
        dev = _device.resolve(records, self.device if device is None else device)
        shape = WorkloadShape.of(records, self.enc, self.depth)
        backend = backend_tag(dev)
        key = shape.key(backend)
        hit = self._resolved.get(key)
        if hit is not None:
            self._obs.note_resolution("tree", "memo")
            return hit[0], "memo"

        entry = self.cache.lookup(key)
        source = "cache"
        cand = None if entry is None else Candidate.make(entry.variant, **entry.params)
        if cand is not None and self._runnable(cand, dev, shape.n_attrs):
            pass
        elif self.autotune:
            with self._obs.tracer.span("tune.measure", cat="tune", level="tree", bucket=key):
                entry, _ = tune_workload(
                    records,
                    self.enc,
                    cache=self.cache,
                    engines=self.engines,
                    backend=backend,
                    registry=self._obs.registry,
                    device=dev,
                    **self.measure_kw,
                )
            cand = Candidate.make(entry.variant, **entry.params)
            source = "autotune"
            self._obs.note_agreement(
                "tree", cand,
                lambda: heuristic_candidate(
                    shape, engines=self.engines, device=dev, **self.heuristic_kw),
            )
            _stamp_d_mu_provenance(self.cache, self.profiler, key, entry)
        else:
            kw = dict(self.heuristic_kw)
            d_mu_source = _resolve_d_mu(
                kw, profiler=self.profiler, key=key, measure=self.measure_d_mu,
                sample_fn=lambda: measured_d_mu(self.enc, records, sample=self.d_mu_sample),
            )
            cand = heuristic_candidate(shape, engines=self.engines, device=dev, **kw)
            source = "heuristic"
            self._obs.note_d_mu("tree", d_mu_source, kw.get("d_mu", default_d_mu(shape)))
            if d_mu_source == "measured":
                prior_kw = dict(self.heuristic_kw)
                prior_kw.pop("d_mu", None)
                self._obs.note_d_mu_agreement(
                    "tree", cand,
                    lambda: heuristic_candidate(shape, engines=self.engines, device=dev, **prior_kw),
                )
        self._obs.note_resolution("tree", source)
        # setdefault under the lock: if a background promote() landed while
        # we resolved, its winner must not be overwritten with ours
        with self._swap_lock:
            resolved = self._resolved.setdefault(key, (cand, source))
        return resolved[0], source

    def _tables(self, spec, dev, n_attrs: int):
        """What the variant runs against: the kernels' device tables (packed
        once per device and attribute count), else the encoding."""
        if spec.engine != "cuda":
            return self.enc
        packed = self._packed.get((dev, n_attrs))
        if packed is None:
            packed = self._packed[(dev, n_attrs)] = PackedTree(self.enc, n_attrs, device=dev)
        return packed

    def __call__(self, records) -> torch.Tensor:
        """Evaluate the tree over ``records`` (M, A) → (M,) int32 classes on
        the evaluator's device, through the bucket's resolved variant
        (bucket-padded, unpadded on return); bit-identical to ``eval_serial``
        for every resolution."""
        tracer = self._obs.tracer
        with tracer.span("tune.call", cat="tune"):
            dev = _device.resolve(records, self.device)
            records = _device.as_tensor(records, torch.float32, dev)
            m, a = records.shape
            fast = self._fast.get((dev, m, a))
            if fast is None:
                with tracer.span("tune.resolve", cat="tune", level="tree", records=m):
                    gen = self._gen
                    cand, _ = self.resolve(records, device=dev)
                    spec = get_variant(cand.variant)
                    bucket_m = WorkloadShape(m, self.enc.n_nodes, a, self.depth).bucket().m
                    fast = (spec, cand.param_dict, bucket_m, self._tables(spec, dev, a))
                    with self._swap_lock:
                        if gen == self._gen:   # don't cache a pre-swap resolution
                            self._fast[(dev, m, a)] = fast
            spec, params, bucket_m, tables = fast
            out = spec.fn(bucket_pad_records(records, bucket_m, tracer=tracer), tables,
                          max_depth=self.depth, **params)
            return out if out.shape[0] == m else out[:m]


def tuned_eval(
    records,
    tree: EncodedTree,
    *,
    cache: TuneCache | None = None,
    autotune: bool = False,
    engines: tuple[str, ...] | None = None,
    device=None,
) -> torch.Tensor:
    """Evaluate ``tree`` over ``records`` with the cached-best variant.

    One-shot convenience wrapper around :class:`TunedEvaluator`; returns the
    (M,) int32 class assignments, bit-identical to ``eval_serial``.
    """
    return TunedEvaluator(tree, cache=cache, autotune=autotune, engines=engines,
                          device=device)(records)


# ---------------------------------------------------------------------------
# Forest-level dispatch
# ---------------------------------------------------------------------------


class ForestTunedEvaluator:
    """Reusable tuned dispatcher for one encoded *forest*.

    The forest analogue of :class:`TunedEvaluator`, and the selection point
    forest calls route through (``eval_forest_tuned``).  Resolution order per
    (device, forest-bucket): memo, cache (forest bucket keys, see
    :meth:`repro_torch.tune.space.ForestShape.key`), optional on-miss
    autotune over all three candidate families, the §3.6 family heuristic.

    The winner is one of three families: ``per_tree`` dispatches each tree
    through its own :class:`TunedEvaluator` (a per-tree variant *vector*);
    ``batched`` runs one shared plain variant over the stacked trees;
    ``fused`` launches one kernel for the whole forest.  All families are
    exact, so the choice never changes results.
    """

    def __init__(
        self,
        forest,
        *,
        cache: TuneCache | None = None,
        autotune: bool = False,
        engines: tuple[str, ...] | None = None,
        families: tuple[str, ...] | None = None,
        layouts: tuple[str, ...] | None = None,
        measure_kw: dict | None = None,
        measure_d_mu: bool = True,
        d_mu_sample: int = 256,
        heuristic_kw: dict | None = None,
        registry: obs.Registry | None = None,
        tracer: obs.Tracer | None = None,
        profiler=None,
        device=None,
    ):
        from repro_torch.core.forest import EncodedForest  # local: core ↔ tune layering

        self.forest = forest if isinstance(forest, EncodedForest) else EncodedForest(list(forest))
        self.cache = cache if cache is not None else TuneCache()
        self.autotune = autotune
        self.engines = engines
        self.device = device
        self._obs = _TuneObs(registry, tracer)
        # a TraversalProfiler keyed by this evaluator's forest-bucket keys:
        # measured d_µ and cascade survival replace the sample/prior fallbacks
        self.profiler = profiler
        self.families = families
        # node-table layout opt-in: None ≡ ("f32",) — quantized layouts only
        # compete (and quant cached winners are only honoured) when a caller
        # passes layouts including "quant".  Every quant layout dispatch
        # builds is universal-mode (exact for every input).
        self.layouts = layouts
        self.measure_kw = dict(measure_kw or {})
        self.measure_d_mu = measure_d_mu
        self.d_mu_sample = d_mu_sample
        self.heuristic_kw = dict(heuristic_kw or {})
        depths = [max(tree_depth(self.forest.tree(i)), 1) for i in range(self.forest.n_trees)]
        self.depth_min = min(depths)
        self.depth_max = max(depths)
        self._resolved: dict[str, tuple[Candidate, str]] = {}
        self._fast: dict[tuple, object] = {}   # (device, M, A) → runner
        self._per_tree: dict = {}              # device → [TunedEvaluator]
        self._tables: dict[tuple, object] = {}  # (device, A[, thr_dtype]) → tables
        self._swap_lock = threading.Lock()
        self._gen = 0

    # -- re-tune hooks ------------------------------------------------------

    def promote(self, key: str, cand: Candidate) -> None:
        """Atomically swap the winner for forest bucket ``key`` (see
        :meth:`TunedEvaluator.promote`)."""
        with self._swap_lock:
            self._gen += 1
            self._resolved[key] = (cand, "retune")
            self._fast.clear()
        self._obs.note_swap("forest", key)

    def invalidate(self) -> None:
        """Drop all resolution memos so the next call re-reads the cache."""
        with self._swap_lock:
            self._gen += 1
            self._resolved.clear()
            self._fast.clear()

    def _family_allowed(self, variant: str) -> bool:
        """Whether a cached winner's family is within this evaluator's
        ``families`` restriction."""
        if self.families is None:
            return True
        if variant == PER_TREE_FAMILY:
            return PER_TREE_FAMILY in self.families
        return FOREST_VARIANTS[variant].family in self.families

    def _layout_allowed(self, variant: str) -> bool:
        """Whether a cached winner's node-table layout is within this
        evaluator's ``layouts`` restriction (default f32 only)."""
        layout = "f32" if variant == PER_TREE_FAMILY else FOREST_VARIANTS[variant].layout
        allowed = ("f32",) if self.layouts is None else self.layouts
        return layout in allowed

    def _runnable(self, cand: Candidate, dev, n_attrs: int) -> bool:
        """Whether a cached forest winner may run here."""
        if cand.variant == PER_TREE_FAMILY:
            return self._family_allowed(cand.variant) and self._layout_allowed(cand.variant)
        spec = FOREST_VARIANTS.get(cand.variant)
        if (spec is None or spec.engine not in _engines(self.engines, dev)
                or not self._family_allowed(cand.variant) or not self._layout_allowed(cand.variant)):
            return False
        bm = cand.param_dict.get("block_m")
        if spec.engine == "cuda" and bm is not None:
            return tile_fits(spec.algorithm, int(bm), int(self.forest.n_nodes), n_attrs, spec.jump_mode)
        return True

    # -- resolution ---------------------------------------------------------

    def shape_of(self, records) -> ForestShape:
        """The :class:`ForestShape` of this batch (depths precomputed)."""
        return ForestShape.of(
            records, self.forest, depth_min=self.depth_min, depth_max=self.depth_max
        )

    def resolve(self, records, *, device=None) -> tuple[Candidate, str]:
        """Pick the forest candidate for this batch.

        Returns:
          (candidate, source) with source ∈ {"memo", "cache", "autotune",
          "heuristic"}; after a background re-tune the memo carries the
          promoted winner.
        """
        dev = _device.resolve(records, self.device if device is None else device)
        shape = self.shape_of(records)
        backend = backend_tag(dev)
        key = shape.key(backend)
        hit = self._resolved.get(key)
        if hit is not None:
            self._obs.note_resolution("forest", "memo")
            return hit[0], "memo"

        entry = self.cache.lookup(key)
        source = "cache"
        cand = None if entry is None else Candidate.make(entry.variant, **entry.params)
        if cand is not None and self._runnable(cand, dev, shape.n_attrs):
            pass
        elif self.autotune:
            with self._obs.tracer.span("tune.measure", cat="tune", level="forest", bucket=key):
                entry, _ = tune_forest_workload(
                    records,
                    self.forest,
                    cache=self.cache,
                    engines=self.engines,
                    families=self.families,
                    layouts=self.layouts,
                    backend=backend,
                    autotune_trees=True,   # per-tree family priced at its tuned best
                    # a restricted (family- or layout-filtered) winner must
                    # not overwrite the bucket's unrestricted one
                    store=self.families is None and self.layouts is None,
                    registry=self._obs.registry,
                    device=dev,
                    **self.measure_kw,
                )
            cand = Candidate.make(entry.variant, **entry.params)
            source = "autotune"
            self._obs.note_agreement(
                "forest", cand,
                lambda: forest_heuristic_candidate(
                    shape, engines=self.engines, families=self.families, device=dev,
                    **self.heuristic_kw),
            )
            _stamp_d_mu_provenance(self.cache, self.profiler, key, entry)
        else:
            kw = dict(self.heuristic_kw)
            d_mu_source = _resolve_d_mu(
                kw, profiler=self.profiler, key=key, measure=self.measure_d_mu,
                sample_fn=lambda: measured_forest_d_mu(self.forest, records, sample=self.d_mu_sample),
            )
            cand = forest_heuristic_candidate(
                shape, engines=self.engines, families=self.families, device=dev, **kw
            )
            source = "heuristic"
            self._obs.note_d_mu("forest", d_mu_source,
                                kw.get("d_mu", default_d_mu(shape.tree_shape())))
            if d_mu_source == "measured":
                prior_kw = dict(self.heuristic_kw)
                prior_kw.pop("d_mu", None)
                self._obs.note_d_mu_agreement(
                    "forest", cand,
                    lambda: forest_heuristic_candidate(
                        shape, engines=self.engines, families=self.families, device=dev,
                        **prior_kw),
                )
        self._obs.note_resolution("forest", source)
        with self._swap_lock:
            resolved = self._resolved.setdefault(key, (cand, source))
        return resolved[0], source

    # -- evaluation ---------------------------------------------------------

    def _tree_evaluators(self, dev) -> list[TunedEvaluator]:
        evs = self._per_tree.get(dev)
        if evs is None:
            evs = self._per_tree[dev] = [
                TunedEvaluator(
                    self.forest.tree(i), cache=self.cache, engines=self.engines,
                    autotune=self.autotune, measure_kw=self.measure_kw,
                    registry=self._obs.registry, tracer=self._obs.tracer, device=dev,
                )
                for i in range(self.forest.n_trees)
            ]
        return evs

    def _target(self, spec, dev, a: int, params: dict):
        """The tables a forest variant runs against, built once per device,
        attribute count and (quantized) threshold dtype."""
        if spec.layout == "quant":
            # Universal-mode quantization (no calibration): bit-exact for
            # every input, so a quant winner never changes results.
            key = (dev, a, params.get("thr_dtype", "bfloat16"))
            build = lambda: QuantizedForest(self.forest, a, thr_dtype=key[2], device=dev)  # noqa: E731
        elif spec.family == "fused":
            key = (dev, a)
            build = lambda: PackedForest(self.forest, a, device=dev)  # noqa: E731
        else:
            return self.forest
        target = self._tables.get(key)
        if target is None:
            target = self._tables[key] = build()
        return target

    def _runner(self, cand: Candidate, m: int, a: int, dev):
        """Build the steady-state callable for one resolved candidate."""
        if cand.variant == PER_TREE_FAMILY:
            evs = self._tree_evaluators(dev)
            return lambda rec: torch.stack([ev(rec) for ev in evs])
        spec = get_forest_variant(cand.variant)
        params = cand.param_dict
        depth = max(int(self.forest.max_depth), 1)
        bucket_m = ForestShape(
            t=self.forest.n_trees, m=m, n_nodes=self.forest.n_nodes,
            n_attrs=a, depth_min=self.depth_min, depth_max=self.depth_max,
        ).bucket().m
        target = self._target(spec, dev, a, params)
        tracer = self._obs.tracer

        def run(rec):
            out = spec.fn(bucket_pad_records(rec, bucket_m, tracer=tracer), target,
                          max_depth=depth, **params)
            return out if out.shape[1] == m else out[:, :m]

        return run

    def __call__(self, records) -> torch.Tensor:
        """Per-tree class assignments, shape (T, M) int32, on the
        evaluator's device."""
        tracer = self._obs.tracer
        with tracer.span("tune.forest_call", cat="tune"):
            dev = _device.resolve(records, self.device)
            records = _device.as_tensor(records, torch.float32, dev)
            m, a = records.shape
            run = self._fast.get((dev, m, a))
            if run is None:
                with tracer.span("tune.resolve", cat="tune", level="forest", records=m):
                    gen = self._gen
                    cand, _ = self.resolve(records, device=dev)
                    run = self._runner(cand, m, a, dev)
                    with self._swap_lock:
                        if gen == self._gen:   # don't cache a pre-swap resolution
                            self._fast[(dev, m, a)] = run
            return run(records)

    # -- class-level dispatch (majority vote vs early-exit cascade) ---------

    def _class_runnable(self, cand: Candidate, dev, n_attrs: int, n_classes: int) -> bool:
        """Whether a cached class-level winner may run here."""
        if cand.variant == MAJORITY_FAMILY:
            return True
        spec = CASCADE_VARIANTS.get(cand.variant)
        if spec is None or spec.engine not in _engines(self.engines, dev):
            return False
        bm = cand.param_dict.get("block_m")
        if spec.engine == "cuda" and bm is not None:
            return tile_fits(spec.algorithm, int(bm), int(self.forest.n_nodes), n_attrs,
                             spec.jump_mode, max(int(n_classes), 2))
        return True

    def resolve_classes(self, records, n_classes: int, *, device=None) -> tuple[Candidate, str]:
        """Pick the class-level candidate for this batch.

        Same resolution ladder as :meth:`resolve`, over the *class* question
        — the full majority-vote path (``Candidate(MAJORITY_FAMILY)``) or an
        early-exit cascade.  Keys carry the class count
        (:meth:`ForestShape.classes_key`), and the heuristic extends the
        §3.6 model with a survival-rate term measured on this batch.  Every
        candidate is exact at bound 1.0.
        """
        dev = _device.resolve(records, self.device if device is None else device)
        shape = self.shape_of(records)
        backend = backend_tag(dev)
        key = shape.classes_key(n_classes, backend)
        hit = self._resolved.get(key)
        if hit is not None:
            self._obs.note_resolution("classes", "memo")
            return hit[0], "memo"

        entry = self.cache.lookup(key)
        source = "cache"
        cand = None if entry is None else Candidate.make(entry.variant, **entry.params)
        if cand is not None and self._class_runnable(cand, dev, shape.n_attrs, n_classes):
            pass
        elif self.autotune:
            with self._obs.tracer.span("tune.measure", cat="tune", level="classes", bucket=key):
                entry, _ = tune_cascade_workload(
                    records,
                    self.forest,
                    n_classes,
                    cache=self.cache,
                    engines=self.engines,
                    backend=backend,
                    registry=self._obs.registry,
                    device=dev,
                    **self.measure_kw,
                )
            cand = Candidate.make(entry.variant, **entry.params)
            source = "autotune"
        else:
            kw = dict(self.heuristic_kw)
            # profiler measurements are keyed by the forest bucket (the
            # engine's wave key), not the |C-suffixed class key
            forest_key = shape.key(backend)
            d_mu_source = _resolve_d_mu(
                kw, profiler=self.profiler, key=forest_key, measure=self.measure_d_mu,
                sample_fn=lambda: measured_forest_d_mu(self.forest, records, sample=self.d_mu_sample),
            )
            survival = kw.pop("survival", None)
            survival_source = "caller"
            if survival is None and self.profiler is not None:
                measured = self.profiler.survival(forest_key)
                if measured is not None:
                    # the profiler reports the mean per-stage survival rate;
                    # expand it geometrically over the deepest stage grid the
                    # heuristic may price (surv_s = rate^s, surv_0 = 1)
                    survival = tuple(min(1.0, float(measured)) ** s for s in range(8))
                    survival_source = "measured"
            if survival is None:
                survival = measured_survival_rate(
                    self.forest, records, n_classes, sample=self.d_mu_sample
                )
                survival_source = "sampled"
            cand = cascade_heuristic_candidate(
                shape, n_classes, survival=survival, engines=self.engines, device=dev, **kw
            )
            source = "heuristic"
            self._obs.note_d_mu("classes", d_mu_source,
                                kw.get("d_mu", default_d_mu(shape.tree_shape())))
            self._obs.survival_provenance.labels(source=survival_source).inc()
        self._obs.note_resolution("classes", source)
        with self._swap_lock:
            resolved = self._resolved.setdefault(key, (cand, source))
        return resolved[0], source

    def _class_runner(self, cand: Candidate, n_classes: int, records, dev):
        """Build the steady-state classes callable for one resolution."""
        from repro_torch.core.forest import majority_vote  # local: core ↔ tune layering

        if cand.variant == MAJORITY_FAMILY:
            return lambda rec: majority_vote(self(rec), n_classes)
        spec = get_cascade_variant(cand.variant)
        params = cand.param_dict
        # the evaluator is stateful (packed stage tables, latency EMAs):
        # build once per resolved bucket, calibrate the plan on this batch
        ev = spec.build(
            self.forest,
            n_classes=n_classes,
            stages=int(params.get("stages", 2)),
            bound=1.0,
            block_m=params.get("block_m"),
            calibration=records,
            registry=self._obs.registry,
            tracer=self._obs.tracer,
            device=dev,
        )

        def run(rec):
            return ev(rec).classes

        run.cascade = ev  # exposed for introspection
        return run

    def predict(self, records, n_classes: int) -> torch.Tensor:
        """Majority-vote classes, shape (M,) int32, via class-level dispatch.

        Either the full forest path (``majority_vote`` over
        :meth:`__call__`) or a calibrated early-exit cascade — whichever the
        resolution picked.  Both are exact, so the output always equals
        ``majority_vote(self(records), n_classes)``.
        """
        tracer = self._obs.tracer
        with tracer.span("tune.predict", cat="tune"):
            dev = _device.resolve(records, self.device)
            records = _device.as_tensor(records, torch.float32, dev)
            m, a = records.shape
            key = ("cls", dev, m, a, int(n_classes))
            run = self._fast.get(key)
            if run is None:
                with tracer.span("tune.resolve", cat="tune", level="classes", records=m):
                    gen = self._gen
                    cand, _ = self.resolve_classes(records, n_classes, device=dev)
                    run = self._class_runner(cand, n_classes, records, dev)
                    with self._swap_lock:
                        if gen == self._gen:   # don't cache a pre-swap resolution
                            self._fast[key] = run
            return run(records)


def tuned_eval_forest(
    records,
    forest,
    *,
    cache: TuneCache | None = None,
    autotune: bool = False,
    engines: tuple[str, ...] | None = None,
    device=None,
) -> torch.Tensor:
    """Evaluate ``forest`` over ``records`` with the cached-best family.

    One-shot convenience wrapper around :class:`ForestTunedEvaluator`;
    returns the (T, M) int32 per-tree class assignments, bit-identical to
    evaluating each tree with ``eval_serial``.
    """
    return ForestTunedEvaluator(
        forest, cache=cache, autotune=autotune, engines=engines, device=device
    )(records)
