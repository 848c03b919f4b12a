"""Multi-device executor: lower a ShardPlan over a (records × trees) device grid.

The port's counterpart of the JAX package's ``dist/executor.py``.  There a
plan lowers onto ``shard_map`` over a ``jax.sharding.Mesh``; here one
process — a single controller — drives the node's cards as ``cuda:0 …
cuda:D-1`` and walks the grid shard by shard.  The executor is one call that
returns (T, M), made from one request thread by the chunker and the serve
engine; an SPMD ``torch.distributed`` version would need every rank to call
it collectively, which no caller does.

  R = plan.record_shards → grid axis ``"records"``: each grid row holds M/R
      records — Procedure 3's ``D[m·p .. m(p+1))`` slicing at device level.
  G = plan.tree_shards   → grid axis ``"trees"``: each grid column holds T/G
      stacked tree encodings, packed once on its device.
  per-shard kernel       → resolved through ``repro_torch.tune`` at the
      *shard* operating point, forest-first: the ForestShape bucket (M/R
      records × T/G trees) is consulted for a stored winner, falling back to
      the per-tree chain (:class:`repro_torch.tune.TunedEvaluator`) at the
      shard record shape.  The winner's algorithm, jump mode and tile lower
      onto the port's fused forest kernels — K3/K4, or K7/K8 for a quantized
      winner — one launch per shard on the shard's device and that device's
      current stream.  (The JAX shard bodies run the plain formulations
      instead; the kernel is per-device work there.)

Padding follows the divisibility policy of :mod:`repro_torch.parallel.sharding`:
records pad to a multiple of R with zero rows (sliced off the output), trees
pad to a multiple of G by repeating tree 0 (rows discarded) — both are the
§3.2 phantom-node trick applied to the grid axes.  The shards' outputs are
gathered into one (T, M) tensor on the grid's first device.  All variants
are exact, so any plan returns results bit-identical to
``eval_forest_tuned``; on a single device the executor *is*
``ForestTunedEvaluator`` (no grid in the path at all).

A grid may repeat a device (``("cpu",) * 8``, ``("cuda:0",) * 4``): its
shards then run one after another there, which tests the lowering on one
device and measures nothing about several.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch import _device, obs
from repro_torch.core.forest import EncodedForest
from repro_torch.dist.plan import ForestWorkload, MeshCostModel, ShardPlan, make_plan, plan_forest
from repro_torch.kernels.tree_eval.ops import (
    FOREST_VARIANTS,
    PackedForest,
    get_forest_variant,
    get_variant,
)
from repro_torch.kernels.tree_eval.quant import QuantizedForest
from repro_torch.parallel import sharding as shd


class DistStats:
    """Executor accounting on a :class:`repro_torch.obs.Registry`.

    ``resolve_source`` stays a plain last-write attribute (tests assert on
    the latest provenance); each resolution also lands in the labelled
    ``dist.resolutions{source=...}`` counter so a snapshot shows the full
    cache-hit/heuristic mix, not just the most recent outcome.
    """

    def __init__(self, registry: obs.Registry | None = None):
        self.registry = registry if registry is not None else obs.Registry()
        r = self.registry
        self.m_calls = r.counter("dist.calls", "executor dispatches")
        self.m_records = r.counter("dist.records", "records dispatched")
        self.m_shards = r.counter("dist.shard_launches", "shard kernel calls")
        self.m_resolutions = r.counter(
            "dist.resolutions", "shard-kernel resolutions by tune provenance",
            ("source",))
        self.resolve_source = ""    # where the shard kernel came from (tune provenance)

    def note_resolution(self, source: str) -> None:
        self.resolve_source = source
        self.m_resolutions.labels(source=source).inc()

    @property
    def calls(self) -> int:
        return int(self.m_calls.value)

    @property
    def records(self) -> int:
        return int(self.m_records.value)

    @property
    def shard_launches(self) -> int:
        return int(self.m_shards.value)


@dataclasses.dataclass(frozen=True)
class _Lowered:
    """One record count's lowering: the shards' kernel and tables."""

    m_pad: int
    m_shard: int
    t_shard: int
    variant: str                 # the fused forest variant every shard launches
    params: dict
    targets: dict                # grid cell (r, g) → its tree shard's tables on its device


class ShardedForestEvaluator:
    """Reusable sharded dispatcher for one encoded forest.

    Planning is lazy: the first batch supplies M and a d_µ sample, the
    planner picks (R, G) (unless ``plan``/``mesh``/``decomposition`` pins
    it), and subsequent equal-shaped calls replay one lowering.
    ``__call__`` never synchronizes the host — callers (stream chunker,
    serve engine, benches) own synchronization, which is what lets transfer
    overlap evaluation.

    ``devices``: the devices a plan may lay its grid over (default every
    card of the node; ``("cpu",)`` runs on the host); a ``mesh``
    (:func:`repro_torch.parallel.sharding.forest_mesh`) fixes the grid
    itself.
    """

    def __init__(
        self,
        forest: "EncodedForest | list",
        *,
        mesh: shd.DeviceGrid | None = None,
        plan: ShardPlan | None = None,
        decomposition: str | None = None,
        n_devices: int | None = None,
        devices: Sequence | None = None,
        mesh_cost: MeshCostModel | None = None,
        cache=None,
        autotune: bool = False,
        engines: tuple[str, ...] | None = None,
        layouts: tuple[str, ...] | None = None,
        registry: obs.Registry | None = None,
        tracer: obs.Tracer | None = None,
        profiler=None,
    ):
        from repro_torch.tune import TuneCache

        self.forest = forest if isinstance(forest, EncodedForest) else EncodedForest(list(forest))
        self.cache = cache if cache is not None else TuneCache()  # one handle, one disk read
        self.autotune = autotune
        self.engines = engines
        self.layouts = layouts
        self.obs = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        # a TraversalProfiler (serve engine's): measured per-bucket d_µ /
        # survival flow into the forest evaluator's heuristic resolutions
        self.profiler = profiler
        self.mesh_cost = mesh_cost if mesh_cost is not None else MeshCostModel()
        self.decomposition = decomposition
        if mesh is not None:
            devs = list(mesh.devices.flat)
        elif devices is not None:
            devs = list(devices)
        else:
            devs = shd.node_devices()
        self.devices = [shd.normal_device(d) for d in devs]
        self._given_mesh = mesh
        self._given_plan = plan
        self._n_devices = n_devices
        self.plan: ShardPlan | None = None
        self.mesh: shd.DeviceGrid | None = None
        self.resolved = None          # (Candidate, source) provenance
        self.shard_variant = None     # (fused variant, params) the shards launch
        self.last_sweep: list = []    # the latest retune's measurements
        self.stats = DistStats(self.obs)
        self._fast: dict[tuple[int, int], _Lowered] = {}   # (M, A) → lowering
        self._targets: dict[tuple, object] = {}   # (device, g, T/G, A, layout, thr_dtype) → tables
        self._forest_ev = None        # lazy ForestTunedEvaluator (single selection point)
        # swap generation: a _build() racing invalidate_resolution() must not
        # re-install its pre-promotion kernel (same guard as the evaluators)
        self._swap_lock = threading.Lock()
        self._gen = 0

    @property
    def device(self) -> torch.device:
        """Where inputs are best placed and the (T, M) output lands: the
        grid's first device."""
        return self.devices[0]

    # -- planning -----------------------------------------------------------

    def _measured_d_mu(self, rec: np.ndarray, sample: int = 128) -> float:
        """Forest d_µ: measured mean over a few trees × a record sample
        (delegates to the shared helper so the planner and the forest
        heuristic read the same measurement)."""
        from repro_torch.tune.heuristic import measured_forest_d_mu

        return measured_forest_d_mu(self.forest, rec, sample=sample)

    def _prepare(self, rec) -> None:
        if self.plan is not None:
            return
        if self._given_plan is not None:
            self.plan = self._given_plan
        elif self._given_mesh is not None:
            sizes = self._given_mesh.shape
            wl = ForestWorkload.of(self.forest, rec)
            self.plan = make_plan(
                wl, sizes.get("records", 1), sizes.get("trees", 1), self.mesh_cost
            )
        else:
            wl = ForestWorkload.of(self.forest, rec, d_mu=self._measured_d_mu(rec))
            self.plan = plan_forest(
                wl,
                n_devices=self._n_devices if self._n_devices is not None else len(self.devices),
                mesh_cost=self.mesh_cost,
                decomposition=self.decomposition,
            )
        if self.plan.n_devices > 1:
            self.mesh = self._given_mesh if self._given_mesh is not None else shd.forest_mesh(
                self.plan.record_shards, self.plan.tree_shards, self.devices
            )

    # -- lowering -----------------------------------------------------------

    def _forest_evaluator(self):
        """The lazily built :class:`repro_torch.tune.ForestTunedEvaluator`.

        One evaluator serves both roles: the whole single-device path (the
        plain tuned forest call, all three candidate families available)
        and, on a grid, the depth-profile metadata the per-shard resolution
        keys its forest buckets with.
        """
        if self._forest_ev is None:
            from repro_torch.tune import ForestTunedEvaluator

            self._forest_ev = ForestTunedEvaluator(
                self.forest,
                cache=self.cache,
                autotune=self.autotune,
                engines=self.engines,
                layouts=self.layouts,
                registry=self.obs,
                tracer=self.tracer,
                profiler=self.profiler,
                device=self.device,
            )
        return self._forest_ev

    def invalidate_resolution(self) -> None:
        """Drop kernel-resolution state; the next call re-reads the tune cache.

        The serve engine's background re-tune promotes a freshly measured
        winner by writing it to the shared cache and calling this — an
        atomic swap from the caller's view (in-flight calls finish on the
        old kernel, subsequent calls resolve the new one).  The (R, G) plan
        is kept: re-planning is a separate concern.
        """
        with self._swap_lock:
            self._gen += 1
            self._fast.clear()
        if self._forest_ev is not None:
            self._forest_ev.invalidate()

    def _shard_shape(self, m: int, n_attrs: int):
        from repro_torch.tune.space import ForestShape

        plan, forest = self.plan, self.forest
        m_pad = shd.pad_to_multiple(max(m, plan.record_shards), plan.record_shards)
        t_shard = shd.pad_to_multiple(forest.n_trees, plan.tree_shards) // plan.tree_shards
        fev = self._forest_evaluator()
        fshape = ForestShape(
            t=t_shard, m=m_pad // plan.record_shards, n_nodes=int(forest.n_nodes),
            n_attrs=n_attrs, depth_min=fev.depth_min, depth_max=fev.depth_max,
        )
        return m_pad, fshape

    def _shard_rows(self, g: int, t_shard: int) -> EncodedForest:
        """Tree shard ``g``'s forest.  ``forest.tree(i)`` is the already
        common-padded encoding, so it keeps the full forest's node count;
        trees past T repeat tree 0 (the divisibility padding)."""
        n = self.forest.n_trees
        return EncodedForest([self.forest.tree(i if i < n else 0)
                              for i in range(g * t_shard, (g + 1) * t_shard)])

    def retune(self, records, *, warmup: int = 1, iters: int = 3):
        """Re-measure the kernel choice at this executor's operating point.

        The measurement must land under the key the next resolution will
        actually probe, which depends on the plan:

        * one device — the full forest-family sweep at the batch shape; the
          winner lands under the forest bucket key the
          :class:`~repro_torch.tune.ForestTunedEvaluator` resolves;
        * a grid — the fused candidates (the kernels the shards launch) are
          timed at the *shard* operating point (M/R records × T/G trees) on
          the grid's first device and the winner is stored under the exact
          shard-shape key :meth:`_shard_kernel` looks up on its next build.

        Called from the serve engine's background re-tune worker; follow
        with :meth:`invalidate_resolution` to promote the stored winner.
        ``last_sweep`` keeps the measurements.

        Returns:
          The winning :class:`repro_torch.tune.TuneEntry`.
        """
        from repro_torch.tune.measure import tune_forest_workload
        from repro_torch.tune.space import backend_tag

        rec = np.asarray(records, np.float32)
        self._prepare(rec)
        if self.plan.n_devices == 1:
            entry, self.last_sweep = tune_forest_workload(
                rec, self.forest, cache=self.cache, engines=self.engines, layouts=self.layouts,
                warmup=warmup, iters=iters, autotune_trees=True, registry=self.obs,
                device=self.device,
            )
            return entry

        _, fshape = self._shard_shape(rec.shape[0], rec.shape[1])
        sample = np.zeros((fshape.m, rec.shape[1]), np.float32)
        rows = min(rec.shape[0], fshape.m)
        sample[:rows] = rec[:rows]
        entry, self.last_sweep = tune_forest_workload(
            sample, self._shard_rows(0, fshape.t), cache=None, engines=self.engines,
            families=("fused",), layouts=self.layouts, warmup=warmup, iters=iters,
            store=False, registry=self.obs, device=self.device,
        )
        self.cache.store(fshape.key(backend_tag(self.device)), entry)
        return entry

    def _fused(self, algorithm: str, jump_mode: str, params: dict, layout: str = "f32"):
        """The fused forest variant (and its tile) that runs ``algorithm``."""
        if layout == "quant":
            return f"forest_fused_{algorithm}_q", params
        suffix = f"_{jump_mode}" if algorithm == "speculative" else ""
        return f"forest_fused_{algorithm}{suffix}", {k: v for k, v in params.items() if k == "block_m"}

    def _shard_kernel(self, fshape, rec_host: np.ndarray) -> tuple[str, dict]:
        """Resolve the per-shard kernel through repro_torch.tune.

        Resolution is forest-first: the :class:`ForestShape` bucket at the
        shard operating point (M/R records × T/G trees) is looked up in the
        shared cache, and a stored fused or batched winner supplies the
        algorithm, jump mode and tile (and a quantized winner its threshold
        dtype, where ``layouts`` lets quantized tables run).  On a miss — or
        a ``per_tree`` winner, which is no single launch — resolution falls
        back to the per-tree chain at the shard record shape (memo → cache →
        autotune → heuristic).  Either way the winner lowers onto the fused
        kernel of its algorithm.

        Returns:
          (fused forest variant, its params).
        """
        from repro_torch.tune import TunedEvaluator
        from repro_torch.tune.space import Candidate, backend_tag, tile_fits

        dev = self.device
        entry = self.cache.lookup(fshape.key(backend_tag(dev)))
        quant_ok = self.layouts is not None and "quant" in self.layouts
        if (entry is not None and entry.variant in FOREST_VARIANTS
                and (FOREST_VARIANTS[entry.variant].layout == "f32" or quant_ok)):
            spec = get_forest_variant(entry.variant)
            self.resolved = (Candidate.make(entry.variant, **entry.params), "cache")
            self.stats.note_resolution("cache")
            variant, params = self._fused(spec.algorithm, spec.jump_mode, entry.params, spec.layout)
        else:
            sample = np.zeros((fshape.m, fshape.n_attrs), np.float32)
            rows = min(rec_host.shape[0], fshape.m)
            sample[:rows] = rec_host[:rows]
            ev = TunedEvaluator(self.forest.tree(0), cache=self.cache, autotune=self.autotune,
                                engines=self.engines, device=dev)
            ev.depth = max(int(self.forest.max_depth), 1)
            cand, source = ev.resolve(sample)
            self.resolved = (cand, source)
            self.stats.note_resolution(source)
            spec = get_variant(cand.variant)
            variant, params = self._fused(spec.algorithm, spec.jump_mode, cand.param_dict)
        fspec = get_forest_variant(variant)
        bm = params.get("block_m")
        if bm is not None and not tile_fits(fspec.algorithm, int(bm), int(self.forest.n_nodes),
                                            fshape.n_attrs, fspec.jump_mode):
            params = {k: v for k, v in params.items() if k != "block_m"}
        return variant, params

    def _target(self, dev: torch.device, g: int, t_shard: int, variant: str, params: dict,
                n_attrs: int):
        """Tree shard ``g``'s tables on ``dev`` for ``variant``, packed once."""
        spec = get_forest_variant(variant)
        thr = params.get("thr_dtype") if spec.layout == "quant" else None
        key = (dev, g, t_shard, n_attrs, spec.layout, thr)
        target = self._targets.get(key)
        if target is None:
            rows = self._shard_rows(g, t_shard)
            if spec.layout == "quant":
                target = QuantizedForest(rows, n_attrs, thr_dtype=thr or "bfloat16", device=dev)
            else:
                target = PackedForest(rows, n_attrs, device=dev)
            self._targets[key] = target
        return target

    def _build(self, m: int, n_attrs: int, rec_host: np.ndarray) -> _Lowered:
        m_pad, fshape = self._shard_shape(m, n_attrs)
        variant, params = self._shard_kernel(fshape, rec_host)
        self.shard_variant = (variant, params)
        r_n, g_n = self.mesh.devices.shape
        targets = {
            (r, g): self._target(self.mesh[r, g], g, fshape.t, variant, params, n_attrs)
            for r in range(r_n) for g in range(g_n)
        }
        return _Lowered(m_pad, fshape.m, fshape.t, variant, params, targets)

    # -- evaluation ---------------------------------------------------------

    def __call__(self, records) -> torch.Tensor:
        """Evaluate the forest over a record batch across the grid.

        Args:
          records: (M, A) float array or tensor (compared in float32); numpy
            input goes to the grid's first device.

        Returns:
          (T, M) int32 per-tree class assignments on the grid's first device,
          *asynchronously*: nothing here waits on a device, so callers
          (stream chunker, serve engine, benches) own synchronization, which
          is what lets chunk transfer overlap evaluation.
        """
        if not isinstance(records, torch.Tensor):
            records = _device.as_tensor(records, torch.float32, self.device)
        elif records.dtype != torch.float32:
            records = records.float()
        self._prepare(records)
        m, a = records.shape
        self.stats.m_calls.inc()
        self.stats.m_records.inc(int(m))

        if self.plan.n_devices == 1:
            # single-device path: the plain forest-tuned path, no grid.  The
            # ForestTunedEvaluator is built once — its memo makes
            # steady-state calls (serve waves, stream chunks) dict probes.
            with self.tracer.span("kernel.dispatch", cat="kernel", records=int(m), devices=1):
                return self._forest_evaluator()(records)

        low = self._fast.get((m, a))
        if low is None:
            gen = self._gen
            with self.tracer.span("dist.build", cat="dist", records=int(m),
                                  devices=self.plan.n_devices):
                low = self._build(m, a, records[: min(m, 256)].cpu().numpy())
            with self._swap_lock:
                if gen == self._gen:   # don't cache a pre-swap resolution
                    self._fast[(m, a)] = low
        with self.tracer.span("kernel.dispatch", cat="kernel", records=int(m),
                              devices=self.plan.n_devices):
            return self._run(low, records)

    def _run(self, low: _Lowered, records: torch.Tensor) -> torch.Tensor:
        """Pad, launch every shard on its device, gather (T, M) on the first."""
        m, a = records.shape
        if low.m_pad != m:
            padded = torch.zeros((low.m_pad, a), dtype=torch.float32, device=records.device)
            padded[:m] = records
            records = padded
        fn = get_forest_variant(low.variant).fn
        depth = max(int(self.forest.max_depth), 1)
        r_n, g_n = self.mesh.devices.shape
        out = torch.empty((g_n * low.t_shard, low.m_pad), dtype=torch.int32, device=self.device)
        for r in range(r_n):
            rows = records[r * low.m_shard:(r + 1) * low.m_shard]
            for g in range(g_n):
                dev = self.mesh[r, g]
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    shard = fn(rows.to(dev, non_blocking=True), low.targets[(r, g)],
                               max_depth=depth, **low.params)
                self.stats.m_shards.inc()
                out[g * low.t_shard:(g + 1) * low.t_shard,
                    r * low.m_shard:(r + 1) * low.m_shard].copy_(shard, non_blocking=True)
        return out[: self.forest.n_trees, :m]
