"""Decomposition planner: the §3.6 runtime model lifted to a device mesh.

A line-for-line port of the JAX package's ``dist/plan.py``: host math only,
so the port plans exactly as the JAX package does on the same workload.

The paper's analysis is a two-way contest on one SIMD engine — data
decomposition (Procedure 3, T₃) vs speculative decomposition (Procedure 5,
T₅) over M records of mean traversal depth d_µ.  At fleet scale the decision
gains a dimension: D devices can shard the *records* (each device evaluates
every tree over M/R records), the *trees* (each device evaluates T/G trees
over all records), or both (an R×G grid).  This module extends the closed
forms of :mod:`repro_torch.core.analysis` with the mesh-level terms and picks the
factorization with the smallest predicted time.

Symbol map (planner term → §3.6 symbol):

  ``ForestWorkload.m``        → M   (record count)
  ``ForestWorkload.d_mu``     → d_µ (mean traversal depth; measured when the
                                executor has a batch sample, else the
                                geometry prior of ``tune.heuristic``)
  ``MeshCostModel.cm``        → t_e, t_c, t_i, σ, γ (per-engine constants)
  ``MeshCostModel.p_device``  → P   (processors *within* one device — the
                                SIMD lanes T₃/T₅ divide work over)
  ``ShardPlan.record_shards`` → R   (mesh extent of the M/R data slicing,
                                Procedure 3's ``D[m·p .. m(p+1))`` lifted
                                across devices)
  ``ShardPlan.tree_shards``   → G   (mesh extent over the forest; §3.6 is
                                single-tree, so T/G multiplies the per-tree
                                form instead of appearing inside it)
  ``MeshCostModel.sigma_*``   → σ   (t_s(M) = σ·M + γ transmission slopes,
                                split per operand: records in, tree tables
                                in, class assignments out)
  ``MeshCostModel.gamma_launch`` → γ + t_i (per-plan dispatch overhead)
  ``MeshCostModel.gamma_axis``   → t_i per *used* mesh axis — the measured
                                collective-program cost that ranks
                                single-axis meshes over hybrids (calibrated
                                from BENCH_dist.json, see docs/tuning.md)

Per-tree kernel time inside a device comes from
:func:`repro_torch.tune.heuristic.predicted_times` — the same T₃/T₅ evaluation
dispatch uses — so the planner and the autotuner read one model.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.analysis import CostModel


@dataclasses.dataclass(frozen=True)
class ForestWorkload:
    """The (M, T, N, A, d, d_µ) operating point of one forest evaluation."""

    m: int          # M: records
    n_trees: int    # T: trees in the forest
    n_nodes: int    # N: nodes per (padded) tree
    n_attrs: int    # A: record attributes
    depth: int      # max root→leaf depth over the forest (edges)
    d_mu: float     # mean traversal depth (measured or prior)

    @classmethod
    def of(cls, forest, records, *, d_mu: float | None = None) -> "ForestWorkload":
        """Derive the workload from an EncodedForest + record batch.

        ``d_mu`` defaults to the geometry prior (§3.6: between log₂ N and
        depth); the executor passes a measured value when it has records.
        """
        import numpy as np

        from repro_torch.tune.heuristic import default_d_mu
        from repro_torch.tune.space import WorkloadShape

        shape = records.shape if hasattr(records, "shape") else np.asarray(records).shape
        depth = max(int(forest.max_depth), 1)
        if d_mu is None:
            d_mu = default_d_mu(
                WorkloadShape(m=int(shape[0]), n_nodes=int(forest.n_nodes),
                              n_attrs=int(shape[1]), depth=depth)
            )
        return cls(
            m=int(shape[0]),
            n_trees=int(forest.n_trees),
            n_nodes=int(forest.n_nodes),
            n_attrs=int(shape[1]),
            depth=depth,
            d_mu=max(float(d_mu), 1.0),
        )


@dataclasses.dataclass(frozen=True)
class MeshCostModel:
    """§3.6 constants plus the mesh-level transmission/overhead terms.

    All constants are in node-evaluation units (t_e = t_c = 1, the paper's
    normalization).  Absolute values only matter relatively — the planner
    ranks factorizations, it does not predict milliseconds.

    Defaults are the JAX package's, **calibrated** from its measured
    ``results/BENCH_dist.json`` sweep on a forced-8-host-device CPU mesh
    via :func:`calibrate_mesh_cost` (derivation in ``docs/tuning.md``), and
    kept so that both planners plan alike.  They are **not** constants of
    an H100 or of a node of several H100s: no fit on cards exists yet, and
    it needs several cards to make.  In that fit the σ transmission slopes
    came out orders of magnitude below the old 0.05 priors
    (a host "mesh" has no wire — transfers are memcpys), and the dispatch
    overhead splits into a per-plan constant plus ``gamma_axis`` — a
    collective-program cost per *used* mesh axis.  σ_tree fit to zero and
    is floored at σ_rec/10 to preserve the record-vs-tree transfer
    asymmetry on meshes with a real interconnect.
    """

    cm: CostModel = CostModel(t_e=1.0, t_c=1.0)
    p_device: float = 128.0      # P per device: the 128-lane SIMD width
    sigma_rec: float = 1.1e-3    # σ per record element scattered to a device
    sigma_tree: float = 1.1e-4   # σ per tree-table element broadcast to a device
    sigma_out: float = 1.1e-3    # σ per class assignment gathered back
    gamma_launch: float = 135.0  # γ + t_i: per-plan dispatch overhead
    gamma_axis: float = 105.0    # per used mesh axis (R>1, G>1): collective program cost

    def n_axes(self, record_shards: int, tree_shards: int) -> int:
        """Mesh axes a (R, G) factorization actually uses (0, 1 or 2)."""
        return int(record_shards > 1) + int(tree_shards > 1)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One (R, G) factorization with its model-predicted cost.

    ``algorithm`` is the §3.6 winner *within* a device shard (the same
    choice ``repro_torch.tune``'s heuristic would make at the shard shape), kept
    for provenance — actual kernel selection happens through the tune cache
    at execution time.
    """

    record_shards: int          # R
    tree_shards: int            # G
    algorithm: str              # 'speculative' | 'data_parallel' (per-shard T₅ vs T₃)
    predicted: float            # model time units (rank-valid, not ms)

    @property
    def n_devices(self) -> int:
        return self.record_shards * self.tree_shards

    @property
    def decomposition(self) -> str:
        r, g = self.record_shards > 1, self.tree_shards > 1
        if r and g:
            return "hybrid"
        if r:
            return "records"
        if g:
            return "trees"
        return "single"


def shard_extents(wl: ForestWorkload, record_shards: int, tree_shards: int) -> tuple[int, int]:
    """(records, trees) held by each device, after divisibility padding.

    Args:
      wl: the forest workload being factorized.
      record_shards/tree_shards: the (R, G) mesh extents.

    Returns:
      (M/R, T/G) rounded up — what one device actually evaluates once the
      executor pads records/trees to mesh-divisible counts.
    """
    return (
        math.ceil(max(wl.m, 1) / record_shards),
        math.ceil(wl.n_trees / tree_shards),
    )


def predicted_plan_time(
    wl: ForestWorkload,
    record_shards: int,
    tree_shards: int,
    mesh_cost: MeshCostModel = MeshCostModel(),
) -> tuple[float, str]:
    """Model time of the (R, G) factorization; returns (time, algorithm).

    Devices run concurrently, so the plan costs what one device pays:

        T(R, G) = (T/G) · min(T₃, T₅)(M/R; P_dev)          compute
                + σ_rec·(M/R)·A + σ_tree·(T/G)·4N          operand scatter
                + σ_out·(T/G)·(M/R)                        result gather
                + γ_launch + γ_axis·[(R>1) + (G>1)]        dispatch

    with T₃/T₅ evaluated by ``repro_torch.tune.heuristic.predicted_times`` at the
    shard operating point (same closed forms dispatch uses).  The γ_axis
    term is the calibrated per-mesh-axis collective-program cost (§3.6's
    t_i paid once per sharded axis): it is what ranks single-axis meshes
    over hybrids when the transmission terms are small.
    """
    from repro_torch.tune.heuristic import predicted_times
    from repro_torch.tune.space import WorkloadShape

    m_shard, t_shard = shard_extents(wl, record_shards, tree_shards)
    shape = WorkloadShape(m=m_shard, n_nodes=wl.n_nodes, n_attrs=wl.n_attrs, depth=wl.depth)
    times = predicted_times(shape, cm=mesh_cost.cm, d_mu=wl.d_mu, p_total=mesh_cost.p_device)
    algorithm = min(times, key=times.get)
    compute = t_shard * times[algorithm]
    scatter = (
        mesh_cost.sigma_rec * m_shard * wl.n_attrs
        + mesh_cost.sigma_tree * t_shard * 4 * wl.n_nodes  # 4 tables per tree
    )
    gather = mesh_cost.sigma_out * t_shard * m_shard
    dispatch = mesh_cost.gamma_launch + mesh_cost.gamma_axis * mesh_cost.n_axes(
        record_shards, tree_shards
    )
    return compute + scatter + gather + dispatch, algorithm


def make_plan(
    wl: ForestWorkload,
    record_shards: int,
    tree_shards: int,
    mesh_cost: MeshCostModel = MeshCostModel(),
) -> ShardPlan:
    """An explicit (R, G) plan with its predicted cost filled in."""
    t, alg = predicted_plan_time(wl, record_shards, tree_shards, mesh_cost)
    return ShardPlan(record_shards=record_shards, tree_shards=tree_shards,
                     algorithm=alg, predicted=t)


def enumerate_plans(
    wl: ForestWorkload,
    n_devices: int,
    mesh_cost: MeshCostModel = MeshCostModel(),
) -> list[ShardPlan]:
    """Every feasible (R, G) factorization with R·G ≤ D, costed.

    Feasibility: no more record shards than records, no more tree shards
    than trees (an idle shard is never predicted-cheaper, but a plan may
    legitimately leave devices idle when the workload is too small to fill
    them).  The degenerate (1, 1) plan is always present.
    """
    out: dict[tuple[int, int], ShardPlan] = {}
    for r in range(1, n_devices + 1):
        if r > max(wl.m, 1):
            continue
        for g in range(1, n_devices // r + 1):
            if g > wl.n_trees:
                continue
            out[(r, g)] = make_plan(wl, r, g, mesh_cost)
    if (1, 1) not in out:
        out[(1, 1)] = make_plan(wl, 1, 1, mesh_cost)
    return sorted(out.values(), key=lambda p: (p.predicted, -p.record_shards, p.tree_shards))


def calibrate_mesh_cost(
    bench_path,
    *,
    p_device: float = 128.0,
    min_gamma: float = 1.0,
    sigma_tree_floor_frac: float = 0.1,
) -> MeshCostModel:
    """Fit σ slopes + γ terms to a measured ``BENCH_dist.json`` sweep.

    The planner's prediction is linear in its unknown constants once the
    §3.6 compute term is evaluated at each (workload, mesh) point:

        T(R, G) ≈ α·compute + β_rec·(M/R)·A + β_tree·(T/G)·4N
                  + β_out·(T/G)·(M/R) + γ_ax·[(R>1)+(G>1)] + γ₀   [ms]

    A one-shot regression is ill-posed on sweep data, because R·G = D is
    constant across a workload's meshes: the compute and result-gather
    terms are then *identical* within every workload and only vary across
    the few workloads.  The fit is therefore staged:

      1. **within-workload** (per-workload demeaned rows): identifies the
         slopes that rank meshes — β_rec, β_tree and the per-axis
         dispatch cost γ_ax — free of workload-level offsets;
      2. **across-workload** (one equation per workload mean, stage-1
         slopes subtracted, β_out tied to β_rec — assignments ride the
         same wire as records): identifies the scale α (ms per
         node-evaluation unit) and the constant launch cost γ₀.

    Negative stage-1 coefficients are clamped to zero (the constants are
    physically non-negative; on a forced-host "mesh" the transfer slopes
    genuinely fit ≈ 0 — there is no wire).  Dividing the millisecond
    coefficients by α returns them to the planner's node-evaluation
    units: ``σ* = β*/α``, ``γ_axis = γ_ax/α``, ``γ_launch = γ₀/α``.

    Args:
      bench_path: path to a ``results/BENCH_dist.json`` written by
        ``benchmarks/dist_sweep.py`` (needs ``summaries[].workload_shape``
        and the per-mesh ``entries[]``).
      p_device: P per device when evaluating the compute term (must match
        what the planner will use).
      min_gamma: floor for ``gamma_launch`` (a zero launch overhead makes
        the planner prefer degenerate over-sharding).
      sigma_tree_floor_frac: floor for σ_tree as a fraction of σ_rec,
        preserving the record-vs-tree transfer asymmetry when σ_tree fits
        to zero.

    Returns:
      A :class:`MeshCostModel` with fitted ``sigma_*`` / ``gamma_*``.  The
      derivation — and the fitted constants baked into this class's
      defaults — is recorded in ``docs/tuning.md``.
    """
    import json
    from pathlib import Path

    import numpy as np

    from repro_torch.tune.heuristic import predicted_times
    from repro_torch.tune.space import WorkloadShape

    raw = json.loads(Path(bench_path).read_text())
    shapes = {s["workload"]: s["workload_shape"] for s in raw.get("summaries", [])}
    per_wl: dict[str, list[dict]] = {}
    for e in raw.get("entries", []):
        if e.get("mode") or e["workload"] not in shapes:
            continue  # streaming entries measure overlap, not the plan form
        wl_ = ForestWorkload(**shapes[e["workload"]])
        r, g = e["mesh"]
        m_shard, t_shard = shard_extents(wl_, r, g)
        shape = WorkloadShape(m=m_shard, n_nodes=wl_.n_nodes,
                              n_attrs=wl_.n_attrs, depth=wl_.depth)
        times = predicted_times(shape, d_mu=wl_.d_mu, p_total=p_device)
        per_wl.setdefault(e["workload"], []).append({
            "compute": t_shard * min(times.values()),
            "rec": m_shard * wl_.n_attrs,
            "tree": t_shard * 4 * wl_.n_nodes,   # 4 tables per tree
            "out": t_shard * m_shard,
            "axes": float((r > 1) + (g > 1)),
            "ms": float(e["measured_ms"]),
        })
    n_rows = sum(len(v) for v in per_wl.values())
    if len(per_wl) < 2 or n_rows < 6:
        raise ValueError(f"{bench_path}: too few plan entries to fit ({n_rows})")

    # stage 1: per-workload demeaned slopes (β_rec, β_tree, γ_ax in ms)
    xs, ys = [], []
    for rows in per_wl.values():
        f = lambda k: np.array([r[k] for r in rows], float)  # noqa: E731
        cols = np.stack([f("rec"), f("tree"), f("axes")], axis=1)
        xs.append(cols - cols.mean(axis=0))
        ys.append(f("ms") - f("ms").mean())
    sol, *_ = np.linalg.lstsq(np.concatenate(xs), np.concatenate(ys), rcond=None)
    b_rec, b_tree, b_axis = np.maximum(sol, 0.0)

    # stage 2: workload means identify α and γ₀ (β_out tied to β_rec)
    lhs, rhs = [], []
    for rows in per_wl.values():
        f = lambda k: np.mean([r[k] for r in rows])  # noqa: E731
        resid = (
            f("ms") - b_rec * f("rec") - b_tree * f("tree")
            - b_rec * f("out") - b_axis * f("axes")
        )
        lhs.append([f("compute"), 1.0])
        rhs.append(resid)
    (alpha, gamma0), *_ = np.linalg.lstsq(np.asarray(lhs), np.asarray(rhs), rcond=None)
    if alpha <= 0:
        # measured times anti-correlated with the compute term: the data
        # cannot anchor the unit scale, keep the current defaults
        return MeshCostModel(p_device=p_device)

    sigma_rec = float(b_rec / alpha)
    sigma_tree = float(max(b_tree / alpha, sigma_tree_floor_frac * sigma_rec))
    return MeshCostModel(
        p_device=p_device,
        sigma_rec=sigma_rec,
        sigma_tree=sigma_tree,
        sigma_out=sigma_rec,
        gamma_launch=float(max(gamma0 / alpha, min_gamma)),
        gamma_axis=float(b_axis / alpha),
    )


def plan_forest(
    wl: ForestWorkload,
    n_devices: int | None = None,
    *,
    mesh_cost: MeshCostModel = MeshCostModel(),
    decomposition: str | None = None,
) -> ShardPlan:
    """Choose the cheapest predicted factorization for this workload.

    ``decomposition`` forces the family ('records' | 'trees' | 'hybrid') —
    used by the crossover bench and by callers that must match an existing
    mesh.  Ties break toward more record shards (replication-free operands).
    On one device the plan degrades to (1, 1) and the executor runs the
    plain tuned path with no device grid.  ``n_devices`` defaults to the
    node's cards (one without any: the host).
    """
    if n_devices is None:
        import torch

        n_devices = max(torch.cuda.device_count(), 1)
    plans = enumerate_plans(wl, n_devices, mesh_cost)
    if decomposition is not None:
        wanted = [p for p in plans if p.decomposition == decomposition]
        if not wanted:
            raise ValueError(
                f"no feasible {decomposition!r} plan for {wl} on {n_devices} devices"
            )
        plans = wanted
    return plans[0]
