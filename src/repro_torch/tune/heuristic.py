"""Model-based fallback: pick a variant from the paper's runtime analysis.

When the cache has no entry for a shape bucket (first call on a new machine,
or tuning disabled) dispatch still has to pick a variant.  We evaluate the
paper's closed-form runtime model (§3.6 / §4 analysis,
:mod:`repro_torch.core.analysis`) at the workload's operating point:

    T₃(P) = (M/P)·d_µ·(t_e + t_c) + t_i + t_s(M)          (data decomposition)
    T₅(P) = (M·p/P)·(t_e + log₂(d_µ)·t_c) + t_i + t_s(M)  (speculative)

with p = the record-group processor count (the internal nodes each record's
group evaluates speculatively).  The cheaper predicted time picks the
algorithm — equivalently, equation (1)'s crossover
``p < 2·d_µ/(1 + log₂ d_µ)`` under t_e ≈ t_c.  The model, its constants and
so its algorithm choice are the JAX package's, unchanged.

The engine rule differs: the hand-written kernels (``cuda``) whenever they
are permitted, and always the gather form of the speculative kernels.  The
JAX package picks its one-hot form on a TPU, whose gathers are slow; on the
card the one-hot form costs 2.2× the gather form (PERF.md), so the port's
heuristic never picks it.  A tree too large for any tile of the chosen
algorithm falls to the other algorithm's kernel, then to the ``torch``
engine when permitted, else the tile refusal propagates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.analysis import CostModel, t3_data_parallel, t5_speculative
from repro_torch.kernels.tree_eval import kernel as _k
from repro_torch.kernels.tree_eval.cascade import MAJORITY_FAMILY, plan_cascade
from repro_torch.kernels.tree_eval.ops import PER_TREE_FAMILY, choose_block_m
from repro_torch.tune.space import (
    Candidate,
    ForestShape,
    WorkloadShape,
    cascade_stage_grid,
    default_engines,
)

# Per-launch dispatch overhead in §3.6 node-evaluation units (the planner's
# γ_launch prior): what the per-tree family pays T times and the stacked
# families pay once.  Only the *ratio* against the compute terms matters —
# the heuristic ranks families, it does not predict milliseconds.
FOREST_LAUNCH_OVERHEAD = 50.0


def default_p_group(shape: WorkloadShape) -> int:
    """Processors per record group: the internal nodes of a full binary tree."""
    return max(1, (shape.n_nodes - 1) // 2)


def default_d_mu(shape: WorkloadShape) -> float:
    """Estimated mean traversal depth when no measurement is supplied.

    Real d_µ lies between log₂(leaves) (balanced) and depth (vine); the
    midpoint is a serviceable prior for an untuned shape.
    """
    balanced = math.log2(max(shape.n_nodes, 2))
    return max(1.0, (balanced + shape.depth) / 2.0)


def _host_sample(records, sample: int) -> np.ndarray:
    """The first ``sample`` records on the host, as f32 numpy."""
    rec = records[:sample]
    if isinstance(rec, torch.Tensor):
        return rec.detach().to("cpu", torch.float32).numpy()
    return np.asarray(rec, np.float32)


def measured_d_mu(enc, records, *, sample: int = 256) -> float:
    """d_µ measured on a record sample (the paper's "significant sample").

    The geometry prior of :func:`default_d_mu` can sit far from the truth —
    a deep vine whose traffic all exits at the first split has measured
    d_µ ≈ 1 but a large prior — and equation (1)'s crossover moves with d_µ.
    Dispatch feeds the batch through the branchless descent (on the host,
    on at most ``sample`` records) and hands the measured mean to the model.
    """
    from repro_torch.core.analysis import mean_traversal_depth, observed_depths

    rec = _host_sample(records, sample)
    if rec.shape[0] == 0:
        return 1.0
    return max(1.0, float(mean_traversal_depth(observed_depths(enc, rec))))


def predicted_times(
    shape: WorkloadShape,
    *,
    cm: CostModel = CostModel(),
    d_mu: float | None = None,
    p_group: float | None = None,
    p_total: float = 1.0,
) -> dict[str, float]:
    """§3.6 model runtimes per algorithm for this shape.

    Returns:
      {"data_parallel": T₃, "speculative": T₅} in model units — rank-valid
      per shape, not milliseconds.
    """
    d = d_mu if d_mu is not None else default_d_mu(shape)
    d = max(float(d), 1.0)
    p = p_group if p_group is not None else default_p_group(shape)
    return {
        "data_parallel": t3_data_parallel(shape.m, d, p_total, cm),
        "speculative": t5_speculative(shape.m, d, p_total, p, cm),
    }


def _kernel_tile(shape: WorkloadShape, algorithm: str, n_classes: int = 0) -> int | None:
    """The gather-form tile of ``algorithm``'s kernel at the bucket's upper
    N and A, or None when no tile fits."""
    b = shape.bucket()
    try:
        return choose_block_m(b.n_nodes, b.n_attrs, algorithm=algorithm, jump_mode="gather",
                              n_classes=n_classes)
    except _k.TileError:
        return None


def _kernel_choice(shape: WorkloadShape, algorithm: str, engines, n_classes: int = 0):
    """(algorithm, block_m) of the kernel to run, or None for the torch engine.

    The model's algorithm if its tile fits, else the other one's; raises the
    tile refusal when neither fits and ``torch`` is not permitted.
    """
    other = "data_parallel" if algorithm == "speculative" else "speculative"
    for alg in (algorithm, other):
        bm = _kernel_tile(shape, alg, n_classes)
        if bm is not None:
            return alg, bm
    if "torch" in engines:
        return None
    b = shape.bucket()
    raise _k.TileError(f"no kernel tile fits N={b.n_nodes} nodes and A={b.n_attrs} attributes")


def heuristic_candidate(
    shape: WorkloadShape,
    *,
    cm: CostModel = CostModel(),
    d_mu: float | None = None,
    p_group: float | None = None,
    engines: tuple[str, ...] | None = None,
    device=None,
) -> Candidate:
    """Shape-derived variant choice mirroring the paper's analysis."""
    times = predicted_times(shape, cm=cm, d_mu=d_mu, p_group=p_group)
    algorithm = min(times, key=times.get)
    engines = default_engines(device) if engines is None else tuple(engines)
    if "cuda" in engines:
        choice = _kernel_choice(shape, algorithm, engines)
        if choice is not None:
            alg, bm = choice
            name = "cuda_data_parallel" if alg == "data_parallel" else "cuda_speculative_gather"
            return Candidate.make(name, block_m=bm)

    if algorithm == "data_parallel":
        return Candidate.make("torch_data_parallel")
    # paper: 2 jumps per synchronisation round was the measured optimum
    return Candidate.make("torch_speculative_gather", jumps_per_round=2)


# ---------------------------------------------------------------------------
# Forest-level heuristic: per-tree vector vs stacked (batched / fused)
# ---------------------------------------------------------------------------


def measured_forest_d_mu(forest, records, *, trees: int = 4, sample: int = 256) -> float:
    """Forest d_µ: measured mean over a few trees × a record sample.

    Returns:
      Mean traversal depth ≥ 1.0 — the d_µ the §3.6 forms are evaluated at.
    """
    rec = _host_sample(records, sample)
    picked = range(min(int(forest.n_trees), max(trees, 1)))
    return float(np.mean([measured_d_mu(forest.tree(i), rec, sample=sample) for i in picked]))


def forest_heuristic_candidate(
    shape: ForestShape,
    *,
    cm: CostModel = CostModel(),
    d_mu: float | None = None,
    p_group: float | None = None,
    engines: tuple[str, ...] | None = None,
    families: tuple[str, ...] | None = None,
    launch_overhead: float = FOREST_LAUNCH_OVERHEAD,
    device=None,
) -> Candidate:
    """Model-based forest family + variant choice (the no-cache fallback).

    The stacked families evaluate every tree at the *padded* common geometry
    — each tree pays the deepest tree's rounds — but launch once; the
    per-tree family pays each tree's own depth but launches T times.  With
    t(d) = the §3.6 winner's time at depth-profile point d:

        stacked  ≈ T · t(depth_max)                + γ
        per-tree ≈ T · (t(depth_min)+t(depth_max))/2 + T·γ

    A homogeneous profile therefore always picks a stacked family; a spread
    profile flips to per-tree once the padding waste outgrows the saved
    launches.  Within the stacked families: the fused kernels when ``cuda``
    is permitted, the batched torch path otherwise.

    Returns:
      A :class:`Candidate` — ``Candidate(PER_TREE_FAMILY)`` or a registered
      forest variant with its parameters filled in.
    """
    engines = default_engines(device) if engines is None else tuple(engines)
    families = ("per_tree", "batched", "fused") if families is None else tuple(families)

    deep = WorkloadShape(m=shape.m, n_nodes=shape.n_nodes,
                         n_attrs=shape.n_attrs, depth=shape.depth_max)
    shallow = WorkloadShape(m=shape.m, n_nodes=shape.n_nodes,
                            n_attrs=shape.n_attrs, depth=shape.depth_min)

    def best_time(s: WorkloadShape, d: float | None) -> float:
        return min(predicted_times(s, cm=cm, d_mu=d, p_group=p_group).values())

    # d_µ scales with the profile point: a measured/maximum-depth d_µ maps
    # onto the shallow end proportionally (the prior does this implicitly).
    d_deep = d_mu
    d_shallow = None if d_mu is None else max(1.0, d_mu * shape.depth_min / max(shape.depth_max, 1))
    t_deep = best_time(deep, d_deep)
    t_shallow = best_time(shallow, d_shallow)

    stacked_cost = shape.t * t_deep + launch_overhead
    per_tree_cost = shape.t * (t_deep + t_shallow) / 2.0 + shape.t * launch_overhead

    # a stacked family is usable only when its engine is permitted: fused is
    # the kernel path, batched the torch one
    stacked_ok = [
        f for f in ("fused", "batched")
        if f in families and (("cuda" in engines) if f == "fused" else ("torch" in engines))
    ]
    if not stacked_ok and PER_TREE_FAMILY not in families:
        # the caller forced stacked families whose engines they excluded:
        # honour the family request over the engine filter
        stacked_ok = [f for f in ("fused", "batched") if f in families]
    want_stacked = bool(stacked_ok) and (
        PER_TREE_FAMILY not in families or stacked_cost <= per_tree_cost
    )
    if not want_stacked:
        return Candidate.make(PER_TREE_FAMILY)

    times = predicted_times(deep, cm=cm, d_mu=d_deep, p_group=p_group)
    algorithm = min(times, key=times.get)
    family = stacked_ok[0]
    if family == "fused":
        # a forest no kernel tile fits falls to the batched family if permitted
        choice = _kernel_choice(deep, algorithm, ("torch",) if "batched" in stacked_ok else ())
        if choice is not None:
            alg, bm = choice
            name = ("forest_fused_data_parallel" if alg == "data_parallel"
                    else "forest_fused_speculative_gather")
            return Candidate.make(name, block_m=bm)
        family = "batched"
    if algorithm == "data_parallel":
        return Candidate.make(f"forest_{family}_data_parallel")
    # paper: 2 jumps per synchronisation round was the measured optimum
    return Candidate.make(f"forest_{family}_speculative_gather", jumps_per_round=2)


# ---------------------------------------------------------------------------
# Class-level heuristic: full majority vote vs early-exit cascade
# ---------------------------------------------------------------------------


def measured_survival_rate(
    forest,
    records,
    n_classes: int,
    *,
    plan=None,
    stages: int = 2,
    bound: float = 1.0,
    sample: int = 256,
) -> tuple[float, ...]:
    """Fraction of records entering each cascade stage, measured on a sample.

    Simulates the exit rule on the reference per-tree classes (host, no
    kernels): accumulate votes stage by stage in the plan's tree order and
    retire records whose margin exceeds ``bound`` times the remaining tree
    count.  Element 0 is always 1.0.
    """
    from repro_torch.kernels.tree_eval.ref import forest_eval_ref

    rec = _host_sample(records, max(1, int(sample)))
    if plan is None:
        plan = plan_cascade(forest, rec, n_classes=n_classes, stages=stages, bound=bound,
                            device="cpu")
    per_tree = forest_eval_ref(
        rec, forest.attr_idx, forest.threshold, forest.child, forest.class_val,
        max_depth=int(forest.max_depth), device="cpu",
    ).numpy()
    m = rec.shape[0]
    t_total = plan.n_trees
    c = max(int(n_classes), int(per_tree.max(initial=0)) + 1, 2)
    votes = np.zeros((m, c), np.int32)
    alive = np.ones((m,), bool)
    out: list[float] = []
    done = 0
    for size in plan.stage_sizes:
        out.append(float(alive.mean()) if m else 0.0)
        for j in range(done, done + size):
            votes[np.arange(m), per_tree[plan.order[j]]] += 1
        done += size
        remaining = t_total - done
        if remaining > 0:
            top2 = np.partition(votes, -2, axis=1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            alive &= ~(margin > bound * remaining)
    return tuple(out)


def default_survival(n_stages: int) -> tuple[float, ...]:
    """Survival prior when no calibration batch is available: everyone
    enters stage 0, each later stage keeps about half its predecessor's."""
    return tuple(min(1.0, 0.5**s) for s in range(max(1, int(n_stages))))


def cascade_heuristic_candidate(
    shape: ForestShape,
    n_classes: int,
    *,
    survival: tuple[float, ...] | None = None,
    cm: CostModel = CostModel(),
    d_mu: float | None = None,
    p_group: float | None = None,
    engines: tuple[str, ...] | None = None,
    launch_overhead: float = FOREST_LAUNCH_OVERHEAD,
    device=None,
) -> Candidate:
    """Model-based class-level choice: majority vote vs early-exit cascade.

    Extends the §3.6 forest model by the survival-rate term.  With t(d) the
    per-tree winner's model time, surv_s the fraction of records entering
    stage s and size_s the stage's tree count:

        full     ≈ T · t(d)                     + γ
        cascade  ≈ Σ_s size_s · surv_s · t(d)   + S · γ

    The best stage count from :func:`cascade_stage_grid` competes against
    the full path; ties go to the full path.
    """
    engines = default_engines(device) if engines is None else tuple(engines)
    deep = shape.tree_shape()
    t_tree = min(predicted_times(deep, cm=cm, d_mu=d_mu, p_group=p_group).values())
    full_cost = shape.t * t_tree + launch_overhead

    grid = cascade_stage_grid(shape)
    best: tuple[float, int] | None = None
    for s in grid:
        plan = plan_cascade(_ShapeForest(shape), n_classes=n_classes, stages=s, bound=1.0)
        surv = survival if survival is not None else default_survival(plan.n_stages)
        cost = plan.n_stages * launch_overhead
        for i, size in enumerate(plan.stage_sizes):
            f = surv[i] if i < len(surv) else default_survival(i + 1)[-1]
            cost += size * max(0.0, min(1.0, f)) * t_tree
        if best is None or cost < best[0]:
            best = (cost, s)

    if best is None or best[0] >= full_cost:
        return Candidate.make(MAJORITY_FAMILY)

    stages = best[1]
    times = predicted_times(deep, cm=cm, d_mu=d_mu, p_group=p_group)
    algorithm = min(times, key=times.get)
    if "cuda" in engines:
        choice = _kernel_choice(deep, algorithm, engines, max(int(n_classes), 2))
        if choice is not None:
            alg, bm = choice
            suffix = "data_parallel" if alg == "data_parallel" else "speculative_gather"
            return Candidate.make(f"forest_cascade_fused_{suffix}", stages=stages, block_m=bm)
    suffix = "data_parallel" if algorithm == "data_parallel" else "speculative_gather"
    return Candidate.make(f"forest_cascade_batched_{suffix}", stages=stages)


class _ShapeForest:
    """Just enough forest surface for :func:`plan_cascade` stage sizing."""

    def __init__(self, shape: ForestShape):
        self.n_trees = int(shape.t)
