"""Early-exit cascade evaluation of a packed forest (staged majority vote).

The paper's speculative decomposition spends SIMD lanes on work that *might*
be needed; the cascade is the dual lever at forest scale — stop spending
lanes on work that *cannot change the answer*.  Trees are ordered by
discriminative power and evaluated in stages; after each stage every
record's vote margin (top-1 minus top-2 vote count) is compared against a
confidence bound derived from the number of remaining trees:

    margin > bound * remaining

With ``bound = 1.0`` the inequality is exact — even if every remaining tree
voted for the runner-up class the leader could not be overtaken (strict
``>`` matters: the majority vote breaks ties toward the *lower* class index,
so a tied finish may flip the answer and must not exit).  Records that clear
the bound exit; the survivors are **compacted** into a dense tile on the
device (gather), the next stage runs only on them, and their votes are
scattered back.

``bound=None`` disables the exit entirely, making the cascade's classes
equal ``majority_vote`` of the whole forest (vote counts are invariant under
tree reordering).  ``bound < 1`` trades exactness for speed; the per-record
``confidence`` output reports how decided each answer is.

An optional per-call ``deadline_ms`` gives *anytime* semantics: evaluation
stops at the deepest stage the remaining latency budget allows (stage 0
always runs) and the partial-margin confidence is reported for records the
truncated stages never re-examined.

The stage loop runs on the host, as in the JAX package; everything else —
the vote tally, the survivor gather and scatter, the exit test — runs on the
evaluator's device.  The one host read per stage is the survivor count,
which sizes the next launch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import _device, obs
from repro_torch.core.eval_dataparallel import eval_data_parallel
from repro_torch.core.eval_speculative import eval_speculative
from repro_torch.core.forest import vote_counts, vote_winner
from repro_torch.kernels.tree_eval import ops as _ops

# Vote margins are integer counts bounded by the forest size; a coarse
# power-of-two grid keeps the exit-margin histograms readable at any T.
_MARGIN_BOUNDARIES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

# Family name a class-level tuner uses for the plain "evaluate everything,
# then majority-vote" path (no early exit); defined next to the cascade
# registry so the vocabulary for class-level winners lives in one place.
MAJORITY_FAMILY = "forest_majority"

CASCADE_FAMILY = "cascade"

ENGINES = ("cuda", "torch")

# Smallest survivor bucket of the stage-latency estimate (one sublane of
# the JAX package's row padding, kept so deadlines key alike).
_MIN_BUCKET = 8


# ---------------------------------------------------------------------------
# Plan: tree order + stage geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """Tree evaluation order and how many trees each stage takes.

    ``order`` is a permutation of the forest's tree indices, most
    discriminative first; ``stage_sizes`` partitions it into consecutive
    stages.  The first stage is the *exit-enabling prefix*: with ``k`` trees
    evaluated and ``T - k`` remaining, an exit requires
    ``margin > bound * (T - k)`` and the margin after ``k`` unanimous trees
    is at most ``k``, so the smallest useful first stage is
    ``k_min = floor(bound * T / (1 + bound)) + 1``.
    """

    order: tuple[int, ...]
    stage_sizes: tuple[int, ...]

    def __post_init__(self):
        if sum(self.stage_sizes) != len(self.order):
            raise ValueError(
                f"stage_sizes {self.stage_sizes} must partition the "
                f"{len(self.order)}-tree order"
            )
        if any(s <= 0 for s in self.stage_sizes):
            raise ValueError(f"stage sizes must be positive: {self.stage_sizes}")
        if sorted(self.order) != list(range(len(self.order))):
            raise ValueError("order must be a permutation of range(n_trees)")

    @property
    def n_trees(self) -> int:
        return len(self.order)

    @property
    def n_stages(self) -> int:
        return len(self.stage_sizes)

    def stage_trees(self, s: int) -> tuple[int, ...]:
        start = sum(self.stage_sizes[:s])
        return self.order[start : start + self.stage_sizes[s]]


def exit_enabling_prefix(n_trees: int, bound: float) -> int:
    """Smallest first-stage size after which an early exit is possible."""
    k = int(np.floor(bound * n_trees / (1.0 + bound))) + 1
    return min(max(k, 1), n_trees)


def rank_trees(
    forest, records, *, n_classes: int, sample: int = 512, device=None
) -> tuple[int, ...]:
    """Order trees by agreement with the full-forest majority vote.

    A tree that usually agrees with the ensemble's final answer drives the
    margin up fastest when placed early, which is exactly what the exit
    bound rewards.  Ranked on (a sample of) a calibration batch with the
    fused data-parallel forest kernel (K4; its plain version on the CPU),
    whose classes are those of the reference evaluator; the ranking itself
    is host numpy, and the stable sort keeps the original order among ties
    so plans are deterministic.
    """
    if not isinstance(records, torch.Tensor):
        records = np.asarray(records, np.float32)
    if records.ndim != 2 or records.shape[0] == 0:
        return tuple(range(int(forest.n_trees)))
    rec = records[: max(1, int(sample))]
    per_tree = (
        _ops.forest_eval_fused(rec, forest, algorithm="data_parallel", device=device)
        .cpu()
        .numpy()
    )  # (T, M)
    m = per_tree.shape[1]
    c = max(int(n_classes), int(per_tree.max(initial=0)) + 1, 2)
    votes = np.zeros((m, c), np.int32)
    for t in range(per_tree.shape[0]):
        votes[np.arange(m), per_tree[t]] += 1
    maj = votes.argmax(axis=1)
    agreement = (per_tree == maj[None, :]).mean(axis=1)
    return tuple(int(i) for i in np.argsort(-agreement, kind="stable"))


def plan_cascade(
    forest,
    records=None,
    *,
    n_classes: int,
    stages: int = 2,
    bound: float | None = 1.0,
    sample: int = 512,
    order: tuple[int, ...] | None = None,
    device=None,
) -> CascadePlan:
    """Build a :class:`CascadePlan` for ``forest``.

    Args:
      records: optional calibration batch used to rank trees by
        discriminative power (see :func:`rank_trees`); without it trees run
        in their stored order.
      stages: requested stage count (clamped to what the forest admits).
      bound: the exit bound the plan should enable; sizes the first stage at
        the exit-enabling prefix.  ``None`` plans as if ``1.0``.
      order: explicit tree order overriding calibration.
      device: where :func:`rank_trees` evaluates the calibration batch.
    """
    t = int(forest.n_trees)
    if order is None:
        if records is not None:
            order = rank_trees(forest, records, n_classes=n_classes, sample=sample, device=device)
        else:
            order = tuple(range(t))
    order = tuple(int(i) for i in order)
    if sorted(order) != list(range(t)):
        raise ValueError("order must be a permutation of the forest's tree indices")
    stages = max(1, min(int(stages), t))
    b = 1.0 if bound is None else float(bound)
    if b <= 0.0:
        raise ValueError(f"bound must be positive (or None), got {bound}")
    if stages == 1:
        return CascadePlan(order=order, stage_sizes=(t,))
    first = exit_enabling_prefix(t, b)
    rest = t - first
    n_rest = min(stages - 1, rest)
    if n_rest == 0:
        return CascadePlan(order=order, stage_sizes=(t,))
    base, extra = divmod(rest, n_rest)
    sizes = (first,) + tuple(base + (1 if i < extra else 0) for i in range(n_rest))
    return CascadePlan(order=order, stage_sizes=sizes)


# ---------------------------------------------------------------------------
# Stage forests
# ---------------------------------------------------------------------------


class _StageForest:
    """A subset of a forest's trees with the (T, N) table surface of
    ``EncodedForest``.

    Keeps the whole forest's ``max_depth``, as the JAX package's does, so a
    stage runs the same number of rounds (and jumps) as the whole forest.
    """

    def __init__(self, forest, tree_ids: tuple[int, ...]):
        idx = list(tree_ids)
        self.n_trees = len(idx)
        self.n_nodes = int(forest.n_nodes)
        self.max_depth = int(forest.max_depth)
        self.attr_idx = np.asarray(forest.attr_idx)[idx]
        self.threshold = np.asarray(forest.threshold)[idx]
        self.child = np.asarray(forest.child)[idx]
        self.class_val = np.asarray(forest.class_val)[idx]


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class CascadeResult(NamedTuple):
    """Per-record outcome of one cascade evaluation.

    Attributes (tensors on the evaluator's device):
      classes: (M,) int32 predicted class per record.
      margin: (M,) int32 final top-1 minus top-2 vote count.
      trees_evaluated: (M,) int32 trees that actually voted per record.
      exit_stage: (M,) int32 stage index at which the record cleared the
        bound, or -1 (ran every executed stage).
      stages_run: number of stages executed (< plan.n_stages when the
        deadline truncated the cascade or every record exited).
      confidence: (M,) float32 in [0, 1]; 1.0 when the answer is provably
        final, otherwise the partial-margin ratio ``margin / remaining``.
      stage_survivors: records entering each executed stage.
    """

    classes: torch.Tensor
    margin: torch.Tensor
    trees_evaluated: torch.Tensor
    exit_stage: torch.Tensor
    stages_run: int
    confidence: torch.Tensor
    stage_survivors: tuple[int, ...]


def _pad_rows(n: int) -> int:
    """Bucket a survivor count to the next power of two (≥ 8).

    The kernels take ragged survivor counts as they are; the bucket only
    keys the stage-latency estimate, as the JAX package's padded row count
    does.
    """
    p = _MIN_BUCKET
    while p < n:
        p *= 2
    return p


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CascadeEvaluator:
    """Staged early-exit forest evaluator with on-device compaction.

    The stage loop runs on the host: surviving record indices gather the
    records into a dense tile on the device, the stage's vote kernel
    tallies (rows, C) vote counts, the votes are scattered back into the
    full (M, C) tally, and the exit test runs on the tally — all on the
    evaluator's device.  Each stage reads one number back: the survivor
    count.

    Args:
      forest: an ``EncodedForest`` (or anything with its surface).
      plan: explicit :class:`CascadePlan`; default = :func:`plan_cascade`
        over ``calibration`` (or stored tree order).
      n_classes: number of vote classes C.
      bound: exit bound; ``1.0`` exact (default), ``< 1`` relaxed,
        ``None`` disabled (full evaluation, classes equal to the majority
        vote).
      engine: "cuda" (the fused vote kernels K5/K6) or "torch" (the plain
        batched evaluators and a one-hot sum); default "cuda", or "torch"
        when the evaluator's device is the CPU.
      algorithm / jump_mode / block_m: forwarded to the stage kernels.
      stages / calibration: used only when ``plan`` is None.
      device: where the tables live and the cascade runs; default CUDA.
    """

    def __init__(
        self,
        forest,
        plan: CascadePlan | None = None,
        *,
        n_classes: int,
        bound: float | None = 1.0,
        engine: str | None = None,
        algorithm: str = "speculative",
        jump_mode: str = "gather",
        block_m: int | None = None,
        stages: int = 2,
        calibration=None,
        registry: obs.Registry | None = None,
        tracer: obs.Tracer | None = None,
        device=None,
    ):
        if bound is not None and float(bound) <= 0.0:
            raise ValueError(f"bound must be positive or None, got {bound}")
        self.device = _device.resolve(None, device)
        if engine is None:
            engine = "torch" if self.device.type == "cpu" else "cuda"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.forest = forest
        self.n_classes = int(n_classes)
        self._c = max(self.n_classes, 2)
        self.bound = None if bound is None else float(bound)
        self.engine = engine
        self.algorithm = algorithm
        self.jump_mode = jump_mode
        self.block_m = block_m
        if plan is None:
            plan = plan_cascade(
                forest,
                calibration,
                n_classes=self.n_classes,
                stages=stages,
                bound=self.bound,
                device=self.device,
            )
        if plan.n_trees != int(forest.n_trees):
            raise ValueError(
                f"plan covers {plan.n_trees} trees, forest has {forest.n_trees}"
            )
        self.plan = plan
        self._stages = [self._build_stage(s) for s in range(plan.n_stages)]
        # (stage, bucketed rows) → EMA of observed stage latency, for the
        # anytime deadline check.
        self._stage_ms: dict[tuple[int, int], float] = {}
        self.obs = registry if registry is not None else obs.Registry()
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        r = self.obs
        self.m_evals = r.counter("cascade.evals", "cascade evaluations")
        self.m_records = r.counter("cascade.records", "records evaluated")
        self.m_stage_ms = r.histogram(
            "cascade.stage_ms", "per-stage kernel latency", ("stage",))
        self.m_survival = r.histogram(
            "cascade.stage_survival",
            "fraction of the batch entering each stage", ("stage",),
            boundaries=obs.DEFAULT_RATIO_BOUNDARIES)
        self.m_exit_margin = r.histogram(
            "cascade.exit_margin", "final top-1 minus top-2 vote margins",
            boundaries=_MARGIN_BOUNDARIES)
        self.m_compact_ms = r.histogram(
            "cascade.compact_ms",
            "survivor compaction per stage (gather + scatter + exit test)",
            ("stage",))

    # -- stage construction -------------------------------------------------

    def _build_stage(self, s: int) -> Callable[[torch.Tensor], torch.Tensor]:
        """Stage ``s``'s vote engine: (rows, A) records → (rows, C) int32 votes."""
        sub = _StageForest(self.forest, self.plan.stage_trees(s))
        if self.engine == "cuda":
            # The packed tables depend on the record attribute count, which
            # EncodedForest does not store — pack on first call.
            packed_by_a: dict[int, _ops.PackedForest] = {}

            def run(rec: torch.Tensor) -> torch.Tensor:
                a = rec.shape[1]
                packed = packed_by_a.get(a)
                if packed is None:
                    packed = _ops.PackedForest(sub, a, max_depth=sub.max_depth, device=self.device)
                    packed_by_a[a] = packed
                return _ops.forest_votes_fused(
                    rec,
                    packed,
                    n_classes=self._c,
                    algorithm=self.algorithm,
                    jump_mode=self.jump_mode,
                    block_m=self.block_m,
                )

            return run

        tables = (
            _device.as_tensor(sub.attr_idx, torch.int32, self.device),
            _device.as_tensor(sub.threshold, torch.float32, self.device),
            _device.as_tensor(sub.child, torch.int32, self.device),
            _device.as_tensor(sub.class_val, torch.int32, self.device),
        )

        def run(rec: torch.Tensor) -> torch.Tensor:
            if self.algorithm == "speculative":
                per_tree = eval_speculative(
                    rec, *tables, max_depth=sub.max_depth,
                    use_onehot_matmul=(self.jump_mode == "onehot"),
                )
            else:
                per_tree = eval_data_parallel(rec, *tables, max_depth=sub.max_depth)
            return vote_counts(per_tree, self._c)

        return run

    def _stage_votes(self, s: int, rec: torch.Tensor) -> torch.Tensor:
        """Run stage ``s`` on a dense record tile; returns (rows, C) votes.

        Waits for the device, as the JAX package blocks on the stage's
        result, so the latency estimate covers the stage's kernel time.
        """
        n = rec.shape[0]
        rows = _pad_rows(n)
        t0 = time.perf_counter()
        with self.tracer.span("cascade.stage", cat="cascade", stage=s,
                              survivors=n, rows=rows):
            votes = self._stages[s](rec)
            with self.tracer.span("cascade.sync", cat="cascade", stage=s, phase="stage"):
                _synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        with self.tracer.span("cascade.observe", cat="cascade"):
            self.m_stage_ms.labels(stage=s).observe(ms)
        key = (s, rows)
        prev = self._stage_ms.get(key)
        self._stage_ms[key] = ms if prev is None else 0.7 * prev + 0.3 * ms
        return votes

    def _stage_estimate_ms(self, s: int, n: int) -> float:
        """Predicted latency of stage ``s`` over ``n`` records (0 = unknown)."""
        rows = _pad_rows(n)
        est = self._stage_ms.get((s, rows))
        if est is not None:
            return est
        # fall back to the nearest observed bucket for this stage
        seen = [(abs(r - rows), v) for (si, r), v in self._stage_ms.items() if si == s]
        return min(seen)[1] if seen else 0.0

    # -- evaluation ---------------------------------------------------------

    def __call__(self, records, *, deadline_ms: float | None = None) -> CascadeResult:
        rec = _device.as_tensor(records, torch.float32, self.device)
        if rec.dim() != 2:
            raise ValueError(f"records must be (M, A), got {tuple(rec.shape)}")
        dev = self.device
        m = rec.shape[0]
        t_total = self.plan.n_trees
        votes = torch.zeros((m, self._c), dtype=torch.int32, device=dev)
        trees_evaluated = torch.zeros((m,), dtype=torch.int32, device=dev)
        exit_stage = torch.full((m,), -1, dtype=torch.int32, device=dev)
        alive = torch.arange(m, device=dev)
        n_alive = m
        done = 0
        survivors: list[int] = []
        stages_run = 0
        self.m_evals.inc()
        self.m_records.inc(m)
        espan = self.tracer.span("cascade.eval", cat="cascade", records=m,
                                 deadline_ms=deadline_ms)
        t_start = time.perf_counter()

        with espan:
            for s, size in enumerate(self.plan.stage_sizes):
                if n_alive == 0:
                    break
                if deadline_ms is not None and s > 0:
                    elapsed = (time.perf_counter() - t_start) * 1e3
                    if elapsed + self._stage_estimate_ms(s, n_alive) > deadline_ms:
                        break
                survivors.append(n_alive)
                with self.tracer.span("cascade.observe", cat="cascade"):
                    self.m_survival.labels(stage=s).observe(n_alive / max(m, 1))
                c0 = time.perf_counter()
                with self.tracer.span("cascade.compact", cat="cascade", stage=s,
                                      phase="gather", survivors=n_alive):
                    stage_rec = rec if n_alive == m else rec.index_select(0, alive)
                compact_ms = (time.perf_counter() - c0) * 1e3
                stage_votes = self._stage_votes(s, stage_rec)
                c1 = time.perf_counter()
                with self.tracer.span("cascade.compact", cat="cascade", stage=s,
                                      phase="scatter", survivors=n_alive):
                    votes.index_add_(0, alive, stage_votes)
                    done += size
                    trees_evaluated.index_fill_(0, alive, done)
                    stages_run = s + 1
                    remaining = t_total - done
                    if self.bound is not None and remaining > 0:
                        top2 = votes.index_select(0, alive).topk(2, dim=1).values
                        # numpy compares the int margin with the float64
                        # product; a torch int tensor against a Python float
                        # would compare in float32.
                        margin = (top2[:, 0] - top2[:, 1]).double()
                        decided = margin > self.bound * remaining
                        exit_stage[alive] = torch.where(decided, s, exit_stage[alive])
                        with self.tracer.span("cascade.sync", cat="cascade", stage=s,
                                              phase="survivors"):
                            alive = alive[~decided]      # the stage's one host read
                        n_alive = alive.numel()
                compact_ms += (time.perf_counter() - c1) * 1e3
                with self.tracer.span("cascade.observe", cat="cascade"):
                    self.m_compact_ms.labels(stage=s).observe(compact_ms)
            espan.set(stages_run=stages_run)

        with self.tracer.span("cascade.finish", cat="cascade"):
            classes = vote_winner(votes)
            top2 = votes.topk(2, dim=1).values
            margin = (top2[:, 0] - top2[:, 1]).to(torch.int32)
            if self.obs.enabled:
                with self.tracer.span("cascade.observe", cat="cascade"):
                    self.m_exit_margin.observe_many(margin.cpu().numpy())
            remaining_all = t_total - trees_evaluated
            # float64 as numpy divides int32 arrays, then cast: bit-identical.
            ratio = margin.double() / remaining_all.clamp(min=1).double()
            conf = torch.where(remaining_all <= 0, 1.0, ratio.clamp(0.0, 1.0)).to(torch.float32)
        return CascadeResult(
            classes=classes,
            margin=margin,
            trees_evaluated=trees_evaluated,
            exit_stage=exit_stage,
            stages_run=stages_run,
            confidence=conf,
            stage_survivors=tuple(survivors),
        )


def eval_cascade(
    forest,
    records,
    *,
    n_classes: int,
    stages: int = 2,
    bound: float | None = 1.0,
    plan: CascadePlan | None = None,
    calibration=None,
    engine: str | None = None,
    algorithm: str = "speculative",
    jump_mode: str = "gather",
    block_m: int | None = None,
    deadline_ms: float | None = None,
    registry: obs.Registry | None = None,
    tracer: obs.Tracer | None = None,
    device=None,
) -> CascadeResult:
    """One-shot cascade evaluation (builds a :class:`CascadeEvaluator`).

    For repeated batches build the evaluator once — it caches per-stage
    packed tables and latency estimates.  ``device`` defaults to where
    ``records`` lies, else CUDA.
    """
    ev = CascadeEvaluator(
        forest,
        plan,
        n_classes=n_classes,
        bound=bound,
        engine=engine,
        algorithm=algorithm,
        jump_mode=jump_mode,
        block_m=block_m,
        stages=stages,
        calibration=calibration if calibration is not None else records,
        registry=registry,
        tracer=tracer,
        device=_device.resolve(records, device),
    )
    return ev(records, deadline_ms=deadline_ms)


# ---------------------------------------------------------------------------
# Cascade variant registry
# ---------------------------------------------------------------------------
#
# A cascade variant *builds* a CascadeEvaluator rather than evaluating a
# batch directly: the evaluator is stateful (packed stage tables, latency
# EMAs), so a dispatch layer constructs it once per resolved bucket and
# replays it per batch.  Contract:
#
#     spec.build(forest, *, n_classes, plan=None, stages, bound, block_m,
#                calibration=None, device=None) -> CascadeEvaluator
#
# Family "fused" (engine "cuda") stages through the vote kernels K5/K6;
# family "batched" (engine "torch") through the plain batched evaluators
# (the JAX package's "vmap" family).


@dataclasses.dataclass(frozen=True)
class CascadeVariantSpec:
    """One cascade evaluator configuration plus its tunable knobs.

    ``family`` is always :data:`CASCADE_FAMILY`; ``tunables`` always
    includes ``"stages"`` (the stage-count grid) and, for the cuda engine,
    ``"block_m"``.
    """

    name: str
    family: str
    algorithm: str
    engine: str
    jump_mode: str
    tunables: tuple[str, ...]
    build: Callable


CASCADE_VARIANTS: dict[str, CascadeVariantSpec] = {}


def register_cascade_variant(spec: CascadeVariantSpec) -> CascadeVariantSpec:
    if spec.name in CASCADE_VARIANTS:
        raise ValueError(f"cascade variant {spec.name!r} already registered")
    CASCADE_VARIANTS[spec.name] = spec
    return spec


def get_cascade_variant(name: str) -> CascadeVariantSpec:
    try:
        return CASCADE_VARIANTS[name]
    except KeyError:
        raise KeyError(
            f"unknown cascade variant {name!r}; registered: {sorted(CASCADE_VARIANTS)}"
        ) from None


def list_cascade_variants(*, engine: str | None = None) -> list[CascadeVariantSpec]:
    out = [
        s for s in CASCADE_VARIANTS.values() if engine is None or s.engine == engine
    ]
    return sorted(out, key=lambda s: s.name)


def _builder(engine: str, algorithm: str, jump_mode: str) -> Callable:
    def build(
        forest,
        *,
        n_classes: int,
        plan: CascadePlan | None = None,
        stages: int = 2,
        bound: float | None = 1.0,
        block_m: int | None = None,
        calibration=None,
        registry: obs.Registry | None = None,
        tracer: obs.Tracer | None = None,
        device=None,
    ) -> CascadeEvaluator:
        return CascadeEvaluator(
            forest,
            plan,
            n_classes=n_classes,
            bound=bound,
            engine=engine,
            algorithm=algorithm,
            jump_mode=jump_mode,
            block_m=block_m,
            stages=stages,
            calibration=calibration,
            registry=registry,
            tracer=tracer,
            device=device,
        )

    return build


for _alg, _jm in (("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")):
    _suffix = f"_{_jm}" if _alg == "speculative" else ""
    register_cascade_variant(
        CascadeVariantSpec(
            name=f"forest_cascade_fused_{_alg}" + _suffix,
            family=CASCADE_FAMILY,
            algorithm=_alg,
            engine="cuda",
            jump_mode=_jm,
            tunables=("stages", "block_m"),
            build=_builder("cuda", _alg, _jm),
        )
    )
    register_cascade_variant(
        CascadeVariantSpec(
            name=f"forest_cascade_batched_{_alg}" + _suffix,
            family=CASCADE_FAMILY,
            algorithm=_alg,
            engine="torch",
            jump_mode=_jm,
            tunables=("stages",),
            build=_builder("torch", _alg, _jm),
        )
    )
