"""repro_torch.tune — autotuning & variant dispatch for the tree-eval kernels.

The paper's result is an *operating-point* result: speculative evaluation
(Procedure 5) beats data decomposition (Procedure 3) only where its runtime
model says it should.  §4's analysis writes both runtimes over the workload
shape — record count M, tree nodes N, mean traversal depth d_µ — and
equation (1) gives the crossover ``p < 2·d_µ/(1 + log₂ d_µ)``.  This package
operationalises that analysis: callers say ``tuned_eval(records, tree)`` and
the subsystem picks the variant that wins *at this shape on this device*.
The port's own copy of the JAX package's ``repro.tune``, with the same
public names; on the card its default space holds only the hand-written
CUDA kernels.

Tuning happens at two granularities:

  * **tree** — :class:`TunedEvaluator` / :func:`tuned_eval` pick one kernel
    variant per (device, shape-bucket);
  * **forest** — :class:`ForestTunedEvaluator` / :func:`tuned_eval_forest`
    pick a *family* per (device, forest-bucket): per-tree variant vectors,
    a shared-variant batched path, or the fused kernel that evaluates the
    whole forest in one launch; and, through ``predict``, the majority vote
    against the early-exit cascades.

Module map (→ paper concept):

  space.py      the workload shape (M, N, A, d) the §4 model is written
                over, plus the forest shape (T, M, N_max, A, depth profile);
                shape bucketing; enumeration of valid (variant, parameter)
                candidates from the kernel registries.
  measure.py    the paper's measurement discipline (warmup, timing to
                completion, medians over repeats) applied to each candidate.
  cache.py      persistent JSON store of per-(device, shape-bucket) winners
                with an in-process LRU front.
  heuristic.py  the §4 closed forms (T₃ vs T₅, equation (1) crossover) as
                the no-cache fallback policy, lifted to the family choice
                for forests (launch savings vs depth-padding waste).
  dispatch.py   ``tuned_eval`` / ``TunedEvaluator`` and
                ``tuned_eval_forest`` / ``ForestTunedEvaluator``: memo →
                cache → optional autotune → heuristic, with bucket-padded
                batches and atomic ``promote``/``invalidate`` re-tune hooks.

Every variant is exact, so tuning is purely a performance decision: results
are bit-identical to the serial branchless reference (Procedure 2).
"""

from repro_torch.tune.cache import TuneCache, TuneEntry, default_cache_path, registry_fingerprint
from repro_torch.tune.dispatch import (
    ForestTunedEvaluator,
    TunedEvaluator,
    tuned_eval,
    tuned_eval_forest,
)
from repro_torch.tune.heuristic import (
    cascade_heuristic_candidate,
    default_survival,
    forest_heuristic_candidate,
    heuristic_candidate,
    measured_d_mu,
    measured_forest_d_mu,
    measured_survival_rate,
    predicted_times,
)
from repro_torch.tune.measure import (
    Measurement,
    measure_candidate,
    measure_cascade_candidate,
    measure_forest_candidate,
    time_callable,
    tune_cascade_workload,
    tune_forest_workload,
    tune_workload,
)
from repro_torch.tune.space import (
    Candidate,
    ForestShape,
    WorkloadShape,
    backend_tag,
    cascade_search_space,
    cascade_stage_grid,
    forest_search_space,
    search_space,
)

__all__ = [
    "Candidate",
    "ForestShape",
    "ForestTunedEvaluator",
    "Measurement",
    "TuneCache",
    "TuneEntry",
    "TunedEvaluator",
    "WorkloadShape",
    "backend_tag",
    "cascade_heuristic_candidate",
    "cascade_search_space",
    "cascade_stage_grid",
    "default_cache_path",
    "default_survival",
    "forest_heuristic_candidate",
    "forest_search_space",
    "heuristic_candidate",
    "measure_candidate",
    "measure_cascade_candidate",
    "measure_forest_candidate",
    "measured_d_mu",
    "measured_forest_d_mu",
    "measured_survival_rate",
    "predicted_times",
    "registry_fingerprint",
    "search_space",
    "time_callable",
    "tune_cascade_workload",
    "tune_forest_workload",
    "tune_workload",
    "tuned_eval",
    "tuned_eval_forest",
]
