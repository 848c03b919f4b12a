"""repro_torch.dist — sharded forest evaluation across a device grid.

The paper's §3 contest (data vs speculative decomposition, one SIMD engine)
gains a dimension at fleet scale: how to split M records and T trees across
D devices *before* choosing the kernel within each device.  This package is
that layer:

  plan.py      decomposition planner — extends the §3.6 CostModel
               (t_e, t_c, t_i, σ, γ) to a device mesh and ranks the
               record-sharded (R=D), tree-sharded (G=D) and hybrid (R×G)
               factorizations by predicted time (the JAX package's planner,
               line for line).
  executor.py  lowers the chosen ShardPlan over a (records × trees) grid of
               the node's cards from one controlling process, resolving the
               per-shard kernel through ``repro_torch.tune`` so the
               autotuner remains the single selection point.  Exact:
               bit-identical to ``eval_forest_tuned`` for every plan;
               degrades to the plain tuned path on one device.
  stream.py    streaming chunker — double-buffers host→device transfer
               through pinned memory on a copy stream against evaluation
               (hides the paper's σ·M transmission term) and reports
               per-chunk latency, serve-engine style.

Entry points: ``repro_torch.core.forest.eval_forest_sharded`` (functional)
and ``repro_torch.serve.ForestServeEngine`` (wave-batched serving).
"""

from repro_torch.dist.executor import DistStats, ShardedForestEvaluator
from repro_torch.dist.plan import (
    ForestWorkload,
    MeshCostModel,
    ShardPlan,
    calibrate_mesh_cost,
    enumerate_plans,
    make_plan,
    plan_forest,
    predicted_plan_time,
    shard_extents,
)
from repro_torch.dist.stream import StreamingChunker, StreamStats, stream_eval_forest

__all__ = [
    "DistStats",
    "ForestWorkload",
    "MeshCostModel",
    "ShardPlan",
    "ShardedForestEvaluator",
    "StreamStats",
    "StreamingChunker",
    "calibrate_mesh_cost",
    "enumerate_plans",
    "make_plan",
    "plan_forest",
    "predicted_plan_time",
    "shard_extents",
    "stream_eval_forest",
]
