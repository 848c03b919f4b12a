"""Profiling evaluation path: the branchless descent with its eyes open.

Every evaluator answers *what class*; this module answers the §3.6
questions the autotuner's cost model runs on — *how deep* did live traffic
traverse (d_µ), *how divergent* was each round (the active-lane fraction the
paper's SIMD analysis charges idle processors for), and *where* did records
land (per-node / per-leaf hit counts, the input to the drift detector in
:mod:`repro_torch.obs.prof`).

The descent mirrors :func:`repro_torch.kernels.tree_eval.ref.forest_eval_ref`
step for step — ``idx = child[idx] + (r_a > t)`` for ``max_depth`` rounds,
leaves self-looping — with reductions on the records' device:

* ``exit_depth[r]``  — rounds record ``r`` spent at internal nodes before
  reaching its leaf (its traversal depth; mean = measured d_µ);
* ``level_active[l]`` — fraction of records still at an internal node
  entering round ``l`` (the paper's per-level lane occupancy);
* ``node_hits[i]``   — internal-node evaluations at node ``i``;
* ``leaf_hits[i]``   — records terminating at leaf ``i`` (the histogram the
  drift detector compares).

The index arithmetic is that of the reference loop, so ``classes`` is
bit-exact with the unprofiled evaluators.  Plain torch ops (gathers and
``index_add_``), not a kernel: the shadow pass is sampled and off the request
path, as the JAX package's plain-jnp profile is.  It reads the device back
once, for the per-round fractions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.tree import BOTTOM, tree_depth

__all__ = ["ForestProfile", "TreeProfile", "profile_forest_eval", "profile_tree_eval"]


def _mean_f32(totals, n: int) -> np.ndarray:
    """Means of integer sums over ``n`` items in float32, as XLA computes
    ``jnp.mean`` of an f32 cast: the sum (exact below 2**24) times the float32
    reciprocal of the count — not always the correctly rounded quotient
    (97/97 gives 0.99999994).  In numpy on the host, so that every device
    rounds alike and the JAX package's fractions are matched bit for bit."""
    return np.asarray(totals, np.float32) * (np.float32(1) / np.float32(max(n, 1)))


class TreeProfile(NamedTuple):
    """One profiled descent over a record batch (tensors on its device).

    ``classes`` is bit-exact with ``tree_eval_ref`` on the same inputs; the
    rest are the measurements.  ``level_active[l]`` is the fraction of
    records still at an internal node *entering* round ``l`` — equivalently
    ``mean(exit_depth > l)``.
    """

    classes: torch.Tensor       # (M,) int32
    exit_depth: torch.Tensor    # (M,) int32 — traversal depth per record
    level_active: torch.Tensor  # (max_depth,) float32 — active-lane fraction
    node_hits: torch.Tensor     # (N,) int32 — internal evaluations per node
    leaf_hits: torch.Tensor     # (N,) int32 — terminal records per leaf

    def d_mu(self) -> float:
        """Measured mean traversal depth (the §3.6 d_µ), in float32 as the
        JAX package's ``TreeProfile.d_mu``."""
        return float(_mean_f32(int(self.exit_depth.sum(dtype=torch.int64)), self.exit_depth.numel()))


class ForestProfile(NamedTuple):
    """Per-tree profiles of one forest descent (leading tree axis T)."""

    classes: torch.Tensor       # (T, M) int32 — bit-exact with forest_eval_ref
    exit_depth: torch.Tensor    # (T, M) int32
    level_active: torch.Tensor  # (T, max_depth) float32
    node_hits: torch.Tensor     # (T, N) int32
    leaf_hits: torch.Tensor     # (T, N) int32

    def d_mu(self) -> float:
        """Forest d_µ: mean traversal depth over all trees × records (float32)."""
        return float(_mean_f32(int(self.exit_depth.sum(dtype=torch.int64)), self.exit_depth.numel()))

    def leaf_histogram(self) -> np.ndarray:
        """Leaf-hit counts summed over trees, (N,) — the drift signal."""
        return self.leaf_hits.sum(0, dtype=torch.int32).cpu().numpy()

    def mean_level_active(self) -> np.ndarray:
        """Active-lane fraction per round averaged over trees, (max_depth,)."""
        return self.level_active.mean(0).cpu().numpy()


def _profiled_descent(records, attr_idx, threshold, child, class_val, max_depth: int):
    """The reference loop over (T, N) tables with reductions; (T, ·) outputs."""
    t, n = attr_idx.shape
    m = records.shape[0]
    dev = records.device
    rows = torch.arange(m, device=dev)
    offset = (torch.arange(t, device=dev) * n)[:, None]
    idx = torch.zeros((t, m), dtype=torch.int64, device=dev)
    exit_depth = torch.zeros((t, m), dtype=torch.int32, device=dev)
    node_hits = torch.zeros((t * n,), dtype=torch.int64, device=dev)
    active = []
    # scatter-adds over every (tree, record) slot, not masks or bincount:
    # those read a size back to the host each round
    for _ in range(max_depth):
        internal = (class_val.gather(1, idx) == BOTTOM).int()   # still descending this round
        active.append(internal.sum(1, dtype=torch.int64))
        node_hits.index_add_(0, (idx + offset).reshape(-1), internal.reshape(-1).long())
        v = records[rows, attr_idx.gather(1, idx)]
        idx = child.gather(1, idx) + (v > threshold.gather(1, idx))
        exit_depth += internal
    classes = class_val.gather(1, idx)
    leaf_hits = torch.zeros((t * n,), dtype=torch.int64, device=dev).index_add_(
        0, (idx + offset).reshape(-1), torch.ones((t * m,), dtype=torch.int64, device=dev))
    counts = torch.stack(active, 1).cpu().numpy() if active else np.zeros((t, 0), np.int64)
    level_active = torch.from_numpy(_mean_f32(counts, m)).to(dev)
    return (classes, exit_depth, level_active,
            node_hits.view(t, n).to(torch.int32), leaf_hits.view(t, n).to(torch.int32))


def _tables(tables, dev):
    attr_idx, threshold, child, class_val = tables
    return (_device.as_tensor(attr_idx, torch.int64, dev), _device.as_tensor(threshold, torch.float32, dev),
            _device.as_tensor(child, torch.int64, dev), _device.as_tensor(class_val, torch.int32, dev))


def profile_tree_eval(records, enc, *, max_depth: int | None = None, device=None) -> TreeProfile:
    """Profile one tree's descent over a record batch.

    Args:
      records: (M, A) float array or tensor (compared in f32, like every
        evaluator).
      enc: an :class:`repro_torch.core.tree.EncodedTree`.
      max_depth: descent rounds; default the tree's depth (leaves self-loop,
        so extra rounds change nothing but cost time).
      device: where to run; default where ``records`` lies, else CUDA.

    Returns:
      A :class:`TreeProfile` on that device; ``classes`` is bit-exact with
      :func:`repro_torch.kernels.tree_eval.ref.tree_eval_ref`.
    """
    dev = _device.resolve(records, device)
    rec = _device.as_tensor(records, torch.float32, dev)
    if max_depth is None:
        max_depth = max(tree_depth(enc), 1)
    tables = _tables((np.asarray(enc.attr_idx)[None], np.asarray(enc.threshold)[None],
                      np.asarray(enc.child)[None], np.asarray(enc.class_val)[None]), dev)
    return TreeProfile(*(x[0] for x in _profiled_descent(rec, *tables, int(max_depth))))


def profile_forest_eval(records, forest, *, max_depth: int | None = None, device=None) -> ForestProfile:
    """Profile every tree of an :class:`~repro_torch.core.forest.EncodedForest`.

    Same contract as :func:`profile_tree_eval` over the stacked (T, N) tree
    tables; ``classes`` is bit-exact with
    :func:`repro_torch.kernels.tree_eval.ref.forest_eval_ref` (and therefore
    with every tuned forest family).
    """
    dev = _device.resolve(records, device)
    rec = _device.as_tensor(records, torch.float32, dev)
    if max_depth is None:
        max_depth = max(int(forest.max_depth), 1)
    tables = _tables((forest.attr_idx, forest.threshold, forest.child, forest.class_val), dev)
    return ForestProfile(*_profiled_descent(rec, *tables, int(max_depth)))
