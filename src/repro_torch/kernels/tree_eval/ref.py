"""Plain-torch oracle for the tree-evaluation kernels.

The reference semantics for every kernel variant: branchless descent of the
breadth-first encoded tree, ``max_depth`` rounds (leaves self-loop, so extra
rounds are no-ops).  Written with the simplest torch ops — no kernel, no
tiling — and used by tests and by ``chip_smoke.py`` as ground truth.  The
forest form carries the tree axis as a batch dimension where the JAX
package's ``ref.py`` uses ``vmap``.  The cascade oracle replays the staged
vote in host numpy, vectorised over records where the JAX package's loops
over them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device


def forest_eval_ref(
    records,    # (M, A) float
    attr_idx,   # (T, N) int32
    threshold,  # (T, N) float32
    child,      # (T, N) int32
    class_val,  # (T, N) int32
    *,
    max_depth: int,
    device=None,
) -> torch.Tensor:
    """Per-tree ground truth, shape (T, M) int32."""
    dev = _device.resolve(records, device)
    records = _device.as_tensor(records, torch.float32, dev)
    attr_idx, child = (_device.as_tensor(x, torch.int64, dev) for x in (attr_idx, child))
    threshold = _device.as_tensor(threshold, torch.float32, dev)
    class_val = _device.as_tensor(class_val, torch.int32, dev)
    m = records.shape[0]
    rows = torch.arange(m, device=dev)
    idx = torch.zeros((attr_idx.shape[0], m), dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        v = records[rows, attr_idx.gather(1, idx)]        # (T, M)
        idx = child.gather(1, idx) + (v > threshold.gather(1, idx))
    return class_val.gather(1, idx)


def tree_eval_ref(
    records,    # (M, A) float
    attr_idx,   # (N,) int32
    threshold,  # (N,) float32
    child,      # (N,) int32
    class_val,  # (N,) int32
    *,
    max_depth: int,
    device=None,
) -> torch.Tensor:
    """Ground-truth class assignment, shape (M,) int32."""
    tables = [torch.as_tensor(x)[None] for x in (attr_idx, threshold, child, class_val)]
    return forest_eval_ref(records, *tables, max_depth=max_depth, device=device)[0]


class CascadeRef(NamedTuple):
    """The cascade oracle's per-record outcome (numpy, on the host).

    The first three fields are those the JAX package's ``cascade_eval_ref``
    returns, in its order; ``margin`` and ``confidence`` follow the
    evaluator's definitions.
    """

    classes: np.ndarray          # (M,) int32
    exit_stage: np.ndarray       # (M,) int32, -1 = ran every stage
    trees_evaluated: np.ndarray  # (M,) int32
    margin: np.ndarray           # (M,) int32, top-1 minus top-2 votes
    confidence: np.ndarray       # (M,) float32


def cascade_ref_from_classes(
    per_tree,   # (T, M) int per-tree classes
    *,
    order,
    stage_sizes,
    n_classes: int,
    bound: float | None,
) -> CascadeRef:
    """Replay the staged early-exit vote over per-tree classes.

    Accumulate votes stage by stage (trees in ``order``) and let a record
    stop once ``top1 - top2 > bound * remaining``, compared in float64 as
    numpy compares an integer array with a Python float.  Classes outside
    ``[0, max(n_classes, 2))`` cast no vote; ties go to the lowest class.
    """
    per_tree = np.asarray(per_tree)
    t_total, m = per_tree.shape
    c = max(int(n_classes), 2)
    rows = np.arange(m)
    votes = np.zeros((m, c), np.int64)
    exit_stage = np.full((m,), -1, np.int32)
    trees_evaluated = np.zeros((m,), np.int32)
    alive = np.ones((m,), bool)
    done = 0
    for s, size in enumerate(stage_sizes):
        for j in order[done : done + size]:
            cls = per_tree[j]
            votes_cast = alive & (cls >= 0) & (cls < c)
            votes[rows[votes_cast], cls[votes_cast]] += 1
        done += size
        trees_evaluated[alive] = done
        remaining = t_total - done
        if bound is not None and remaining > 0:
            top2 = np.sort(votes, axis=1)[:, -2:]
            decided = alive & (top2[:, 1] - top2[:, 0] > float(bound) * remaining)
            exit_stage[decided] = s
            alive &= ~decided
    top2 = np.sort(votes, axis=1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]).astype(np.int32)
    remaining_all = t_total - trees_evaluated
    confidence = np.where(
        remaining_all <= 0, 1.0, np.clip(margin / np.maximum(remaining_all, 1), 0.0, 1.0)
    ).astype(np.float32)
    return CascadeRef(
        classes=votes.argmax(axis=1).astype(np.int32),
        exit_stage=exit_stage,
        trees_evaluated=trees_evaluated,
        margin=margin,
        confidence=confidence,
    )


def cascade_eval_ref(
    records,
    attr_idx,
    threshold,
    child,
    class_val,
    *,
    max_depth: int,
    order,
    stage_sizes,
    n_classes: int,
    bound: float | None,
    device=None,
) -> CascadeRef:
    """Serial oracle for the staged early-exit cascade (without deadlines).

    Evaluates every tree up front with :func:`forest_eval_ref`, then replays
    the stage loop with :func:`cascade_ref_from_classes`.
    """
    per_tree = forest_eval_ref(
        records, attr_idx, threshold, child, class_val, max_depth=max_depth, device=device
    )
    return cascade_ref_from_classes(
        per_tree.cpu().numpy(), order=order, stage_sizes=stage_sizes,
        n_classes=n_classes, bound=bound,
    )
