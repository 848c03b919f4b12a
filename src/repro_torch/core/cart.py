"""CART classification-tree training (Gini impurity, continuous attributes).

The paper trains its classifier offline with the Orange library and focuses on
evaluation.  Per the build-every-substrate rule we implement the trainer
ourselves: a standard CART — exhaustive axis-aligned threshold search
minimising weighted Gini impurity, recursive splitting until purity,
``max_depth`` or ``min_samples_split``.  Produces full binary trees with
continuous attributes, exactly the tree class the paper's evaluator assumes
(§2.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.tree import Node


@dataclasses.dataclass(frozen=True)
class CartConfig:
    max_depth: int = 16
    min_samples_split: int = 2
    min_gain: float = 1e-7
    max_thresholds_per_attr: int = 64  # subsample candidate thresholds when large


def _gini(counts: np.ndarray) -> float:
    tot = counts.sum()
    if tot == 0:
        return 0.0
    p = counts / tot
    return float(1.0 - (p * p).sum())


def _best_split(x: np.ndarray, y: np.ndarray, n_classes: int, cfg: CartConfig):
    """Exhaustive (attr, threshold) search minimising weighted Gini.

    Uses the classic sorted-prefix-count sweep: O(A · M log M).
    Returns (gain, attr, threshold) or None.
    """
    m, n_attrs = x.shape
    parent_counts = np.bincount(y, minlength=n_classes)
    parent_gini = _gini(parent_counts)
    best = None
    for a in range(n_attrs):
        order = np.argsort(x[:, a], kind="stable")
        xs = x[order, a]
        ys = y[order]
        # candidate split positions: where consecutive sorted values differ
        diff = np.nonzero(xs[1:] > xs[:-1])[0]
        if diff.size == 0:
            continue
        if diff.size > cfg.max_thresholds_per_attr:
            sel = np.linspace(0, diff.size - 1, cfg.max_thresholds_per_attr).astype(int)
            diff = diff[sel]
        # prefix class counts
        onehot = np.zeros((m, n_classes), np.int64)
        onehot[np.arange(m), ys] = 1
        prefix = onehot.cumsum(axis=0)  # prefix[i] = counts of ys[:i+1]
        for pos in diff:
            left = prefix[pos]
            right = parent_counts - left
            nl, nr = pos + 1, m - pos - 1
            g = (nl * _gini(left) + nr * _gini(right)) / m
            gain = parent_gini - g
            if best is None or gain > best[0]:
                # paper predicate is r > t  →  right; so threshold is the
                # left-group max: values ≤ t go left.
                thr = float(xs[pos])
                best = (gain, a, thr)
    return best


def _majority(y: np.ndarray, n_classes: int) -> int:
    return int(np.bincount(y, minlength=n_classes).argmax())


def train_cart(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int | None = None,
    cfg: CartConfig = CartConfig(),
) -> Node:
    """Train a CART classification tree.

    Args:
      x: (M, A) float features.
      y: (M,) int class labels in [0, n_classes).

    Returns:
      root :class:`Node` of a full binary tree.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.int64)
    if n_classes is None:
        n_classes = int(y.max()) + 1

    def build(idx: np.ndarray, depth: int) -> Node:
        ys = y[idx]
        if (
            depth >= cfg.max_depth
            or idx.size < cfg.min_samples_split
            or np.all(ys == ys[0])
        ):
            return Node(class_val=_majority(ys, n_classes))
        found = _best_split(x[idx], ys, n_classes, cfg)
        if found is None or found[0] <= cfg.min_gain:
            return Node(class_val=_majority(ys, n_classes))
        _, a, thr = found
        mask = x[idx, a] > thr
        right_idx = idx[mask]
        left_idx = idx[~mask]
        if left_idx.size == 0 or right_idx.size == 0:
            return Node(class_val=_majority(ys, n_classes))
        return Node(
            attr=a,
            threshold=thr,
            left=build(left_idx, depth + 1),
            right=build(right_idx, depth + 1),
        )

    root = build(np.arange(x.shape[0]), 0)
    if root.is_leaf:
        # degenerate dataset: wrap in a trivial split so downstream code
        # always sees ≥1 internal node (a full binary tree).
        root = Node(attr=0, threshold=np.float64(np.inf), left=Node(class_val=root.class_val),
                    right=Node(class_val=root.class_val))
    return root


def accuracy(pred: np.ndarray, y: np.ndarray) -> float:
    return float((np.asarray(pred) == np.asarray(y)).mean())
