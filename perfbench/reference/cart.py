"""CART training (Gini impurity, continuous attributes), bagging, and
Procedure 1's breadth-first branchless encoding, in NumPy.

The trainer searches every attribute's sorted values for the split that
minimises weighted Gini impurity (at most ``max_thresholds_per_attr``
candidate positions an attribute, evenly spaced), puts values ``<= t`` left
and ``> t`` right, and stops at purity, ``max_depth``, ``min_samples_split``
records or a gain of at most ``min_gain``.  With ``max_leaves`` it grows
best first: of the leaves that may split, the one whose split removes the
most impurity (gain times records) splits next, until the tree has
``max_leaves`` leaves.  A leaf takes the majority class, ties to the lowest.

The encoding stores a tree breadth-first: node ``i`` has ``attr``,
``threshold``, ``child`` (its left child; the right is ``child + 1``) and
``cls`` (``-1`` for an internal node).  A leaf has threshold ``+inf`` and is
its own child, so descent stays on it.  Trees of a forest are padded to one
node count with unreachable self-looping leaves of class 0.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np

BOTTOM = -1


@dataclasses.dataclass(frozen=True)
class CartSettings:
    max_depth: int = 16
    min_samples_split: int = 2
    min_gain: float = 1e-7
    max_thresholds_per_attr: int = 64
    max_leaves: int | None = None


@dataclasses.dataclass
class Node:
    attr: int = 0
    threshold: float = 0.0
    left: "Node | None" = None
    right: "Node | None" = None
    cls: int = BOTTOM

    @property
    def is_leaf(self) -> bool:
        return self.left is None


def _gini(counts: np.ndarray) -> float:
    tot = counts.sum()
    if tot == 0:
        return 0.0
    p = counts / tot
    return float(1.0 - (p * p).sum())


def _best_split(x, y, n_classes: int, s: CartSettings):
    m, n_attrs = x.shape
    parent_counts = np.bincount(y, minlength=n_classes)
    parent_gini = _gini(parent_counts)
    best = None
    for a in range(n_attrs):
        order = np.argsort(x[:, a], kind="stable")
        xs, ys = x[order, a], y[order]
        diff = np.nonzero(xs[1:] > xs[:-1])[0]
        if diff.size == 0:
            continue
        if diff.size > s.max_thresholds_per_attr:
            diff = diff[np.linspace(0, diff.size - 1, s.max_thresholds_per_attr).astype(int)]
        onehot = np.zeros((m, n_classes), np.int64)
        onehot[np.arange(m), ys] = 1
        prefix = onehot.cumsum(axis=0)
        for pos in diff:
            left = prefix[pos]
            right = parent_counts - left
            nl, nr = pos + 1, m - pos - 1
            gain = parent_gini - (nl * _gini(left) + nr * _gini(right)) / m
            if best is None or gain > best[0]:
                best = (gain, a, float(xs[pos]))
    return best


def train_cart(x, y, n_classes: int, s: CartSettings) -> Node:
    """The root of a binary CART tree over ``x`` (M, A) and labels ``y``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.int64)

    def majority(ys) -> int:
        return int(np.bincount(ys, minlength=n_classes).argmax())

    def split_of(idx, depth: int):
        """(gain, attr, threshold, right mask) of the node over ``idx``, or None."""
        ys = y[idx]
        if depth >= s.max_depth or idx.size < s.min_samples_split or np.all(ys == ys[0]):
            return None
        found = _best_split(x[idx], ys, n_classes, s)
        if found is None or found[0] <= s.min_gain:
            return None
        gain, a, thr = found
        right = x[idx, a] > thr
        if right.all() or not right.any():
            return None
        return gain, a, thr, right

    def build(idx, depth: int) -> Node:
        found = split_of(idx, depth)
        if found is None:
            return Node(cls=majority(y[idx]))
        _, a, thr, right = found
        return Node(attr=a, threshold=thr, left=build(idx[~right], depth + 1),
                    right=build(idx[right], depth + 1))

    def grow_best_first(idx) -> Node:
        root = Node(cls=majority(y[idx]))
        heap, order, leaves = [], 0, 1

        def push(node, idx, depth):
            nonlocal order
            found = split_of(idx, depth)
            if found is not None:
                heapq.heappush(heap, (-found[0] * idx.size, order, node, idx, depth, found))
                order += 1

        push(root, idx, 0)
        while heap and leaves < s.max_leaves:
            _, _, node, idx, depth, (_, a, thr, right) = heapq.heappop(heap)
            node.attr, node.threshold, node.cls = a, thr, BOTTOM
            node.left = Node(cls=majority(y[idx[~right]]))
            node.right = Node(cls=majority(y[idx[right]]))
            leaves += 1
            push(node.left, idx[~right], depth + 1)
            push(node.right, idx[right], depth + 1)
        return root

    every = np.arange(x.shape[0])
    root = build(every, 0) if s.max_leaves is None else grow_best_first(every)
    if root.is_leaf:
        root = Node(attr=0, threshold=np.inf, left=Node(cls=root.cls), right=Node(cls=root.cls))
    return root


def encode(root: Node) -> tuple[np.ndarray, ...]:
    """Procedure 1: (attr int32, threshold float32, child int32, cls int32), each (N,)."""
    order, q = [], deque([root])
    while q:
        n = q.popleft()
        order.append(n)
        if not n.is_leaf:
            q.extend((n.left, n.right))
    n_nodes = len(order)
    attr = np.zeros(n_nodes, np.int32)
    thr = np.zeros(n_nodes, np.float32)
    child = np.zeros(n_nodes, np.int32)
    cls = np.full(n_nodes, BOTTOM, np.int32)
    next_child = 1
    for i, n in enumerate(order):
        attr[i] = n.attr
        if n.is_leaf:
            thr[i], child[i], cls[i] = np.inf, i, n.cls
        else:
            thr[i], child[i] = n.threshold, next_child
            next_child += 2
    return attr, thr, child, cls


def stack(trees: list[tuple[np.ndarray, ...]]) -> tuple[np.ndarray, ...]:
    """Pad encoded trees to one node count and stack them: four (T, N) tables."""
    n_pad = max(t[0].shape[0] for t in trees)
    out = ([], [], [], [])
    for attr, thr, child, cls in trees:
        n = attr.shape[0]
        pad = np.arange(n, n_pad, dtype=np.int32)
        out[0].append(np.concatenate([attr, np.zeros(n_pad - n, np.int32)]))
        out[1].append(np.concatenate([thr, np.full(n_pad - n, np.inf, np.float32)]))
        out[2].append(np.concatenate([child, pad]))
        out[3].append(np.concatenate([cls, np.zeros(n_pad - n, np.int32)]))
    return tuple(np.stack(t) for t in out)


def train_trees(x, y, n_classes: int, s: CartSettings, *, n_trees: int = 1,
                bootstrap: bool = False, rng_seed: int = 0) -> tuple[np.ndarray, ...]:
    """One tree on all of ``x``, or ``n_trees`` bagged trees, each on a bootstrap
    sample drawn with ``default_rng(rng_seed)``.  Returns four (T, N) tables."""
    if not bootstrap:
        return stack([encode(train_cart(x, y, n_classes, s)) for _ in range(n_trees)])
    rng = np.random.default_rng(rng_seed)
    trees = []
    for _ in range(n_trees):
        idx = rng.integers(0, x.shape[0], x.shape[0])
        trees.append(encode(train_cart(x[idx], y[idx], n_classes, s)))
    return stack(trees)
