"""Serial descent, the majority vote and bfloat16 rounding, in NumPy.

Descent follows Procedure 2: at an internal node ``i`` the record moves to
``child[i] + (r[attr[i]] > threshold[i])``.  A NaN attribute compares false
and goes left; a leaf's ``+inf`` threshold keeps the record on it.  The depth
of a record is the number of internal nodes it passed, one compare each.
"""

from __future__ import annotations

import numpy as np


def descend(tables, records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Classes and depths of every record under every tree.

    ``tables`` are the four (T, N) arrays (attr, threshold, child, cls);
    ``records`` is (M, A).  Returns int32 (T, M) classes and int32 (T, M)
    depths.
    """
    attr, thr, child, cls = tables
    records = np.asarray(records)
    t_count, m = attr.shape[0], records.shape[0]
    rows = np.arange(m)
    classes = np.empty((t_count, m), np.int32)
    depths = np.zeros((t_count, m), np.int32)
    for t in range(t_count):
        idx = np.zeros(m, np.int64)
        while True:
            inner = cls[t, idx] < 0
            if not inner.any():
                break
            go_right = records[rows, attr[t, idx]] > thr[t, idx]
            idx = np.where(inner, child[t, idx] + go_right, idx)
            depths[t] += inner
        classes[t] = cls[t, idx]
    return classes, depths


def majority(per_tree: np.ndarray, n_classes: int) -> np.ndarray:
    """(T, M) classes → (M,) int32 majority class, ties to the lowest class."""
    votes = (per_tree[..., None] == np.arange(n_classes)).sum(0)
    return votes.argmax(-1).astype(np.int32)


def classify(tables, records: np.ndarray, n_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """(M,) classes (the one tree's, or the forest's vote) and (M,) compares
    each record needs summed over the trees."""
    per_tree, depths = descend(tables, records)
    classes = per_tree[0] if per_tree.shape[0] == 1 else majority(per_tree, n_classes)
    return classes, depths.sum(0, dtype=np.int64)


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as float32.

    Infinities and NaNs are kept."""
    x = np.ascontiguousarray(x, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    out = rounded.view(np.float32)
    return np.where(np.isfinite(x), out, x).astype(np.float32)
