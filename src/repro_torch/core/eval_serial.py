"""Procedure 2: serial branchless tree evaluation (the speedup reference).

The paper establishes Sharp's branchless traversal as the *best known serial
algorithm* and measures all parallel speedups against it.  This module is the
host (numpy) implementation — deliberately simple, loop-based, and branch-free
at each decision node: ``i = child[i] + (r_a > t)``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.tree import BOTTOM, EncodedTree


def eval_serial(enc: EncodedTree, records: np.ndarray) -> np.ndarray:
    """Procedure 2 over a dataset.

    Args:
      enc: branchless breadth-first encoded tree.
      records: float array (M, A).

    Returns:
      int32 array (M,) of assigned classes.
    """
    records = np.asarray(records)
    m = records.shape[0]
    out = np.empty((m,), np.int32)
    attr, thr, child, cls = enc.attr_idx, enc.threshold, enc.child, enc.class_val
    for r in range(m):
        rec = records[r]
        i = 0
        while cls[i] == BOTTOM:
            # branchless next-node computation (the predicate result is the
            # 0/1 child offset; no explicit if/else on the path taken)
            i = child[i] + int(rec[attr[i]] > thr[i])
        out[r] = cls[i]
    return out


def eval_serial_vectorized_host(enc: EncodedTree, records: np.ndarray, max_depth: int) -> np.ndarray:
    """Host-side vectorized descent (used as a fast oracle for big datasets).

    Semantically identical to :func:`eval_serial`; runs the branchless update
    for ``max_depth`` rounds over all records at once (leaves self-loop so
    overshooting is a no-op).
    """
    records = np.asarray(records)
    m = records.shape[0]
    idx = np.zeros((m,), np.int64)
    rows = np.arange(m)
    for _ in range(max_depth):
        a = enc.attr_idx[idx]
        t = enc.threshold[idx]
        idx = enc.child[idx] + (records[rows, a] > t)
    return enc.class_val[idx].astype(np.int32)
