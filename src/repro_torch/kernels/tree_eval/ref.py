"""Plain-torch oracle for the tree-evaluation kernels.

The reference semantics for every kernel variant: branchless descent of the
breadth-first encoded tree, ``max_depth`` rounds (leaves self-loop, so extra
rounds are no-ops).  Written with the simplest torch ops — no kernel, no
tiling — and used by tests and by ``chip_smoke.py`` as ground truth.  The
forest form carries the tree axis as a batch dimension where the JAX
package's ``ref.py`` uses ``vmap``.
"""

from __future__ import annotations

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
