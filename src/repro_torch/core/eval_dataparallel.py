"""Procedure 3: data-parallel tree evaluation in PyTorch.

One lane per record; every lane iterates the branchless descent
``i = child[i] + (r_a > t)``.  On SIMD hardware the loop's trip count is the
*maximum* depth over the vector (lanes that reach a leaf early self-loop
harmlessly) — the divergence cost the paper attributes to data
decomposition on CUDA warps.  Two loop flavours:

* ``fixed`` — ``max_depth`` rounds (what a warp pays when any lane walks the
  deepest path);
* ``early_exit`` — stop when every record has reached a leaf (independent
  processors, paper §3.6's T₃ analysis).  Each round reads one flag back to
  the host.

Tables may carry a leading tree axis, ``(T, N)``: the forest is then
evaluated as a batch, ``(T, M)``, in place of the JAX package's ``vmap``.
"""

from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.core.tree import BOTTOM, EncodedTree


def _tables(attr_idx, threshold, child, class_val, dev):
    return (
        _device.as_tensor(attr_idx, torch.int64, dev),
        _device.as_tensor(threshold, torch.float32, dev),
        _device.as_tensor(child, torch.int64, dev),
        _device.as_tensor(class_val, torch.int32, dev),
    )


def eval_data_parallel(
    records,
    attr_idx,
    threshold,
    child,
    class_val,
    *,
    max_depth: int,
    loop: str = "fixed",
    device=None,
) -> torch.Tensor:
    """Procedure 3: one record per lane, branchless descent.

    Args:
      records: (M, A) float array or tensor.
      attr_idx/threshold/child/class_val: encoded tree fields, (N,) or (T, N).
      max_depth: bound on tree depth (the ``fixed`` loop's trip count).
      loop: "fixed" | "early_exit".
      device: where to run; default: where ``records`` lies, else CUDA.

    Returns:
      (M,) or (T, M) int32 class assignments.
    """
    if loop not in ("fixed", "early_exit"):
        raise ValueError(f"unknown loop mode {loop!r}")
    dev = _device.resolve(records, device)
    records = _device.as_tensor(records, torch.float32, dev)
    attr_idx, threshold, child, class_val = _tables(attr_idx, threshold, child, class_val, dev)
    m = records.shape[0]
    rows = torch.arange(m, device=dev)
    idx = torch.zeros(child.shape[:-1] + (m,), dtype=torch.int64, device=dev)

    def step(idx):
        v = records[rows, attr_idx.gather(-1, idx)]
        return child.gather(-1, idx) + (v > threshold.gather(-1, idx))

    if loop == "fixed":
        for _ in range(max_depth):
            idx = step(idx)
    else:
        while bool((class_val.gather(-1, idx) == BOTTOM).any()):
            idx = step(idx)
    return class_val.gather(-1, idx)


def eval_data_parallel_tree(
    enc: EncodedTree, records, *, max_depth: int, loop: str = "fixed", device=None
) -> torch.Tensor:
    """Convenience wrapper taking an :class:`EncodedTree`."""
    return eval_data_parallel(
        records, *enc, max_depth=max_depth, loop=loop, device=device
    )
