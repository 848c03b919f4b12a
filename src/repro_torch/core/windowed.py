"""Windowed speculative evaluation — the paper's §6 future-work idea, built.

For very large trees the speculative decomposition's p = N processors exceed
what one CTA holds: every kernel of the port refuses a tree whose record
tile and tables do not fit a CTA's shared memory (``kernel.TileError``).
The paper proposes evaluating a *window* of levels at a time: speculate
within the window, reduce, adopt the resulting node as the new root, repeat.

Breadth-first numbering stores each level contiguously, so a window of ``w``
consecutive levels is a contiguous index range ``[lo, hi)`` shared by every
record — no per-record node sets.  Each round: (1) speculatively evaluate
all nodes in the window (a gather of each record's attributes over the
``hi - lo`` band), (2) pointer-jump ``⌈log₂(w + 1)⌉`` times *within the
window* (successors beyond ``hi`` park unchanged and are picked up by the
next window), (3) advance.  The working set is bounded by the widest
``w``-level band instead of N.

Plain torch ops on the records' device.  The band's (M, band) successor and
pointer tensors are the memory cost (a 16,383-node tree at ``w = 4`` has a
widest band of 12,288 nodes: 3.2 GB of int32 a tensor at M 65,536), so the
records are evaluated in chunks whose working set fits
``WINDOW_BUDGET_BYTES``; the window is never cut.

Exactness: leaves self-loop, and any pointer that exits the window is
resolved in a later round, so the result equals the unwindowed evaluator
and ``eval_serial``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.tree import EncodedTree, node_depths

WINDOW_BUDGET_BYTES = 4 << 30   # working set of one chunk of records
BAND_BYTES = 32                 # bytes a (record, band node) pair holds at the peak


def level_offsets(enc: EncodedTree) -> np.ndarray:
    """BFS start index of every level (levels are contiguous in BFS order)."""
    depths = node_depths(enc)
    max_d = int(depths.max())
    starts = np.zeros((max_d + 2,), np.int64)
    for lvl in range(max_d + 1):
        idx = np.nonzero(depths == lvl)[0]
        starts[lvl] = idx.min() if idx.size else starts[lvl - 1]
    starts[max_d + 1] = enc.n_nodes
    # verify contiguity (true for BFS encodings of full trees)
    for lvl in range(max_d + 1):
        idx = np.nonzero(depths == lvl)[0]
        if idx.size:
            assert idx.max() - idx.min() + 1 == idx.size, "BFS levels not contiguous"
    return starts


def _bands(starts: np.ndarray, w: int) -> list[tuple[int, int]]:
    """The non-empty ``[lo, hi)`` node ranges of ``w`` levels each."""
    max_d = len(starts) - 2
    out = []
    for lo_lvl in range(0, max_d + 1, w):
        lo, hi = int(starts[lo_lvl]), int(starts[min(lo_lvl + w, max_d + 1)])
        if hi > lo:
            out.append((lo, hi))
    return out


def _eval_chunk(rec, attr, thr, child, cls, bands, jumps: int) -> torch.Tensor:
    cur = torch.zeros((rec.shape[0],), dtype=torch.int32, device=rec.device)
    for lo, hi in bands:
        width = hi - lo
        # (1) speculative node evaluation over the band (every record × node)
        succ = child[lo:hi] + (rec[:, attr[lo:hi]] > thr[lo:hi]).int()     # (m, band)
        # (2) pointer DOUBLING within the band (Procedure 4's
        # path[i] <- path[path[i]], restricted to the window): after k rounds
        # every in-band pointer skips 2^k original steps; pointers that exit
        # the band park and are resolved by a later window.
        ptr = succ
        for _ in range(jumps):
            nxt = ptr.gather(1, (ptr - lo).clamp_(0, width - 1).long())
            ptr = torch.where((ptr >= lo) & (ptr < hi), nxt, ptr)
        # (3) advance each record's node through the band
        take = ptr.gather(1, (cur - lo).clamp(0, width - 1).long()[:, None])[:, 0]
        cur = torch.where((cur >= lo) & (cur < hi), take, cur)
    return cls[cur.long()]


def eval_windowed(
    enc: EncodedTree,
    records,
    *,
    window_levels: int = 4,
    chunk_records: int | None = None,
    device=None,
) -> torch.Tensor:
    """Windowed speculative evaluation; exact-equal to the full evaluator.

    Per window round the node axis is only ``max_band = max nodes in any
    ``window_levels`` consecutive levels`` wide — the SIMD-concurrency bound
    the paper's §6 asks for.

    Args:
      enc: the encoded tree, of any size.
      records: (M, A) float array or tensor (compared in f32).
      window_levels: levels a window spans.
      chunk_records: records a chunk evaluates at once; default the most
        whose widest band fits ``WINDOW_BUDGET_BYTES``.
      device: where to run; default where ``records`` lies, else CUDA.

    Returns:
      (M,) int32 class assignments on that device.
    """
    dev = _device.resolve(records, device)
    rec = _device.as_tensor(records, torch.float32, dev)
    w = max(window_levels, 1)
    bands = _bands(level_offsets(enc), w)
    # 2^jumps >= w guarantees a band-top pointer traverses the whole window
    jumps = max(1, math.ceil(math.log2(w + 1)))
    attr = _device.as_tensor(enc.attr_idx, torch.int64, dev)
    thr = _device.as_tensor(enc.threshold, torch.float32, dev)
    child = _device.as_tensor(enc.child, torch.int32, dev)
    cls = _device.as_tensor(enc.class_val, torch.int32, dev)
    m = rec.shape[0]
    if chunk_records is None:
        band = max(hi - lo for lo, hi in bands)
        chunk_records = max(1, WINDOW_BUDGET_BYTES // (band * BAND_BYTES))
    if m <= chunk_records:
        return _eval_chunk(rec, attr, thr, child, cls, bands, jumps)
    return torch.cat([
        _eval_chunk(rec[i:i + chunk_records], attr, thr, child, cls, bands, jumps)
        for i in range(0, m, chunk_records)
    ])
