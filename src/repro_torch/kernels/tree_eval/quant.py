"""Quantized struct-of-arrays forest layouts: the narrow node tables of K7/K8.

:class:`repro_torch.kernels.tree_eval.ops.PackedForest` carries full-width
f32/int32 tables and, for the one-hot speculative form, an ``attr_select``
matrix of A·N floats per tree that dwarfs the scalar tables.
:class:`QuantizedForest` is the compact dual: per-record attribute gathers
replace the selection matrix (no ``attr_select`` at all), attribute indices,
child pointers and classes shrink to the narrowest of int8/int16/int32 that
holds them, leaf flags bit-pack 8 to a byte, and thresholds drop to bf16/f16
under a **split-safe rounding rule** that never changes a routing decision.

Split-safe rounding
-------------------
The branchless predicate is strict: ``next = child + (v > t)``.  Replacing
``t`` with a low-precision ``t'`` preserves the routing of a value ``v``
exactly when ``(v > t') == (v > t)``.  Two regimes:

* **universal** (``calibration=None``): ``t'`` must preserve the predicate
  for every possible ``v``, so only exact round-trips qualify
  (``f32(cast(t)) == t``); every other node keeps its exact f32 threshold.
  The layout is bit-exact for arbitrary inputs, ±inf and NaN included.
* **split-safe** (``calibration=(M, A)`` records): per node, the observed
  values of its attribute define a routing interval
  ``v_lo = max{v : v <= t}``, ``v_hi = min{v : v > t}``; any representable
  ``t'`` with ``v_lo <= t' < v_hi`` preserves every calibration record's
  branch, the ``<=``/``>`` tie-break on a value that sits exactly on the
  split included.  Nodes whose interval holds no representable value fall
  back to exact f32 (counted in ``fallback_nodes``).

When any node falls back the threshold table is stored as f32 (safe nodes
keep their quantized-then-upcast value, so per-node routing is the same
whichever storage the forest ends up with), and ``nbytes`` counts the table
at its stored width, never the requested one.

Narrow floats on the host.  NumPy has float16 but no bfloat16, so on the
host a narrow threshold is its 16-bit pattern (uint16).  torch rounds
(``Tensor.to(torch.bfloat16 / torch.float16)``: to nearest, ties to even, as
``ml_dtypes`` and numpy do) and upcasts exactly.  On the device the table is
a ``torch.bfloat16``/``torch.float16`` (or ``torch.float32``) tensor, and the
kernels upcast it in registers.

Unlike the JAX package's layout, N and A are not padded to 128 lanes; the
integer dtypes come out the same, since ``_int_dtype``'s limits (127,
32,767) sit just below multiples of 128.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.tree import (
    BOTTOM,
    EncodedTree,
    check_table_indices,
    node_depths,
    pad_tree,
    tree_depth,
)

THR_DTYPES: dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _tensor(x, dtype=None) -> torch.Tensor:
    """A host tensor of ``x`` (copied if read-only, as arrays from other packages may be)."""
    return torch.from_numpy(np.require(x, dtype, ["C", "W"]))


# ---------------------------------------------------------------------------
# 16-bit float bit patterns (f16 and bf16 share the IEEE-style layout)
# ---------------------------------------------------------------------------


def to_bits(x, thr_dtype: str) -> np.ndarray:
    """float32 values → uint16 patterns of ``thr_dtype``, rounded to nearest even."""
    t = _tensor(x, np.float32).to(THR_DTYPES[thr_dtype])
    return t.view(torch.int16).numpy().view(np.uint16)


def from_bits(bits, thr_dtype: str) -> np.ndarray:
    """uint16 patterns of ``thr_dtype`` → their exact float32 values."""
    return _tensor(bits, np.uint16).view(THR_DTYPES[thr_dtype]).float().numpy()


def _ordered_from_bits(bits: np.ndarray) -> np.ndarray:
    """Map 16-bit float bit patterns to integers monotone in float value."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, 0x7FFF - (b & 0x7FFF), b + 0x8000)


def _bits_from_ordered(keys: np.ndarray) -> np.ndarray:
    k = np.asarray(keys, np.int64)
    return np.where(k >= 0x8000, k - 0x8000, 0x8000 | (0x7FFF - k)).astype(np.uint16)


def _neighbors(bits: np.ndarray, thr_dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Element-wise (previous, next) representable patterns of ``bits`` in ``thr_dtype``.

    Saturates at the ordered-key range ends, so ±inf's outward neighbour is
    itself (never a NaN pattern).
    """
    keys = _ordered_from_bits(np.asarray(bits, np.uint16))
    fin = _ordered_from_bits(
        np.array([0x7C00 if thr_dtype == "float16" else 0x7F80], np.uint16))[0]
    prev = _bits_from_ordered(np.clip(keys - 1, 0xFFFF - fin, fin))
    nxt = _bits_from_ordered(np.clip(keys + 1, 0xFFFF - fin, fin))
    return prev, nxt


# ---------------------------------------------------------------------------
# split-safe threshold quantization
# ---------------------------------------------------------------------------


def routing_interval(sorted_vals: np.ndarray, t: float) -> tuple[float, float]:
    """The (v_lo, v_hi) routing interval of threshold ``t`` over observed values.

    Any ``t'`` with ``v_lo <= t' < v_hi`` preserves ``v > t'`` for every
    value in ``sorted_vals`` (finite, ascending).  Empty side → ∓inf.
    """
    i = int(np.searchsorted(sorted_vals, t, side="right"))
    v_lo = float(sorted_vals[i - 1]) if i > 0 else -np.inf
    v_hi = float(sorted_vals[i]) if i < len(sorted_vals) else np.inf
    return v_lo, v_hi


def quantize_thresholds(
    threshold: np.ndarray,
    leaf_mask: np.ndarray,
    attr_idx: np.ndarray,
    *,
    thr_dtype: str = "bfloat16",
    attr_values: dict[int, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Quantize one tree's thresholds under the split-safe rounding rule.

    Args:
      threshold/leaf_mask/attr_idx: the encoded tree's (N,) tables.
      thr_dtype: "bfloat16" | "float16" target.
      attr_values: {attr → sorted finite calibration values}; None selects
        the universal regime (quantize only exact round-trips).

    Returns:
      (qbits, safe): the (N,) quantized table as uint16 patterns of
      ``thr_dtype``, and the boolean mask of nodes whose quantized threshold
      is routing-safe.  Leaves (``+inf`` round-trips exactly) are always safe.
    """
    if thr_dtype not in THR_DTYPES:
        raise ValueError(f"thr_dtype must be one of {sorted(THR_DTYPES)}")
    thr = np.asarray(threshold, np.float32)
    leaf = np.asarray(leaf_mask, bool)
    q = to_bits(thr, thr_dtype)
    up = from_bits(q, thr_dtype)
    if attr_values is None:
        return q, leaf | (up == thr)
    safe = leaf.copy()
    prev, nxt = _neighbors(q, thr_dtype)
    up_prev, up_nxt = from_bits(prev, thr_dtype), from_bits(nxt, thr_dtype)
    for i in np.nonzero(~leaf)[0]:
        vals = attr_values.get(int(attr_idx[i]))
        if vals is None or not len(vals):
            safe[i] = True  # attribute never observed: any t' routes nothing
            continue
        t = float(thr[i])
        v_lo, v_hi = routing_interval(vals, t)
        bits = (q[i], prev[i], nxt[i])
        values = (float(up[i]), float(up_prev[i]), float(up_nxt[i]))
        # Nearest first, NaN and out-of-interval candidates rejected.  Equal
        # distances keep the set's order, the one the JAX package's set of
        # ml_dtypes scalars has: those hash and compare as these floats do
        # (so ±0 collapse onto the first inserted, the cast).
        for c in sorted({values[0], values[1], values[2]}, key=lambda c: abs(c - t)):
            if v_lo <= c < v_hi:
                q[i] = bits[values.index(c)]
                safe[i] = True
                break
    return q, safe


# ---------------------------------------------------------------------------
# bit-packed leaf flags
# ---------------------------------------------------------------------------


def pack_leaf_bits(leaf_mask: np.ndarray) -> np.ndarray:
    """(..., N) bool → (..., ⌈N/8⌉) uint8, LSB-first within each byte."""
    return np.packbits(np.asarray(leaf_mask, bool), axis=-1, bitorder="little")


def unpack_leaf_bits(bits: np.ndarray, n_nodes: int) -> np.ndarray:
    """Inverse of :func:`pack_leaf_bits`."""
    return np.unpackbits(np.asarray(bits, np.uint8), axis=-1, count=n_nodes,
                         bitorder="little").astype(bool)


# ---------------------------------------------------------------------------
# level-synchronous breadth-first renumbering
# ---------------------------------------------------------------------------


def level_sync_renumber(enc: EncodedTree, *, lane: int = 1) -> tuple[EncodedTree, np.ndarray]:
    """Renumber nodes level-contiguously, each level start ``lane``-aligned.

    BFS encoding is already level-ordered; this makes the level boundaries
    addressable.  Gaps introduced by the alignment are filled with phantom
    self-loop leaves (class 0, unreachable), as :func:`pad_tree` fills, so a
    level-synchronous kernel can load level ``l`` as the aligned slab
    ``[offsets[l], offsets[l+1])``.

    Returns:
      (renumbered tree, offsets): ``offsets`` has length ``levels + 1``;
      ``offsets[-1]`` is the new node count.  With ``lane=1`` the
      renumbering is the identity for a freshly BFS-encoded tree.
    """
    depth = node_depths(enc)
    order = np.argsort(depth, kind="stable")  # stable: keeps BFS order per level
    levels = depth[order]
    n = enc.n_nodes
    new_pos = np.empty((n,), np.int64)
    offsets = []
    pos = 0
    for lvl in range(int(levels.max()) + 1 if n else 1):
        pos = _round_up(pos, lane)
        offsets.append(pos)
        members = order[levels == lvl]
        new_pos[members] = pos + np.arange(len(members))
        pos += len(members)
    n_new = _round_up(pos, lane)
    offsets.append(n_new)

    attr_idx = np.zeros((n_new,), np.int32)
    threshold = np.full((n_new,), np.inf, np.float32)
    child = np.arange(n_new, dtype=np.int32)  # phantoms self-loop
    class_val = np.zeros((n_new,), np.int32)
    leaf = enc.is_leaf_mask
    for i in range(n):
        p = int(new_pos[i])
        attr_idx[p] = enc.attr_idx[i]
        if leaf[i]:
            class_val[p] = enc.class_val[i]
        else:
            c = int(enc.child[i])
            if new_pos[c + 1] != new_pos[c] + 1:
                raise ValueError(f"renumbering split the children of node {i}")
            threshold[p] = enc.threshold[i]
            child[p] = new_pos[c]
            class_val[p] = BOTTOM
    return EncodedTree(attr_idx, threshold, child, class_val), np.asarray(offsets, np.int64)


# ---------------------------------------------------------------------------
# the quantized stacked-forest container
# ---------------------------------------------------------------------------


def _int_dtype(max_value: int) -> np.dtype:
    if max_value <= np.iinfo(np.int8).max:
        return np.dtype(np.int8)
    if max_value <= np.iinfo(np.int16).max:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def calibration_attr_values(calibration, n_attrs: int) -> dict[int, np.ndarray]:
    """Per-attribute sorted finite value sets from an (M, A) calibration batch."""
    cal = np.asarray(calibration, np.float32)
    out = {}
    for a in range(min(n_attrs, cal.shape[1])):
        v = cal[:, a]
        out[a] = np.sort(np.unique(v[np.isfinite(v)]))
    return out


def _table_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class QuantizedForest:
    """Compact stacked tables on the device for the quantized kernels K7/K8.

    The quantized dual of :class:`repro_torch.kernels.tree_eval.ops.PackedForest`:
    the same (T, N) stacking of trees padded to one node count, but no
    ``attr_select`` matrix (the kernels gather each record's attribute) and
    every table at the narrowest dtype that holds it:

      ======================  ===========================================
      table                   dtype
      ======================  ===========================================
      ``attr_idx``  (T, N)    int8 (A ≤ 128), int16, else int32
      ``threshold`` (T, N)    bf16/f16; f32 when any node falls back
      ``child``     (T, N)    int8 (N ≤ 128), int16 (N ≤ 32,768), else int32
      ``class_val`` (T, N)    int8 (classes ≤ 127), int16, else int32
      ``leaf_bits`` (T, ⌈N/8⌉)  uint8 bit-packed leaf flags
      ======================  ===========================================

    Args:
      forest: an ``EncodedForest`` (or anything exposing ``n_trees`` /
        ``tree(i)``).
      n_attrs: record attribute count A.
      thr_dtype: threshold target, "bfloat16" | "float16".
      calibration: optional (M, A) records enabling split-safe threshold
        rounding (see the module docstring); None = universal (always exact).
      renumber: apply :func:`level_sync_renumber` per tree before packing
        (``level_offsets`` records the per-tree level slabs).
      max_depth: depth bound over the forest; default: the trees' deepest.
      device: where the tables go; default CUDA.
    """

    layout = "quant"

    def __init__(
        self,
        forest,
        n_attrs: int,
        *,
        thr_dtype: str = "bfloat16",
        calibration=None,
        renumber: bool = False,
        max_depth: int | None = None,
        device=None,
    ):
        if thr_dtype not in THR_DTYPES:
            raise ValueError(f"thr_dtype must be one of {sorted(THR_DTYPES)}")
        trees = [forest.tree(i) for i in range(int(forest.n_trees))]
        level_offsets = None
        if renumber:
            pairs = [level_sync_renumber(t) for t in trees]
            trees = [t for t, _ in pairs]
            level_offsets = [off for _, off in pairs]
        n = max(t.n_nodes for t in trees)
        penc = [pad_tree(t, n) for t in trees]
        attr_values = (
            calibration_attr_values(calibration, n_attrs) if calibration is not None else None
        )
        qthrs, safes = zip(*(
            quantize_thresholds(p.threshold, p.is_leaf_mask, p.attr_idx,
                                thr_dtype=thr_dtype, attr_values=attr_values)
            for p in penc
        ))
        safe_all = np.stack(safes)
        fallback_nodes = int((~safe_all).sum())
        if fallback_nodes:
            # mixed storage: safe nodes keep their quantized-then-upcast
            # value (routing identical to the pure-quantized table), tight
            # nodes their exact f32 threshold
            thr_f32 = np.stack([p.threshold for p in penc]).astype(np.float32)
            thr = np.where(safe_all, from_bits(np.stack(qthrs), thr_dtype), thr_f32)
            thr_stored = "float32"
        else:
            thr = np.stack(qthrs)
            thr_stored = thr_dtype
        class_val = np.stack([p.class_val for p in penc])
        self._place(
            np.stack([p.attr_idx for p in penc]).astype(_int_dtype(max(n_attrs - 1, 1))),
            thr,
            np.stack([p.child for p in penc]).astype(_int_dtype(n - 1)),
            class_val.astype(_int_dtype(max(int(class_val.max()), 1))),
            n_attrs=n_attrs,
            thr_dtype=thr_dtype,
            thr_stored=thr_stored,
            fallback_nodes=fallback_nodes,
            max_depth=max_depth if max_depth is not None else max(tree_depth(t) for t in trees),
            device=device,
        )
        self.renumbered = bool(renumber)
        self.level_offsets = level_offsets

    @classmethod
    def from_tables(
        cls,
        attr_idx: np.ndarray,
        threshold: np.ndarray,
        child: np.ndarray,
        class_val: np.ndarray,
        *,
        thr_dtype: str,
        thr_stored: str,
        max_depth: int,
        n_attrs: int,
        fallback_nodes: int = 0,
        device=None,
    ) -> "QuantizedForest":
        """Carry a quantized forest across as (T, N) numpy tables, as stored.

        The integer tables are int8/int16/int32 and are kept at their width;
        ``threshold`` is uint16 bit patterns when ``thr_stored`` is
        "bfloat16" or "float16" (NumPy has no bfloat16), float32 when it is
        "float32".  ``thr_dtype`` is the narrow width that was asked for and
        ``fallback_nodes`` how many nodes kept f32; both only describe the
        layout.  Leaf flags are recomputed from ``class_val``.
        """
        if thr_dtype not in THR_DTYPES:
            raise ValueError(f"thr_dtype must be one of {sorted(THR_DTYPES)}")
        if thr_stored not in (thr_dtype, "float32"):
            raise ValueError(f"thr_stored must be {thr_dtype!r} or 'float32', got {thr_stored!r}")
        want_thr = np.float32 if thr_stored == "float32" else np.uint16
        tables = {"attr_idx": attr_idx, "threshold": threshold, "child": child,
                  "class_val": class_val}
        for name, x in tables.items():
            if not isinstance(x, np.ndarray) or x.ndim != 2:
                raise ValueError(f"{name} must be a 2-D numpy array")
            ok = x.dtype == want_thr if name == "threshold" else x.dtype in (np.int8, np.int16, np.int32)
            if not ok:
                raise TypeError(f"{name} may not be stored as {x.dtype} (thr_stored={thr_stored})")
        if len({x.shape for x in tables.values()}) != 1 or attr_idx.shape[-1] == 0:
            raise ValueError(f"table shapes differ or hold no nodes: {[x.shape for x in tables.values()]}")
        self = cls.__new__(cls)
        self._place(attr_idx, threshold, child, class_val, n_attrs=n_attrs, thr_dtype=thr_dtype,
                    thr_stored=thr_stored, fallback_nodes=fallback_nodes, max_depth=max_depth,
                    device=device)
        self.renumbered = False
        self.level_offsets = None
        return self

    def _place(self, attr_idx, thr, child, class_val, *, n_attrs, thr_dtype, thr_stored,
               fallback_nodes, max_depth, device) -> None:
        """Check the host tables and move them to ``device`` at their stored widths."""
        check_table_indices(attr_idx, child, class_val, n_attrs)
        dev = _device.resolve(None, device)
        self.n_trees, self.n_nodes = (int(x) for x in attr_idx.shape)
        self.logical_nodes = self.n_nodes
        self.n_attrs = int(n_attrs)
        self.max_depth = int(max_depth)
        self.thr_dtype = thr_dtype
        self.thr_stored = thr_stored
        self.fallback_nodes = int(fallback_nodes)
        self.attr_idx = _tensor(attr_idx).to(dev)
        if thr_stored == "float32":
            self.threshold = _tensor(thr, np.float32).to(dev)
        else:
            self.threshold = _tensor(thr, np.uint16).view(THR_DTYPES[thr_stored]).to(dev)
        self.child = _tensor(child).to(dev)
        self.class_val = _tensor(class_val).to(dev)
        self.leaf_bits = torch.from_numpy(pack_leaf_bits(class_val != BOTTOM)).to(dev)
        self.device = self.threshold.device

    def tables(self) -> dict[str, torch.Tensor]:
        return {"attr_idx": self.attr_idx, "threshold": self.threshold, "child": self.child,
                "class_val": self.class_val, "leaf_bits": self.leaf_bits}

    @property
    def nbytes(self) -> int:
        """Total node-table bytes at stored widths (the honest footprint)."""
        return sum(_nbytes(x) for x in self.tables().values())

    def bytes_report(self) -> dict:
        """Per-table byte/dtype breakdown."""
        return {
            "total_bytes": self.nbytes,
            "bytes_per_node": self.nbytes / (self.n_trees * self.n_nodes),
            "thr_requested": self.thr_dtype,
            "thr_stored": self.thr_stored,
            "fallback_nodes": self.fallback_nodes,
            "tables": {
                k: {"dtype": _table_name(v.dtype), "bytes": _nbytes(v)}
                for k, v in self.tables().items()
            },
        }


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def packed_forest_nbytes(pf) -> int:
    """Node-table bytes of an ``ops.PackedForest`` (``attr_select`` included)."""
    return sum(_nbytes(x) for x in (pf.attr_select, pf.attr_idx, pf.threshold, pf.child, pf.class_val))


def forest_table_bytes(target) -> int | None:
    """Node-table bytes of whatever a forest variant actually runs against."""
    nb = getattr(target, "nbytes", None)
    if nb is not None:
        return int(nb)
    tables = [getattr(target, k, None) for k in ("attr_idx", "threshold", "child", "class_val")]
    if any(t is None for t in tables):
        return None
    if hasattr(target, "attr_select"):
        tables.append(target.attr_select)
    return sum(_nbytes(t) for t in tables)
