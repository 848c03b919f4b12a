"""The work a classification needs, and the least time an H100 takes for it.

A frozen copy of the port's ``launch/roofline.py`` ``tree_eval_cost`` and
``bound_ms``, with the peaks of NVIDIA's H100 SXM data sheet (the 700 W
part): 3.35 TB/s of HBM3, and 67 TFLOP/s in FP32 outside the tensor cores,
the unit a tree's compares run on.

One rule counts the work of a call whatever implements it: the call's real
records read once (f32), the four node tables read once (4 bytes a node
each), the final classes written once (int32, one a record, also for a
forest), and one compare per level each record descends in each tree.
Padding rows, a forest's per-tree classes and one-hot products count as
nothing, so a share of this bound cannot pass 100% unless a time leaves out
part of the work.
"""

from __future__ import annotations

HBM_BW = 3.35e12      # bytes/s, H100 SXM HBM3
PEAK_FLOPS = 67e12    # FP32 operations/s outside the tensor cores, H100 SXM


def tree_eval_cost(m: int, a: int, t: int, n: int, compares: float,
                   *, out_bytes: float | None = None) -> dict[str, float]:
    """Bytes and compares of classifying ``m`` records of ``a`` attributes by
    ``t`` trees of ``n`` nodes (four 4-byte tables), with ``compares`` the
    summed traversal depths.  ``out_bytes`` defaults to (t, m) int32 classes."""
    if out_bytes is None:
        out_bytes = t * m * 4
    return {"bytes": float(m * a * 4 + t * n * 4 * 4 + out_bytes), "ops": float(compares)}


def bound_ms(bytes_: float, ops: float) -> tuple[float, str]:
    """(milliseconds, "bytes" | "operations"): the larger of the bytes over
    ``HBM_BW`` and the operations over ``PEAK_FLOPS``, and which it was."""
    byte_ms = bytes_ / HBM_BW * 1e3
    op_ms = ops / PEAK_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def call_bound_s(m: int, a: int, t: int, n: int, compares: float) -> float:
    """Least seconds for one call that classifies ``m`` records to final
    classes: the records, the tables once, ``m`` int32 classes out."""
    cost = tree_eval_cost(m, a, t, n, compares, out_bytes=m * 4)
    return bound_ms(cost["bytes"], cost["ops"])[0] / 1e3
