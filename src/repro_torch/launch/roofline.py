"""The card's peaks and the analytic cost of one tree or forest evaluation.

The port's counterpart of the JAX package's ``launch/roofline.py``, whose
constants are a TPU v5e's.  Here they are the NVIDIA H100 SXM5's (the 700 W
part), from NVIDIA's H100 Tensor Core GPU data sheet:

    HBM_BW      3.35 TB/s   HBM3 memory bandwidth
    PEAK_FLOPS  67 TFLOP/s  FP32 outside the tensor cores

FP32 is the unit a tree's compares run on (no tensor core evaluates a
``>``), so it is the operation peak a tree kernel is held to.

:func:`tree_eval_cost` counts what one call must do whatever the algorithm:
read the records and the four node tables once, write the output once, and
make one compare per level each record descends.  The speculative
algorithm's extra node evaluations and the one-hot form's FMAs are its own
cost, not the function's.  ``chip_smoke.py`` bounds every kernel with it and
the tuner (``tune/measure.py``) prices every candidate with it, so the two
use one formula.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12   # FP32 FLOP/s, H100 SXM5
HBM_BW = 3.35e12     # HBM3 bytes/s, H100 SXM5


def tree_eval_cost(
    m: int, a: int, t: int, n: int, compares: float,
    *, out_bytes: float | None = None, table_bytes: float | None = None,
) -> dict[str, float]:
    """Bytes and compares of classifying ``m`` records by ``t`` trees of ``n`` nodes.

    Args:
      m, a: records and their attribute count (f32 records, read once).
      t, n: trees and nodes per tree.
      compares: the compares this call's records need, one per level each
        descends (the sum of their traversal depths over the trees); where
        the depths are not known, their upper bound ``m·t·max_depth``.
      out_bytes: bytes written; default the (t, m) int32 classes.  The vote
        kernels write (m, C) int32 counts instead.
      table_bytes: the four node tables at their stored widths; default 4
        bytes a node each (the quantized layouts store fewer).

    Returns:
      ``{"bytes": ..., "ops": ...}``.
    """
    if out_bytes is None:
        out_bytes = t * m * 4
    if table_bytes is None:
        table_bytes = t * n * 4 * 4
    return {"bytes": float(m * a * 4 + table_bytes + out_bytes), "ops": float(compares)}


def bound_ms(bytes_: float, ops: float) -> tuple[float, str]:
    """Least time the card could take for work of ``bytes_`` and ``ops``.

    Returns (milliseconds, "bytes" | "operations"): the larger of the bytes
    over ``HBM_BW`` and the operations over ``PEAK_FLOPS``, and which it was.
    """
    byte_ms = bytes_ / HBM_BW * 1e3
    op_ms = ops / PEAK_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def roofline_fraction(bytes_: float, ops: float, median_ms: float) -> float:
    """Fraction of the bound a measured time reaches (0 for no time)."""
    if median_ms <= 0 or median_ms == float("inf"):
        return 0.0
    return bound_ms(bytes_, ops)[0] / median_ms
