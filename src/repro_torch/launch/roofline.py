"""The card's peaks, the analytic cost of one tree or forest evaluation, and
the LM dry-run's roofline terms.

The port's counterpart of the JAX package's ``launch/roofline.py``, whose
constants are a TPU v5e's.  Here they are the NVIDIA H100 SXM5's (the 700 W
part), from NVIDIA's H100 Tensor Core GPU data sheet:

    HBM_BW      3.35 TB/s    HBM3 memory bandwidth
    PEAK_FLOPS  67 TFLOP/s   FP32 outside the tensor cores
    PEAK_BF16   989 TFLOP/s  dense BF16 on the tensor cores (no sparsity)

and, for collectives, ``NET_BW`` = 50 GB/s a card: a 16-card mesh axis
spans two 8-card nodes, so its ring crosses the nodes' network, which in
NVIDIA's DGX H100 data sheet is 8 ConnectX-7 NICs of 400 Gb/s a node, one
a card (400 Gb/s = 50 GB/s).  ``CARD_MEMORY`` is what
``torch.cuda.get_device_properties(0).total_memory`` reads on the H100
80GB HBM3 (``chip_smoke.py [dryrun]`` prints it); a cell ``fits`` when its
peak live bytes a card are at most that.

FP32 is the unit a tree's compares run on (no tensor core evaluates a
``>``), so it is the operation peak a tree kernel is held to; the LM's
products run on the tensor cores in bf16, so the LM terms use ``PEAK_BF16``.

:func:`tree_eval_cost` counts what one call must do whatever the algorithm:
read the records and the four node tables once, write the output once, and
make one compare per level each record descends.  The speculative
algorithm's extra node evaluations and the one-hot form's FMAs are its own
cost, not the function's.  ``chip_smoke.py`` bounds every kernel with it and
the tuner (``tune/measure.py``) prices every candidate with it, so the two
use one formula.
"""

from __future__ import annotations

import dataclasses
import json

PEAK_FLOPS = 67e12   # FP32 FLOP/s, H100 SXM5
HBM_BW = 3.35e12     # HBM3 bytes/s, H100 SXM5
PEAK_BF16 = 989e12   # dense BF16 tensor-core FLOP/s, H100 SXM5
NET_BW = 50e9        # bytes/s a card across nodes: one 400 Gb/s NIC a card (DGX H100)
CARD_MEMORY = 85_017_493_504   # total_memory of an H100 80GB HBM3 (read on the card), bytes


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


# ---------------------------------------------------------------------------
# The LM dry-run's roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineTerms:
    """One cell's counted cost a card (``utils.op_cost``) and its terms:

        compute    = flops a card / PEAK_BF16
        memory     = bytes a card / HBM_BW
        collective = collective wire bytes a card / NET_BW
    """

    arch: str
    shape: str
    step: str
    mesh: str
    chips: int
    flops: float               # a card
    bytes: float               # a card
    coll_bytes: float          # a card
    coll_summary: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float         # the whole step's useful FLOPs (6ND / 2ND)
    peak_bytes: float = 0.0    # peak live bytes a card

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """Model FLOPs over the FLOPs every card runs: below 1 where cards
        repeat work (the ranks of a ``model`` row on one batch shard) or
        recompute it (remat)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(model_flops / chips / PEAK_BF16) / max(compute, memory, collective)."""
        ideal = self.model_flops / self.chips / PEAK_BF16
        return ideal / self.bound_s if self.bound_s else 0.0

    @property
    def fits(self) -> bool:
        return self.peak_bytes <= CARD_MEMORY

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "step": self.step,
            "mesh": self.mesh, "chips": self.chips,
            "flops_per_card": self.flops,
            "bytes_per_card": self.bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_summary": self.coll_summary,
            "fit_bytes": self.peak_bytes,
            "fits": self.fits,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D useful FLOPs of a train step, 2·N·D of a prefill, 2·N·B of one
    decode step (N the active parameters), as the JAX package counts them."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def terms_from_counts(*, arch: str, shape, step: str, mesh_name: str, chips: int, cost, cfg) -> RooflineTerms:
    """The terms of one cell from its :class:`repro_torch.utils.op_cost.OpCost`."""
    coll = float(cost.coll_total_bytes)
    return RooflineTerms(
        arch=arch, shape=shape.name, step=step, mesh=mesh_name, chips=chips,
        flops=float(cost.flops), bytes=float(cost.bytes), coll_bytes=coll,
        coll_summary=cost.coll_summary(),
        compute_s=cost.flops / PEAK_BF16, memory_s=cost.bytes / HBM_BW, collective_s=coll / NET_BW,
        model_flops=model_flops_for(cfg, shape), peak_bytes=float(cost.peak_bytes),
    )


def measured_fraction(model_flops: float, chips: int, step_s: float) -> float:
    """The measured roofline fraction: a card's share of the model FLOPs at
    ``PEAK_BF16`` over the measured step time."""
    return model_flops / chips / PEAK_BF16 / step_s if step_s > 0 else 0.0


def format_table(rows: list[dict]) -> str:
    cols = ["arch", "shape", "step", "mesh", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_ratio", "roofline_fraction", "fits"]
    hdr = " | ".join(f"{c:>18s}" for c in cols)
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if "dominant" not in r:
            continue
        lines.append(" | ".join(f"{r[c]:>18.3e}" if isinstance(r[c], float) else f"{str(r[c]):>18s}" for c in cols))
    return "\n".join(lines)


def save_rows(path: str, rows: list[dict]) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
