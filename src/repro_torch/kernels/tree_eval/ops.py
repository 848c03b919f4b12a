"""Public wrappers for the tree-evaluation CUDA kernels.

Handle what the raw kernels assume away: moving the host-side encodings to
the device once (``PackedTree`` / ``PackedForest``, or the narrow tables of
``quant.QuantizedForest``), checking that every
table index stays inside its table (the kernels index shared memory with
them), record upcast and sanitizing, and sizing the record tile from the
kernels' shared-memory footprint.  The kernels mask the ragged record edge
themselves, so records are not padded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.eval_dataparallel import eval_data_parallel, eval_data_parallel_tree
from repro_torch.core.eval_speculative import (
    eval_speculative,
    eval_speculative_tree,
    sanitize_records,
)
from repro_torch.core.tree import EncodedTree, attr_select_matrix, check_table_indices, tree_depth
from repro_torch.kernels.tree_eval import kernel as _k
from repro_torch.kernels.tree_eval.quant import QuantizedForest, packed_forest_nbytes
from repro_torch.obs.trace import NULL_TRACER

SMEM_TARGET = _k.SMEM_TARGET   # a tile this small needs no opt-in and leaves room
                               # for several CTAs on one SM
SPECULATIVE_BM_MAX = 128  # records per speculative tile (8 warps, whole records each)
DATA_PARALLEL_BM_MAX = 256  # records per data-parallel tile (128 threads, two rows at most each)
ALGORITHMS = ("speculative", "data_parallel")


def choose_block_m(
    n_nodes: int,
    n_attrs: int,
    *,
    algorithm: str = "speculative",
    jump_mode: str = "gather",
    n_classes: int = 0,
) -> int:
    """Pick the record-tile height from the kernels' shared-memory footprint.

    The largest power of two up to the algorithm's cap whose tile fits in
    ``SMEM_TARGET``; failing that, in all a CTA may opt into (``SMEM_MAX``).
    The speculative footprint is the record tile (``block_m·A`` floats,
    rows padded to 4), one tree's tables at least (``N·4`` words, or
    ``N·(3 + A)`` for the one-hot form's ``attr_select``) and, for N > 64,
    each warp's ``4·N`` ints of paths.  The data-parallel footprint is the
    record tile (``block_m·(A | 1)`` floats, padded to 4) and one tree's
    packed nodes and classes at least (``3·N`` words).  Either kernel stages
    as many more trees as fit (``kernel.table_chunk``), so the forest's size
    does not change the tile.  The vote kernels (K5/K6) add their (block_m, C) int32 vote tile,
    ``block_m·C·4``: pass ``n_classes`` for them, 0 for the class kernels.
    The quantized kernels (K7/K8) widen their tables as they stage them, so
    their tile is sized as the ``gather`` form's.
    """
    top = DATA_PARALLEL_BM_MAX if algorithm == "data_parallel" else SPECULATIVE_BM_MAX
    for budget in (SMEM_TARGET, _k.SMEM_MAX):
        bm = top
        while bm >= 1:
            if _k.smem_bytes(algorithm, bm, n_attrs, n_nodes, jump_mode, n_classes) <= budget:
                return bm
            bm //= 2
    raise _k.TileError(
        f"no {algorithm}/{jump_mode} record tile fits N={n_nodes} nodes, "
        f"A={n_attrs} attributes and C={n_classes} classes in {_k.SMEM_MAX} B of shared memory"
    )


def _tile(records: torch.Tensor, block_m: int | None, n_nodes: int, n_attrs: int, **sizes) -> int:
    """The record tile of a launch: ``block_m`` if given, else the model's.

    CPU tensors run the kernels' plain versions, which take no tile, so
    they skip the choice and its refusal: a tree too large for a CTA is
    still evaluated on the host, as the JAX package evaluates it.
    """
    if block_m is not None:
        return block_m
    if records.device.type == "cpu":
        return 0
    return choose_block_m(n_nodes, n_attrs, **sizes)


def _check_args(algorithm: str, jump_mode: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if jump_mode not in _k.JUMP_MODES:
        raise ValueError(f"unknown jump_mode {jump_mode!r}")


def _total_jumps(max_depth: int) -> int:
    return max(1, math.ceil(math.log2(max(max_depth, 2))))


def _records(records, tables, n_attrs: int, device) -> torch.Tensor:
    records = _device.as_tensor(records, torch.float32, _device.resolve(records, device))
    if records.device != tables.device:
        raise ValueError(f"tables are on {tables.device}, records on {records.device}")
    if records.dim() != 2 or records.shape[-1] != n_attrs:
        raise ValueError(f"records must be (M, {n_attrs}), got {tuple(records.shape)}")
    return records


class PackedTree:
    """A tree's tables on the device, ready for the kernels (moved once).

    ``attr_select`` (A, N) f32 serves the one-hot form; the rest are (N,).
    """

    def __init__(self, enc: EncodedTree, n_attrs: int, *, max_depth: int | None = None, device=None):
        check_table_indices(enc.attr_idx, enc.child, enc.class_val, n_attrs)
        dev = _device.resolve(None, device)
        self.n_nodes = enc.n_nodes
        self.n_attrs = n_attrs
        self.max_depth = max_depth if max_depth is not None else tree_depth(enc)
        self.attr_select = _device.as_tensor(attr_select_matrix(enc, n_attrs), torch.float32, dev)
        self.attr_idx = _device.as_tensor(enc.attr_idx, torch.int32, dev)
        self.threshold = _device.as_tensor(enc.threshold, torch.float32, dev)
        self.child = _device.as_tensor(enc.child, torch.int32, dev)
        self.class_val = _device.as_tensor(enc.class_val, torch.int32, dev)
        self.device = self.threshold.device

    @classmethod
    def shapes_only(cls, n_nodes: int, n_attrs: int, max_depth: int, device) -> "PackedTree":
        """Tables of a tree's shapes and dtypes that hold no values: on a fake
        or meta ``device`` (a dry-run), nothing is read, built or copied."""
        self = cls.__new__(cls)
        self.n_nodes, self.n_attrs, self.max_depth = n_nodes, n_attrs, max_depth
        self.attr_select = torch.empty((n_attrs, n_nodes), dtype=torch.float32, device=device)
        self.attr_idx, self.child, self.class_val = (
            torch.empty((n_nodes,), dtype=torch.int32, device=device) for _ in range(3))
        self.threshold = torch.empty((n_nodes,), dtype=torch.float32, device=device)
        self.device = self.threshold.device
        return self


def tree_eval(
    records,
    tree: PackedTree | EncodedTree,
    *,
    n_attrs: int | None = None,
    algorithm: str = "speculative",
    jump_mode: str = "gather",
    block_m: int | None = None,
    device=None,
) -> torch.Tensor:
    """Evaluate a classification tree over a record batch with a CUDA kernel.

    Args:
      records: (M, A) float array or tensor (any float dtype; compared in f32).
      tree: an :class:`EncodedTree` (packed here) or a prebuilt
        :class:`PackedTree` on the device the records go to.
      algorithm: "speculative" (K1, Procedure 4/5) or "data_parallel" (K2,
        Procedure 3).
      jump_mode: "gather" | "onehot" node-evaluation form of K1.
      block_m: records per CTA; default from the shared-memory model.
      device: where to run; default: where ``records`` lies, else CUDA.

    Returns:
      (M,) int32 class assignments.  On CPU tensors the kernels' plain
      versions compute them.
    """
    with NULL_TRACER.span("kernel.op", cat="kernel"):
        _check_args(algorithm, jump_mode)
        if isinstance(tree, EncodedTree):
            if n_attrs is None:
                n_attrs = int(np.shape(records)[-1])
            tree = PackedTree(tree, n_attrs, device=_device.resolve(records, device))
        records = _records(records, tree, tree.n_attrs, device)
        block_m = _tile(records, block_m, tree.n_nodes, tree.n_attrs, algorithm=algorithm,
                        jump_mode=jump_mode)
        if algorithm == "data_parallel":
            return _k.data_parallel(
                records, tree.attr_idx, tree.threshold, tree.child, tree.class_val,
                max_depth=tree.max_depth, block_m=block_m,
            )
        # Both jump modes sanitize, as the JAX package's ops.tree_eval does: the
        # one-hot form multiplies every attribute (inf*0 = NaN).
        return _k.speculative(
            sanitize_records(records), tree.attr_idx, tree.attr_select, tree.threshold,
            tree.child, tree.class_val, total_jumps=_total_jumps(tree.max_depth),
            jump_mode=jump_mode, block_m=block_m,
        )


def forest_eval(records, trees: list[PackedTree], **kw) -> torch.Tensor:
    """Per-tree kernel evaluation, (T, M). Trees may have different sizes."""
    return torch.stack([tree_eval(records, t, **kw) for t in trees])


class PackedForest:
    """A stacked forest's tables on the device for the fused kernels.

    Args:
      forest: an :class:`repro_torch.core.forest.EncodedForest` — or anything
        exposing its ``n_trees`` / ``n_nodes`` / ``max_depth`` and (T, N)
        table surface.
      n_attrs: record attribute count A.
      max_depth: depth bound over the forest; default ``forest.max_depth``.
      device: where the tables go; default CUDA.
    """

    def __init__(self, forest, n_attrs: int, *, max_depth: int | None = None, device=None):
        check_table_indices(forest.attr_idx, forest.child, forest.class_val, n_attrs)
        dev = _device.resolve(None, device)
        self.n_trees = int(forest.n_trees)
        self.n_nodes = int(forest.n_nodes)
        self.n_attrs = n_attrs
        self.max_depth = int(max_depth if max_depth is not None else forest.max_depth)
        sel = np.zeros((self.n_trees, n_attrs, self.n_nodes), np.float32)
        sel[np.arange(self.n_trees)[:, None], forest.attr_idx, np.arange(self.n_nodes)] = 1
        self.attr_select = _device.as_tensor(sel, torch.float32, dev)
        self.attr_idx = _device.as_tensor(forest.attr_idx, torch.int32, dev)
        self.threshold = _device.as_tensor(forest.threshold, torch.float32, dev)
        self.child = _device.as_tensor(forest.child, torch.int32, dev)
        self.class_val = _device.as_tensor(forest.class_val, torch.int32, dev)
        self.device = self.threshold.device

    @property
    def nbytes(self) -> int:
        """Node-table bytes, ``attr_select`` included: the full-width layout
        the quantized one is measured against."""
        return packed_forest_nbytes(self)


def forest_eval_fused(
    records,
    forest: "PackedForest | object",
    *,
    n_attrs: int | None = None,
    algorithm: str = "speculative",
    jump_mode: str = "gather",
    block_m: int | None = None,
    device=None,
) -> torch.Tensor:
    """Evaluate a whole forest with one fused CUDA launch (K3 or K4).

    Args:
      records: (M, A) float array or tensor (any float dtype; compared in f32).
      forest: an ``EncodedForest`` (packed here) or a prebuilt
        :class:`PackedForest` on the device the records go to.
      algorithm: "speculative" (K3) or "data_parallel" (K4).
      jump_mode: "gather" | "onehot" node-evaluation form of K3.
      block_m: records per CTA; default from the shared-memory model.
      device: where to run; default: where ``records`` lies, else CUDA.

    Returns:
      (T, M) int32 per-tree class assignments, bit-identical to running
      :func:`tree_eval` tree by tree.
    """
    with NULL_TRACER.span("kernel.op", cat="kernel"):
        _check_args(algorithm, jump_mode)
        if not isinstance(forest, PackedForest):
            if n_attrs is None:
                n_attrs = int(np.shape(records)[-1])
            forest = PackedForest(forest, n_attrs, device=_device.resolve(records, device))
        records = _records(records, forest, forest.n_attrs, device)
        block_m = _tile(records, block_m, forest.n_nodes, forest.n_attrs, algorithm=algorithm,
                        jump_mode=jump_mode)
        if algorithm == "data_parallel":
            return _k.fused_data_parallel(
                records, forest.attr_idx, forest.threshold, forest.child, forest.class_val,
                max_depth=forest.max_depth, block_m=block_m,
            )
        return _k.fused_speculative(
            sanitize_records(records), forest.attr_idx, forest.attr_select, forest.threshold,
            forest.child, forest.class_val, total_jumps=_total_jumps(forest.max_depth),
            jump_mode=jump_mode, block_m=block_m,
        )


def forest_votes_fused(
    records,
    forest: "PackedForest | object",
    *,
    n_classes: int,
    n_attrs: int | None = None,
    algorithm: str = "speculative",
    jump_mode: str = "gather",
    block_m: int | None = None,
    device=None,
) -> torch.Tensor:
    """Accumulate the forest's class votes in one fused CUDA launch (K5 or K6).

    The per-tree classes stay inside the CTA: each tree adds its one-hot
    vote into a (block_m, C) tile in shared memory, so the (T, M) class
    matrix never reaches device memory.  This is the stage primitive of the
    cascade evaluator.

    Returns:
      (M, n_classes) int32 vote counts (a class outside ``[0, n_classes)``
      casts no vote); ``core.forest.vote_winner`` of it reproduces
      ``majority_vote`` exactly.
    """
    with NULL_TRACER.span("kernel.op", cat="kernel"):
        _check_args(algorithm, jump_mode)
        if not isinstance(forest, PackedForest):
            if n_attrs is None:
                n_attrs = int(np.shape(records)[-1])
            forest = PackedForest(forest, n_attrs, device=_device.resolve(records, device))
        records = _records(records, forest, forest.n_attrs, device)
        n_classes = int(n_classes)
        block_m = _tile(records, block_m, forest.n_nodes, forest.n_attrs, algorithm=algorithm,
                        jump_mode=jump_mode, n_classes=n_classes)
        if algorithm == "data_parallel":
            return _k.fused_votes_data_parallel(
                records, forest.attr_idx, forest.threshold, forest.child, forest.class_val,
                n_classes=n_classes, max_depth=forest.max_depth, block_m=block_m,
            )
        # Same records@S contract as forest_eval_fused (inf*0 = NaN).
        return _k.fused_votes_speculative(
            sanitize_records(records), forest.attr_idx, forest.attr_select, forest.threshold,
            forest.child, forest.class_val, n_classes=n_classes,
            total_jumps=_total_jumps(forest.max_depth), jump_mode=jump_mode, block_m=block_m,
        )


def forest_eval_fused_q(
    records,
    forest: "QuantizedForest | object",
    *,
    n_attrs: int | None = None,
    algorithm: str = "speculative",
    thr_dtype: str = "bfloat16",
    calibration=None,
    block_m: int | None = None,
    device=None,
) -> torch.Tensor:
    """Evaluate a whole forest with one fused launch over quantized tables (K7 or K8).

    The compact-layout dual of :func:`forest_eval_fused`: the node tables
    arrive as int8/int16 indices and bf16/f16 split-safe thresholds (see
    :mod:`repro_torch.kernels.tree_eval.quant`), and node evaluation gathers
    each record's attribute, so records are compared as given (no
    sanitizing: NaN goes left, ±inf compares as itself).

    Args:
      records: (M, A) float array or tensor (compared in f32 after upcast).
      forest: a prebuilt :class:`QuantizedForest` on the device the records
        go to, or an ``EncodedForest`` quantized here (``thr_dtype`` and
        ``calibration`` control the rounding; ``calibration=None``, the
        default, quantizes only thresholds whose cast round-trips exactly,
        so results are bit-exact for any input).
      algorithm: "speculative" (K7) or "data_parallel" (K8).
      block_m: records per CTA; default from the shared-memory model.
      device: where to run; default: where ``records`` lies, else CUDA.

    Returns:
      (T, M) int32 per-tree class assignments.
    """
    with NULL_TRACER.span("kernel.op", cat="kernel"):
        _check_args(algorithm, "gather")
        if not isinstance(forest, QuantizedForest):
            if n_attrs is None:
                n_attrs = int(np.shape(records)[-1])
            forest = QuantizedForest(forest, n_attrs, thr_dtype=thr_dtype, calibration=calibration,
                                     device=_device.resolve(records, device))
        records = _records(records, forest, forest.n_attrs, device)
        block_m = _tile(records, block_m, forest.n_nodes, forest.n_attrs, algorithm=algorithm)
        tables = (records, forest.attr_idx, forest.threshold, forest.child, forest.class_val)
        if algorithm == "data_parallel":
            return _k.fused_data_parallel_q(*tables, max_depth=forest.max_depth, block_m=block_m)
        return _k.fused_speculative_q(*tables, total_jumps=_total_jumps(forest.max_depth), block_m=block_m)


# ---------------------------------------------------------------------------
# Variant registry
# ---------------------------------------------------------------------------
#
# Every registered variant is a semantically identical evaluator of the
# branchless encoded tree with a uniform calling convention:
#
#     fn(records, enc: EncodedTree, *, max_depth: int, **params) -> (M,) int32
#
# ``params`` only ever contains keys named in ``tunables``.  Engine "cuda"
# runs the hand-written kernels; engine "torch" the plain tensor evaluators.


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One evaluator implementation plus the knobs a tuner may sweep.

    Attributes:
      name: registry key, e.g. ``"cuda_speculative_onehot"``.
      algorithm: "speculative" (Procedure 4/5) or "data_parallel" (Procedure 3).
      engine: "cuda" (kernel path) or "torch" (plain tensor path).
      jump_mode: node-evaluation formulation, "gather" or "onehot".
      tunables: names of the free parameters, e.g. ("block_m",).
      fn: the evaluator callable (uniform signature above).
    """

    name: str
    algorithm: str
    engine: str
    jump_mode: str
    tunables: tuple[str, ...]
    fn: Callable


VARIANTS: dict[str, VariantSpec] = {}


def register_variant(spec: VariantSpec) -> VariantSpec:
    if spec.name in VARIANTS:
        raise ValueError(f"variant {spec.name!r} already registered")
    VARIANTS[spec.name] = spec
    return spec


def get_variant(name: str) -> VariantSpec:
    try:
        return VARIANTS[name]
    except KeyError:
        raise KeyError(
            f"unknown variant {name!r}; registered: {sorted(VARIANTS)}"
        ) from None


def list_variants(*, engine: str | None = None, algorithm: str | None = None) -> list[VariantSpec]:
    out = [
        s
        for s in VARIANTS.values()
        if (engine is None or s.engine == engine)
        and (algorithm is None or s.algorithm == algorithm)
    ]
    return sorted(out, key=lambda s: s.name)


def _cuda_fn(algorithm: str, jump_mode: str) -> Callable:
    def fn(records, tree, *, max_depth=None, **params):
        # ``tree``: an EncodedTree (packed on every call) or a PackedTree a
        # caller built once on the records' device, as the tuner does.
        del max_depth  # PackedTree derives it from the encoding
        return tree_eval(
            records, tree, algorithm=algorithm, jump_mode=jump_mode,
            block_m=params.get("block_m"),
        )

    return fn


def _torch_speculative_fn(jump_mode: str) -> Callable:
    def fn(records, enc, *, max_depth, **params):
        return eval_speculative_tree(
            enc,
            records,
            max_depth=max_depth,
            jumps_per_round=int(params.get("jumps_per_round", 2)),
            use_onehot_matmul=(jump_mode == "onehot"),
        )

    return fn


def _torch_data_parallel_fn(records, enc, *, max_depth, **params):
    del params
    return eval_data_parallel_tree(enc, records, max_depth=max_depth)


_ALGORITHM_MODES = (("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather"))


def _suffix(algorithm: str, jump_mode: str) -> str:
    return f"{algorithm}_{jump_mode}" if algorithm == "speculative" else algorithm


for _alg, _jm in _ALGORITHM_MODES:
    register_variant(
        VariantSpec(
            name=f"cuda_{_suffix(_alg, _jm)}",
            algorithm=_alg,
            engine="cuda",
            jump_mode=_jm,
            tunables=("block_m",),
            fn=_cuda_fn(_alg, _jm),
        )
    )
    register_variant(
        VariantSpec(
            name=f"torch_{_suffix(_alg, _jm)}",
            algorithm=_alg,
            engine="torch",
            jump_mode=_jm,
            tunables=("jumps_per_round",) if _alg == "speculative" else (),
            fn=_torch_speculative_fn(_jm) if _alg == "speculative" else _torch_data_parallel_fn,
        )
    )


# ---------------------------------------------------------------------------
# Forest variant registry
# ---------------------------------------------------------------------------
#
# A forest variant evaluates all T trees of a stacked forest at once:
#
#     fn(records, forest, *, max_depth: int, **params) -> (T, M) int32
#
# Family "fused" is one kernel launch (K3/K4, or K7/K8 on the quantized
# layout) with the record tile resident across trees; family "batched" is
# the plain tensor evaluators with the tree axis as a batch dimension (the
# JAX package's "vmap" family).  The third family a forest tuner weighs —
# "per_tree", a vector of per-tree winners — is no single callable and lives
# in ``repro_torch.tune.dispatch.ForestTunedEvaluator``.

# Family name of the per-tree-variant-vector path; kept here so the cache
# vocabulary is defined next to the registry.
PER_TREE_FAMILY = "per_tree"


@dataclasses.dataclass(frozen=True)
class ForestVariantSpec:
    """One whole-forest evaluator plus the knobs a tuner may sweep.

    Attributes:
      name: registry key, e.g. ``"forest_fused_speculative_onehot"``.
      family: "fused" (one kernel launch) or "batched" (tree axis as a
        batch dimension of the plain evaluators).
      algorithm: "speculative" or "data_parallel".
      engine: "cuda" or "torch" (same meaning as :class:`VariantSpec`).
      jump_mode: "gather" | "onehot".
      tunables: names of the free parameters, e.g. ("block_m",).
      fn: the evaluator callable (uniform signature above).
      layout: node-table layout family: "f32" (the full-width
        :class:`PackedForest` tables) or "quant" (the compact
        :class:`QuantizedForest` layout, whose ``thr_dtype`` tunable is
        consumed when the tables are packed, not by the kernel).
    """

    name: str
    family: str
    algorithm: str
    engine: str
    jump_mode: str
    tunables: tuple[str, ...]
    fn: Callable
    layout: str = "f32"


FOREST_VARIANTS: dict[str, ForestVariantSpec] = {}


def register_forest_variant(spec: ForestVariantSpec) -> ForestVariantSpec:
    if spec.name in FOREST_VARIANTS:
        raise ValueError(f"forest variant {spec.name!r} already registered")
    FOREST_VARIANTS[spec.name] = spec
    return spec


def get_forest_variant(name: str) -> ForestVariantSpec:
    try:
        return FOREST_VARIANTS[name]
    except KeyError:
        raise KeyError(
            f"unknown forest variant {name!r}; registered: {sorted(FOREST_VARIANTS)}"
        ) from None


def list_forest_variants(
    *, engine: str | None = None, family: str | None = None
) -> list[ForestVariantSpec]:
    out = [
        s
        for s in FOREST_VARIANTS.values()
        if (engine is None or s.engine == engine)
        and (family is None or s.family == family)
    ]
    return sorted(out, key=lambda s: s.name)


def _forest_tables(forest):
    return forest.attr_idx, forest.threshold, forest.child, forest.class_val


def _batched_speculative_fn(jump_mode: str) -> Callable:
    def fn(records, forest, *, max_depth, **params):
        return eval_speculative(
            records,
            *_forest_tables(forest),
            max_depth=max_depth,
            jumps_per_round=int(params.get("jumps_per_round", 2)),
            use_onehot_matmul=(jump_mode == "onehot"),
        )

    return fn


def _batched_data_parallel_fn(records, forest, *, max_depth, **params):
    del params
    return eval_data_parallel(records, *_forest_tables(forest), max_depth=max_depth)


def _fused_fn(algorithm: str, jump_mode: str) -> Callable:
    def fn(records, forest, *, max_depth=None, **params):
        del max_depth  # PackedForest derives it from the encodings
        return forest_eval_fused(
            records, forest, algorithm=algorithm, jump_mode=jump_mode,
            block_m=params.get("block_m"),
        )

    return fn


def _fused_q_fn(algorithm: str) -> Callable:
    def fn(records, forest, *, max_depth=None, **params):
        del max_depth  # QuantizedForest derives it from the encodings
        return forest_eval_fused_q(
            records, forest, algorithm=algorithm,
            thr_dtype=params.get("thr_dtype", "bfloat16"), block_m=params.get("block_m"),
        )

    return fn


for _alg in ALGORITHMS:
    register_forest_variant(
        ForestVariantSpec(
            name=f"forest_fused_{_alg}_q",
            family="fused",
            algorithm=_alg,
            engine="cuda",
            jump_mode="gather",
            tunables=("block_m", "thr_dtype"),
            fn=_fused_q_fn(_alg),
            layout="quant",
        )
    )


for _alg, _jm in _ALGORITHM_MODES:
    register_forest_variant(
        ForestVariantSpec(
            name=f"forest_fused_{_suffix(_alg, _jm)}",
            family="fused",
            algorithm=_alg,
            engine="cuda",
            jump_mode=_jm,
            tunables=("block_m",),
            fn=_fused_fn(_alg, _jm),
        )
    )
    register_forest_variant(
        ForestVariantSpec(
            name=f"forest_batched_{_suffix(_alg, _jm)}",
            family="batched",
            algorithm=_alg,
            engine="torch",
            jump_mode=_jm,
            tunables=("jumps_per_round",) if _alg == "speculative" else (),
            fn=_batched_speculative_fn(_jm) if _alg == "speculative" else _batched_data_parallel_fn,
        )
    )
