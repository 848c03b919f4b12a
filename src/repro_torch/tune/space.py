"""Workload shapes, shape bucketing, and the candidate search space.

A *workload shape* is the 4-tuple the paper's §4 runtime model is written
over: record count M, node count N, attribute count A and tree depth d.
Candidates are (variant, params) pairs drawn from the kernel variant
registry (:mod:`repro_torch.kernels.tree_eval.ops`); :func:`search_space`
enumerates only the candidates that are *valid* for a given shape.

Shapes are *bucketed* before they key the cache, exactly as in the JAX
package: M rounds up to a power of two, N and A round up to 128, and depth
to the next power of two.  Bucketing trades a little optimality near bucket
edges for cache hits across the jitter of real request sizes — the same
reason the serve engine pads waves.

The record tile (``block_m``) of a kernel candidate is sized at the
bucket's *upper* N and A, from the kernels' own shared-memory model
(``ops.choose_block_m`` and ``kernel.smem_bytes``), so every candidate fits
every tree of its bucket on the card; a variant none of whose tiles fits is
left out of the space.

Forest-level tuning adds :class:`ForestShape` — the (T, M, N_max, A,
depth-profile) operating point of a whole forest call — and
:func:`forest_search_space`, which enumerates the three candidate families
(per-tree variant vectors, the shared-variant batched path, and the fused
one-launch kernels) that :class:`repro_torch.tune.ForestTunedEvaluator`
ranks.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Iterator

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.tree import tree_depth
from repro_torch.kernels.tree_eval import kernel as _k
from repro_torch.kernels.tree_eval.cascade import (
    MAJORITY_FAMILY,
    exit_enabling_prefix,
    list_cascade_variants,
)
from repro_torch.kernels.tree_eval.ops import (
    DATA_PARALLEL_BM_MAX,
    PER_TREE_FAMILY,
    SPECULATIVE_BM_MAX,
    ForestVariantSpec,
    VariantSpec,
    choose_block_m,
    list_forest_variants,
    list_variants,
)

# Bucket granularity of N and A: the JAX package's lane width, kept so that
# both packages bucket one shape alike.
LANE = 128

# The torch engine's one-hot form materialises an (M, N) matmul against an
# (A, N) selection matrix; past this node count the matmul work dwarfs the
# gather it replaces (the JAX package's rule for its plain one-hot path).
# The kernels' limit is their tile's fit instead (``_block_m_grid``).
MAX_ONEHOT_NODES = 2048

# Threshold dtypes the quantized-layout candidates sweep.  The dtype is a
# cache-identity parameter (consumed when the QuantizedForest packs), so
# winners tuned at different node dtypes never collide in the cache.
QUANT_THR_DTYPES = ("bfloat16", "float16")


def _next_pow2(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@functools.lru_cache(maxsize=None)
def _device_tag(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, count = dev.type, 1
    kind = re.sub(r"[^0-9A-Za-z_.-]+", "_", str(kind)).strip("_").lower()
    return f"{dev.type}:{kind}:x{count}"


def backend_tag(device=None) -> str:
    """Device type + device kind + topology tag for cache keys.

    ``cuda:<device name>:x<device count>`` for a CUDA device (the name
    sanitized, e.g. ``cuda:nvidia_h100_80gb_hbm3:x1``), ``cpu:cpu:x1`` for
    the host.  A winner tuned on one card class may lose on another, so one
    shared cache file keeps every machine class's rows apart.  ``device``
    is the evaluator's device; default CUDA.
    """
    dev = _device.resolve(None, device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_tag(str(dev) if dev.type == "cuda" else dev.type)


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The (M, N, A, depth) operating point of one tree-eval call."""

    m: int        # records
    n_nodes: int  # tree nodes (unpadded)
    n_attrs: int  # record attributes
    depth: int    # max root→leaf depth (edges)

    def bucket(self) -> "WorkloadShape":
        """Quantise to the cache-key granularity (idempotent)."""
        return WorkloadShape(
            m=_next_pow2(self.m),
            n_nodes=_round_up(max(self.n_nodes, 1), LANE),
            n_attrs=_round_up(max(self.n_attrs, 1), LANE),
            depth=_next_pow2(self.depth),
        )

    def key(self, backend: str | None = None) -> str:
        """Stable cache key: backend/topology tag + bucketed shape.

        ``backend`` defaults to :func:`backend_tag` of the card.
        """
        b = self.bucket()
        tag = backend if backend is not None else backend_tag()
        return f"{tag}|M{b.m}|N{b.n_nodes}|A{b.n_attrs}|d{b.depth}"

    @classmethod
    def of(cls, records, enc, depth: int | None = None) -> "WorkloadShape":
        shape = records.shape if hasattr(records, "shape") else np.shape(records)
        return cls(
            m=int(shape[0]),
            n_nodes=int(enc.n_nodes),
            n_attrs=int(shape[1]),
            depth=int(depth if depth is not None else max(tree_depth(enc), 1)),
        )


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A concrete (variant, parameter assignment) the tuner can time."""

    variant: str
    params: tuple[tuple[str, object], ...] = ()

    @property
    def param_dict(self) -> dict:
        return dict(self.params)

    @classmethod
    def make(cls, variant: str, **params) -> "Candidate":
        return cls(variant=variant, params=tuple(sorted(params.items())))


def tile_fits(algorithm: str, block_m: int, n_nodes: int, n_attrs: int,
              jump_mode: str = "gather", n_classes: int = 0) -> bool:
    """Whether a ``block_m`` record tile of the kernels fits a CTA at this shape.

    One tree's tables at least (``kernel.smem_bytes`` stages more only while
    they fit), so a tile that fits here fits any forest of such trees.
    """
    top = DATA_PARALLEL_BM_MAX if algorithm == "data_parallel" else SPECULATIVE_BM_MAX
    if not 1 <= block_m <= top:
        return False
    need = _k.smem_bytes(algorithm, block_m, n_attrs, n_nodes, jump_mode, n_classes)
    return need <= _k.SMEM_MAX


def _block_m_grid(shape: WorkloadShape, algorithm: str, jump_mode: str,
                  n_classes: int = 0) -> list[int]:
    """The shared-memory model's tile plus its power-of-two neighbours.

    Sized at the bucket's upper N and A, so each tile fits every tree of the
    bucket; empty when no tile fits.
    """
    b = shape.bucket()
    try:
        base = choose_block_m(b.n_nodes, b.n_attrs, algorithm=algorithm,
                              jump_mode=jump_mode, n_classes=n_classes)
    except _k.TileError:
        return []
    top = DATA_PARALLEL_BM_MAX if algorithm == "data_parallel" else SPECULATIVE_BM_MAX
    grid = {base, max(base // 2, 1), min(base * 2, top)}
    return sorted(bm for bm in grid
                  if tile_fits(algorithm, bm, b.n_nodes, b.n_attrs, jump_mode, n_classes))


def _jumps_grid(shape: WorkloadShape) -> list[int]:
    """Procedure-5 multi-jump factors worth trying (paper found 2 optimal)."""
    if shape.depth <= 2:
        return [1]
    return [1, 2, 3]


def default_engines(device=None) -> tuple[str, ...]:
    """Engines worth timing on ``device``.

    On the card only the hand-written kernels (``cuda``): the plain torch
    evaluators enter the space there only when a caller names ``torch``.
    On the host the ``cuda`` variants would run the kernels' plain versions,
    so only the ``torch`` evaluators do.
    """
    dev = torch.device("cuda" if device is None else device)
    return ("cuda",) if dev.type == "cuda" else ("torch",)


def variant_valid(spec: VariantSpec, shape: WorkloadShape) -> bool:
    """Whether ``spec`` is worth timing at ``shape``.

    A kernel variant needs a tile that fits at the bucket's upper N and A;
    the torch engine's one-hot form stops at ``MAX_ONEHOT_NODES``.
    """
    if spec.engine == "cuda":
        return bool(_block_m_grid(shape, spec.algorithm, spec.jump_mode))
    return not (spec.jump_mode == "onehot" and shape.n_nodes > MAX_ONEHOT_NODES)


def search_space(
    shape: WorkloadShape,
    *,
    engines: tuple[str, ...] | None = None,
    device=None,
) -> Iterator[Candidate]:
    """Enumerate every candidate valid for ``shape``, cheapest-grid first.

    Args:
      shape: the (M, N, A, depth) operating point to tune for.
      engines: permitted engines ("cuda"/"torch"); default
        :func:`default_engines` of ``device``.

    Yields:
      :class:`Candidate` values — each registered variant crossed with its
      tunable-parameter grid (block_m from the shared-memory model ± a power
      of two, jumps_per_round from the Procedure-5 grid).
    """
    engines = default_engines(device) if engines is None else tuple(engines)
    for spec in list_variants():
        if spec.engine not in engines or not variant_valid(spec, shape):
            continue
        if "block_m" in spec.tunables:
            for bm in _block_m_grid(shape, spec.algorithm, spec.jump_mode):
                yield Candidate.make(spec.name, block_m=bm)
        elif "jumps_per_round" in spec.tunables:
            for j in _jumps_grid(shape):
                yield Candidate.make(spec.name, jumps_per_round=j)
        else:
            yield Candidate.make(spec.name)


# ---------------------------------------------------------------------------
# Forest-level shapes and candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ForestShape:
    """The (T, M, N_max, A, depth profile) operating point of one forest call.

    The depth *profile* — (depth_min, depth_max) over the forest's trees —
    is what distinguishes forest buckets from a per-tree
    :class:`WorkloadShape`: a homogeneous profile favours the stacked
    families (padding every tree to the common geometry is free), a spread
    profile charges the stacked families ``depth_max`` rounds for trees that
    would finish in ``depth_min``.
    """

    t: int          # trees
    m: int          # records
    n_nodes: int    # common (padded) node count per tree — N_max
    n_attrs: int    # record attributes
    depth_min: int  # shallowest tree's max root→leaf depth (edges)
    depth_max: int  # deepest tree's max root→leaf depth (edges)

    def bucket(self) -> "ForestShape":
        """Quantise to the cache-key granularity (idempotent)."""
        return ForestShape(
            t=_next_pow2(self.t),
            m=_next_pow2(self.m),
            n_nodes=_round_up(max(self.n_nodes, 1), LANE),
            n_attrs=_round_up(max(self.n_attrs, 1), LANE),
            depth_min=_next_pow2(self.depth_min),
            depth_max=_next_pow2(self.depth_max),
        )

    def key(self, backend: str | None = None) -> str:
        """Stable cache key for the forest bucket (disjoint from tree keys)."""
        b = self.bucket()
        tag = backend if backend is not None else backend_tag()
        return f"{tag}|T{b.t}|M{b.m}|N{b.n_nodes}|A{b.n_attrs}|d{b.depth_min}-{b.depth_max}"

    def tree_shape(self) -> WorkloadShape:
        """The padded common geometry as a per-tree shape (heuristic input)."""
        return WorkloadShape(
            m=self.m, n_nodes=self.n_nodes, n_attrs=self.n_attrs, depth=self.depth_max
        )

    def classes_key(self, n_classes: int, backend: str | None = None) -> str:
        """Cache key for the *class-level* (majority/cascade) bucket: the
        forest key suffixed with the class count."""
        return f"{self.key(backend)}|C{int(n_classes)}"

    @classmethod
    def of(
        cls,
        records,
        forest,
        *,
        depth_min: int | None = None,
        depth_max: int | None = None,
    ) -> "ForestShape":
        """Derive the shape from a record batch + EncodedForest.

        Per-tree depths cost an O(T·N) host pass; callers that hold a
        resolved evaluator (which computes them once) pass them in.
        """
        shape = records.shape if hasattr(records, "shape") else np.shape(records)
        if depth_min is None or depth_max is None:
            depths = [max(tree_depth(forest.tree(i)), 1) for i in range(forest.n_trees)]
            depth_min = min(depths) if depth_min is None else depth_min
            depth_max = max(depths) if depth_max is None else depth_max
        return cls(
            t=int(forest.n_trees),
            m=int(shape[0]),
            n_nodes=int(forest.n_nodes),
            n_attrs=int(shape[1]),
            depth_min=int(depth_min),
            depth_max=int(depth_max),
        )


def forest_variant_valid(spec: ForestVariantSpec, shape: ForestShape) -> bool:
    """:func:`variant_valid` at the forest's padded common tree geometry."""
    return variant_valid(spec, shape.tree_shape())


def forest_search_space(
    shape: ForestShape,
    *,
    engines: tuple[str, ...] | None = None,
    families: tuple[str, ...] | None = None,
    layouts: tuple[str, ...] | None = None,
    device=None,
) -> Iterator[Candidate]:
    """Enumerate every forest candidate valid for ``shape``.

    Three families compete:

      * ``per_tree`` — each tree dispatches through its own per-tree winner
        (a variant *vector*, represented by the sentinel candidate
        ``Candidate(PER_TREE_FAMILY)``);
      * ``batched`` — one shared variant, the plain evaluators with the tree
        axis as a batch dimension (the JAX package's ``vmap``);
      * ``fused`` — one kernel launch for the whole forest (K3/K4, or K7/K8
        on the quantized layout).

    ``families`` restricts the enumeration.  ``layouts`` gates the node-table
    layouts: the default ``("f32",)`` keeps the full-width tables; opting in
    with ``("f32", "quant")`` adds the :class:`QuantizedForest` candidates,
    crossed over :data:`QUANT_THR_DTYPES` (the threshold dtype is part of
    the candidate — and therefore cache — identity).
    """
    engines = default_engines(device) if engines is None else tuple(engines)
    families = ("per_tree", "batched", "fused") if families is None else tuple(families)
    layouts = ("f32",) if layouts is None else tuple(layouts)
    if PER_TREE_FAMILY in families and "f32" in layouts:
        yield Candidate.make(PER_TREE_FAMILY)
    tshape = shape.tree_shape()
    for spec in list_forest_variants():
        if (
            spec.family not in families
            or spec.engine not in engines
            or spec.layout not in layouts
            or not forest_variant_valid(spec, shape)
        ):
            continue
        if "thr_dtype" in spec.tunables:
            for td in QUANT_THR_DTYPES:
                for bm in _block_m_grid(tshape, spec.algorithm, spec.jump_mode):
                    yield Candidate.make(spec.name, block_m=bm, thr_dtype=td)
        elif "block_m" in spec.tunables:
            for bm in _block_m_grid(tshape, spec.algorithm, spec.jump_mode):
                yield Candidate.make(spec.name, block_m=bm)
        elif "jumps_per_round" in spec.tunables:
            for j in _jumps_grid(tshape):
                yield Candidate.make(spec.name, jumps_per_round=j)
        else:
            yield Candidate.make(spec.name)


# ---------------------------------------------------------------------------
# Class-level (majority / cascade) candidates
# ---------------------------------------------------------------------------


def cascade_stage_grid(shape: ForestShape) -> list[int]:
    """Stage counts worth timing for a ``shape.t``-tree forest.

    A cascade needs the exit-enabling first stage (``k_min`` trees at
    bound 1.0) *plus* at least one later stage the exits can skip, so
    forests with fewer than 3 trees admit no useful cascade.
    """
    t = int(shape.t)
    if t < 3:
        return []
    k_min = exit_enabling_prefix(t, 1.0)
    rest = t - k_min
    if rest < 1:
        return []
    return [s for s in (2, 3, 4) if s - 1 <= rest]


def cascade_search_space(
    shape: ForestShape,
    n_classes: int,
    *,
    engines: tuple[str, ...] | None = None,
    device=None,
) -> Iterator[Candidate]:
    """Enumerate class-level candidates: full majority vote vs cascades.

    The baseline sentinel ``Candidate(MAJORITY_FAMILY)`` routes through the
    forest-level winner (all T trees) followed by ``majority_vote``; the
    cascade candidates cross each registered cascade variant with the stage
    grid (× the vote kernels' tile grid for the cuda engine, sized with the
    (block_m, C) vote tile).  Every candidate is exact at bound 1.0, so the
    class-level choice never changes results.
    """
    engines = default_engines(device) if engines is None else tuple(engines)
    yield Candidate.make(MAJORITY_FAMILY)
    stage_grid = cascade_stage_grid(shape)
    if not stage_grid:
        return
    tshape = shape.tree_shape()
    c = max(int(n_classes), 2)
    for spec in list_cascade_variants():
        if spec.engine not in engines:
            continue
        grid = _block_m_grid(tshape, spec.algorithm, spec.jump_mode, c) if spec.engine == "cuda" else []
        if spec.engine == "cuda" and not grid:
            continue
        if spec.engine == "torch" and spec.jump_mode == "onehot" and shape.n_nodes > MAX_ONEHOT_NODES:
            continue
        for s in stage_grid:
            if "block_m" in spec.tunables:
                for bm in grid:
                    yield Candidate.make(spec.name, stages=s, block_m=bm)
            else:
                yield Candidate.make(spec.name, stages=s)
