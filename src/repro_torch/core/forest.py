"""Random-forest evaluation (Sharp's extension, paper §1) + top-k routing.

Per-tree encodings are padded to one node count and stacked into (T, N)
tables; the forest is evaluated with the tree axis as a batch dimension of
the paper's evaluators (the JAX package ``vmap``s over it).

Forests serve two roles:
  1. classic majority-vote classification (the paper's lineage), and
  2. **top-k expert routing**: a forest of k trees where tree ``j`` emits the
     j-th expert choice for each token.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.eval_speculative import eval_speculative
from repro_torch.core.tree import (
    EncodedTree,
    Node,
    _checked_tables,
    breadth_first_encode,
    pad_tree,
    tree_depth,
)
from repro_torch.obs.trace import NULL_TRACER


class EncodedForest:
    """T trees padded to a common node count and stacked (numpy, on the host)."""

    def __init__(self, trees: Sequence[EncodedTree]):
        if not trees:
            raise ValueError("empty forest")
        n_pad = max(t.n_nodes for t in trees)
        padded = [pad_tree(t, n_pad) for t in trees]
        self.n_trees = len(trees)
        self.n_nodes = n_pad
        self.max_depth = max(tree_depth(t) for t in trees)
        self.attr_idx = np.stack([p.attr_idx for p in padded])  # (T, N)
        self.threshold = np.stack([p.threshold for p in padded])
        self.child = np.stack([p.child for p in padded])
        self.class_val = np.stack([p.class_val for p in padded])

    @classmethod
    def from_nodes(cls, roots: Sequence[Node]) -> "EncodedForest":
        return cls([breadth_first_encode(r) for r in roots])

    @classmethod
    def from_arrays(cls, attr_idx, threshold, child, class_val) -> "EncodedForest":
        """Carry a stacked forest across as (T, N) numpy tables.

        Dtypes must be int32/float32/int32/int32; ``max_depth`` is recomputed
        from the tables.
        """
        tables = _checked_tables((attr_idx, threshold, child, class_val), ndim=2)
        return cls([EncodedTree(*(t[i] for t in tables)) for i in range(tables[0].shape[0])])

    def tree(self, i: int) -> EncodedTree:
        """Recover tree ``i`` as a standalone (padded) encoding."""
        return EncodedTree(
            self.attr_idx[i], self.threshold[i], self.child[i], self.class_val[i]
        )


def eval_forest(
    forest: EncodedForest,
    records,
    *,
    jumps_per_round: int = 2,
    use_onehot_matmul: bool = True,
    device=None,
) -> torch.Tensor:
    """Per-tree class assignments, shape (T, M), via the speculative evaluator."""
    return eval_speculative(
        records,
        forest.attr_idx,
        forest.threshold,
        forest.child,
        forest.class_val,
        max_depth=forest.max_depth,
        jumps_per_round=jumps_per_round,
        use_onehot_matmul=use_onehot_matmul,
        device=device,
    )


def eval_forest_tuned(
    forest: "EncodedForest | Sequence[EncodedTree]",
    records,
    *,
    cache=None,
    autotune: bool = False,
    engines: tuple[str, ...] | None = None,
    families: tuple[str, ...] | None = None,
    layouts: tuple[str, ...] | None = None,
    device=None,
) -> torch.Tensor:
    """Per-tree class assignments, shape (T, M), via forest-level dispatch.

    The whole call resolves through :class:`repro_torch.tune.ForestTunedEvaluator`
    as one unit: the (T, M, N_max, A, depth-profile) bucket picks between
    per-tree variant vectors, the shared-variant batched path, and the fused
    kernels that evaluate the forest in one launch.  With ``autotune=True``
    the first sight of a bucket measures all three families and persists the
    winner.  Every family is exact, so the choice never changes results —
    bit-identical to evaluating each tree with ``eval_serial``.
    ``layouts=("f32", "quant")`` opts the quantized node tables into the
    competition (still exact: dispatch builds universal-mode layouts only).
    ``device``: where to run; default where ``records`` lies, else CUDA.
    """
    from repro_torch.tune import ForestTunedEvaluator

    return ForestTunedEvaluator(
        forest, cache=cache, autotune=autotune, engines=engines,
        families=families, layouts=layouts, device=device,
    )(records)


def eval_forest_sharded(
    forest: "EncodedForest | Sequence[EncodedTree]",
    records,
    *,
    mesh=None,
    plan=None,
    decomposition: str | None = None,
    devices=None,
    cache=None,
    autotune: bool = False,
    engines: tuple[str, ...] | None = None,
) -> torch.Tensor:
    """Per-tree class assignments, shape (T, M), across a device grid.

    The :mod:`repro_torch.dist` planner picks a record-/tree-/hybrid-sharded
    decomposition (or honours an explicit ``plan``/``mesh``/
    ``decomposition``), the executor walks it over the grid's devices, and
    each shard's kernel is still selected through ``repro_torch.tune``.
    Exact: results bit-match :func:`eval_forest_tuned` for every plan; on a
    single device this *is* the plain tuned path.  ``devices`` (default every
    card; ``("cpu",)`` for the host) names what the planner may use; a
    ``mesh`` fixes the grid.  The result lies on the grid's first device.
    """
    from repro_torch.dist import ShardedForestEvaluator

    return ShardedForestEvaluator(
        forest,
        mesh=mesh,
        plan=plan,
        decomposition=decomposition,
        devices=devices,
        cache=cache,
        autotune=autotune,
        engines=engines,
    )(records)


def eval_forest_cascade(
    forest: EncodedForest,
    records,
    *,
    n_classes: int,
    stages: int = 2,
    bound: float | None = 1.0,
    plan=None,
    calibration=None,
    engine: str | None = None,
    deadline_ms: float | None = None,
    registry=None,
    tracer=None,
    device=None,
):
    """Staged early-exit majority vote — the forest-scale dual of speculation.

    Trees are evaluated in stages (most discriminative first); records whose
    vote margin already exceeds ``bound`` times the remaining tree count exit
    early, and the survivors are compacted on the device between stages.
    With ``bound=None`` every tree runs and the classes equal
    ``majority_vote`` of the whole forest; with ``bound=1.0`` the exits are
    provably unable to change the answer, so the classes still match exactly
    while easy records skip most of the forest.

    Returns a :class:`repro_torch.kernels.tree_eval.CascadeResult` — classes
    plus per-record margin, trees evaluated, exit stage and confidence.
    """
    from repro_torch.kernels.tree_eval import eval_cascade

    return eval_cascade(
        forest,
        records,
        n_classes=n_classes,
        stages=stages,
        bound=bound,
        plan=plan,
        calibration=calibration,
        engine=engine,
        deadline_ms=deadline_ms,
        registry=registry,
        tracer=tracer,
        device=device,
    )


def vote_counts(per_tree: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(T, M) per-tree classes → (M, n_classes) int32 votes.

    Classes outside ``[0, n_classes)`` cast no vote.
    """
    classes = torch.arange(n_classes, device=per_tree.device, dtype=per_tree.dtype)
    return (per_tree[..., None] == classes).sum(0, dtype=torch.int32)


def vote_winner(votes: torch.Tensor) -> torch.Tensor:
    """(M, C) vote counts → (M,) int32 class with the most votes.

    Ties go to the lowest class (as ``jnp.argmax`` and ``np.argmax`` pick the
    first maximum).  The rule is built into the key — ``votes·C + (C-1-c)``
    has one maximum per record — so it does not rest on how ``argmax``
    breaks ties on a device.
    """
    c = votes.shape[-1]
    classes = torch.arange(c, device=votes.device)
    key = votes.long() * c + (c - 1 - classes)
    return key.argmax(-1).to(torch.int32)


def majority_vote(per_tree, n_classes: int, *, device=None) -> torch.Tensor:
    """(T, M) per-tree classes → (M,) majority class, int32.

    Ties go to the lowest class (:func:`vote_winner`).  Classes outside
    ``[0, n_classes)`` cast no vote.
    """
    with NULL_TRACER.span("forest.vote", cat="forest"):
        dev = _device.resolve(per_tree, device)
        per_tree = _device.as_tensor(per_tree, torch.int64, dev)
        return vote_winner(vote_counts(per_tree, n_classes))


def route_topk(per_tree: torch.Tensor) -> torch.Tensor:
    """(k, M) per-tree expert picks → (M, k) routing table (may repeat)."""
    return per_tree.T
