"""Soft (differentiable) decision trees that harden to the paper's encoding.

The port's counterpart of the JAX package's ``core/soft_tree.py``.  The
tree class is the paper's, restricted to perfect trees:

  * a **perfect binary tree** of depth ``d`` with ``2^d - 1`` internal nodes;
  * internal node ``n`` tests *one scalar feature* ``z_n`` against threshold
    ``t_n`` — axis-aligned, the paper's §2.1 tree definition.  For router
    use, ``z = x @ W`` first projects the hidden state to one feature per
    internal node, so node ``n`` tests feature ``n`` (attr_idx = node id);
  * TRAIN: gate ``g_n = σ((z_n - t_n)/τ)``, leaf probability = product of
    gate terms along the root→leaf path (computed in closed form below);
  * SERVE: harden — take the sign of ``z_n - t_n`` — and emit an
    :class:`~repro_torch.core.tree.EncodedTree` evaluated by Procedure 4/5
    (K1 on the card).

Shapes: depth d, I = 2^d - 1 internal nodes, L = 2^d leaves.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import BOTTOM, EncodedTree


@dataclasses.dataclass(frozen=True)
class SoftTreeConfig:
    depth: int
    in_features: int          # feature dim of the projection input
    n_outputs: int            # leaves map onto this many classes/experts
    temperature: float = 1.0
    dtype: torch.dtype = torch.float32

    @property
    def n_internal(self) -> int:
        return 2**self.depth - 1

    @property
    def n_leaves(self) -> int:
        return 2**self.depth


class SoftTreeParams(NamedTuple):
    proj: torch.Tensor       # (in_features, I) — one learned feature per node
    threshold: torch.Tensor  # (I,)
    leaf_map: torch.Tensor   # (L,) int — leaf → output id (static, non-learned)


def init_soft_tree(cfg: SoftTreeConfig, generator: torch.Generator, device=None) -> SoftTreeParams:
    """Fan-in normal projection, zero thresholds, leaves cycling over outputs.

    ``device`` defaults to the card; ``generator`` must live there.
    """
    from repro_torch import _device

    dev = _device.resolve(None, device)
    scale = 1.0 / np.sqrt(cfg.in_features)
    proj = torch.randn((cfg.in_features, cfg.n_internal), generator=generator, dtype=cfg.dtype,
                       device=dev) * scale
    threshold = torch.zeros((cfg.n_internal,), dtype=cfg.dtype, device=dev)
    # leaves cycle over outputs; for n_leaves == n_outputs this is identity.
    leaf_map = torch.arange(cfg.n_leaves, dtype=torch.int32, device=dev) % cfg.n_outputs
    return SoftTreeParams(proj, threshold, leaf_map)


def _paths(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (L, d) tables: internal-node index and branch bit along each
    root→leaf path of a perfect tree in breadth-first numbering.

    BFS numbering of a perfect tree: internal node n has children 2n+1, 2n+2;
    leaves occupy [I, I+L).  Leaf ℓ's path is read from the bits of ℓ.
    """
    n_leaves = 2**depth
    node_idx = np.zeros((n_leaves, depth), np.int32)
    branch = np.zeros((n_leaves, depth), np.int32)
    for leaf in range(n_leaves):
        n = 0
        for lvl in range(depth):
            bit = (leaf >> (depth - 1 - lvl)) & 1
            node_idx[leaf, lvl] = n
            branch[leaf, lvl] = bit
            n = 2 * n + 1 + bit
    return node_idx, branch


def leaf_probs(cfg: SoftTreeConfig, params: SoftTreeParams, x: torch.Tensor) -> torch.Tensor:
    """Soft leaf distribution, shape (..., L).

    ``g_n = σ((z_n - t_n)/τ)`` is the probability of branching *right*
    (matching the paper's ``r_a > t`` → right predicate); leaf probability is
    the product over its path — computed as a sum of log-gates for stability.
    """
    z = x @ params.proj  # (..., I)
    logits = (z - params.threshold) / cfg.temperature
    log_right = torch.nn.functional.logsigmoid(logits)    # log σ(u)
    log_left = torch.nn.functional.logsigmoid(-logits)    # log σ(-u) = log(1-σ(u))
    node_idx, branch = _paths(cfg.depth)
    node_idx = torch.from_numpy(node_idx).long().to(x.device)
    branch = torch.from_numpy(branch).bool().to(x.device)
    lr = log_right[..., node_idx]  # (..., L, d)
    ll = log_left[..., node_idx]
    log_p = torch.where(branch, lr, ll).sum(dim=-1)  # (..., L)
    return torch.exp(log_p)


def output_probs(cfg: SoftTreeConfig, params: SoftTreeParams, x: torch.Tensor) -> torch.Tensor:
    """Soft output distribution over ``n_outputs`` (sums leaf probs per output)."""
    lp = leaf_probs(cfg, params, x)  # (..., L)
    onehot = torch.nn.functional.one_hot(params.leaf_map.long(), cfg.n_outputs).to(lp.dtype)  # (L, O)
    return lp @ onehot


def harden(cfg: SoftTreeConfig, params: SoftTreeParams) -> EncodedTree:
    """Freeze a trained soft tree into the paper's branchless encoding.

    The emitted tree's "records" are the projected features ``z = x @ proj``
    (A = I attributes, attr_idx[n] = n for internal nodes): evaluate
    ``z`` with ``ops.tree_eval`` (or any port evaluator) to serve it.  Only
    ``threshold`` and ``leaf_map`` are read, on the host.
    """
    n_int, n_leaf = cfg.n_internal, cfg.n_leaves
    n = n_int + n_leaf
    attr_idx = np.zeros((n,), np.int32)
    threshold = np.full((n,), np.inf, np.float32)
    child = np.arange(n, dtype=np.int32)  # leaves default to self-loop
    class_val = np.full((n,), BOTTOM, np.int32)
    thr = torch.as_tensor(params.threshold).detach().to("cpu", torch.float32).numpy()
    lmap = torch.as_tensor(params.leaf_map).detach().to("cpu", torch.int32).numpy()
    for i in range(n_int):
        attr_idx[i] = i          # node i tests projected feature i
        threshold[i] = thr[i]
        child[i] = 2 * i + 1     # perfect-tree BFS: right = left + 1 holds
    for leaf in range(n_leaf):
        class_val[n_int + leaf] = lmap[leaf]
    # With children 2i+1/2i+2 the layout of a perfect tree is exactly
    # breadth-first and leaves occupy [I, I+L): the encoding is valid as-is.
    return EncodedTree(attr_idx, threshold, child, class_val)


def load_balance_loss(leaf_p: torch.Tensor) -> torch.Tensor:
    """Encourage uniform leaf usage (Switch-style aux loss over the batch)."""
    mean_p = leaf_p.reshape(-1, leaf_p.shape[-1]).mean(dim=0)
    n = mean_p.shape[-1]
    return n * torch.sum(mean_p * mean_p)
