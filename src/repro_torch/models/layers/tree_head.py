"""Tree token-classification head: the paper's image segmentation moved to
tokens and frames.

The port's counterpart of the JAX package's ``models/layers/tree_head.py``.
A per-token classifier behind a backbone: the hidden state is projected to
one scalar feature per internal node of a perfect tree (``z = x @ proj``).
In training the head is a soft decision tree (:mod:`repro_torch.core.
soft_tree`, cross-entropy over the leaves' class probabilities); to serve,
the tree hardens into the paper's breadth-first encoding and every token is
classified by the speculative evaluator: K1 in its one-hot form on the
card (``ops.tree_eval(z, packed, algorithm="speculative",
jump_mode="onehot")``), K1's plain version on CPU tensors.  Records are
tokens, A = 2^d − 1 features, N = 2^(d+1) − 1 nodes; leaf ℓ answers class
``ℓ mod n_classes``.

As in the JAX package no model attaches the head: it is a module of its
own (weights ``proj`` (D, A) and ``thr`` (A,), both f32).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import soft_tree as st
from repro_torch.kernels.tree_eval import ops
from repro_torch.models.layers.moe import router_features
from repro_torch.models.schema import PSpec
from repro_torch.parallel.sharding import P


def tree_head_depth(n_classes: int) -> int:
    d = 1
    while (1 << d) < n_classes:
        d += 1
    return d


def tree_head_schema(cfg: ModelConfig) -> dict:
    n_internal = (1 << tree_head_depth(cfg.tree_head_classes)) - 1
    return {
        "proj": PSpec((cfg.d_model, n_internal), P(None, None), dtype=torch.float32),
        "thr": PSpec((n_internal,), P(None), init="zeros", dtype=torch.float32),
    }


def _tree_cfg(cfg: ModelConfig) -> st.SoftTreeConfig:
    return st.SoftTreeConfig(depth=tree_head_depth(cfg.tree_head_classes), in_features=cfg.d_model,
                             n_outputs=cfg.tree_head_classes)


def _params(cfg: ModelConfig, params: dict, device) -> st.SoftTreeParams:
    n_leaves = 1 << tree_head_depth(cfg.tree_head_classes)
    leaf_map = torch.arange(n_leaves, dtype=torch.int32, device=device) % cfg.tree_head_classes
    return st.SoftTreeParams(proj=params["proj"], threshold=params["thr"], leaf_map=leaf_map)


def tree_head_probs(params: dict, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    """Soft (training) path: (..., n_classes) class probabilities."""
    return st.output_probs(_tree_cfg(cfg), _params(cfg, params, x.device), x.float())


def tree_head_loss(params: dict, x: torch.Tensor, labels: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over the soft tree's class distribution; labels < 0 masked."""
    logp = torch.log(torch.clamp(tree_head_probs(params, x, cfg=cfg), min=1e-9))
    gold = torch.gather(logp, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return -(gold * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def pack_tree_head(cfg: ModelConfig, thr: torch.Tensor) -> ops.PackedTree:
    """The hardened head's tables on ``thr``'s device, for K1 (``thr`` is read
    to the host once): what :func:`tree_head_classify` evaluates."""
    depth = tree_head_depth(cfg.tree_head_classes)
    enc = st.harden(_tree_cfg(cfg), _params(cfg, {"proj": None, "thr": thr}, "cpu"))
    return ops.PackedTree(enc, (1 << depth) - 1, max_depth=depth, device=thr.device)


def tree_head_classify(params: dict, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    """Serving path: the hardened tree over every token through one
    ``ops.tree_eval`` call (K1 onehot on the card).

    The tables are built in the call from ``params["thr"]``, as the JAX
    function builds them.  ``z = x @ proj`` is a full-f32 product (no TF32).
    Returns int32 class ids with the leading shape of ``x``.
    """
    packed = pack_tree_head(cfg, params["thr"])
    z = router_features(x, params["proj"])
    out = ops.tree_eval(z.reshape(-1, z.shape[-1]), packed, algorithm="speculative", jump_mode="onehot")
    return out.reshape(x.shape[:-1])
