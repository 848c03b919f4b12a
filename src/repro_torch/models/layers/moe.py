"""Mixture-of-Experts layer: GShard-style capacity dispatch and the paper's
**tree router**, on one device.

The port's counterpart of the JAX package's ``models/layers/moe.py``.

Routing options
---------------
``router="softmax"``  — learned linear router, top-k of softmax probs.
``router="tree"``     — a *soft decision tree* (:mod:`repro_torch.core.soft_tree`)
  over a learned projection of the hidden state gives the expert
  distribution in training; when serving, the tree is **hardened** into the
  paper's breadth-first encoding and each token's expert is found with the
  speculative evaluator (Procedure 4/5): on the card, kernel K1 in its
  one-hot form (``ops.tree_eval(z, packed, algorithm="speculative",
  jump_mode="onehot")``), on CPU tensors K1's plain version.  Records are
  tokens, A = 2^d − 1 projected features, N = 2^(d+1) − 1 nodes.

The hardened tables are packed once, when weights are loaded
(:meth:`TreeRouter.pack`), where the JAX code rebuilds them in every traced
call: eager torch would pay a host build and a host-to-device copy per layer
per step.  A pack records the version of the ``router_thr`` tensor it was
built from; once training (or any in-place write) moves the thresholds, the
router raises instead of routing on stale tables, until it is packed again.
``z = x @ router_proj`` stays a full-f32 product (no TF32): a TF32 ``z``
would route tokens differently.

Dispatch
--------
Tokens are processed in fixed-size groups (``group_size``); each group
builds a dense (g, E, C) dispatch/combine tensor (GShard/T5X style), so
every expert runs over all of its capacity slots.  Tokens past an expert's
capacity are dropped in the top-k priority order of the reference.  On one
device no phantom experts are padded in (granite's 40 stay 40).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import soft_tree as st
from repro_torch.core.eval_speculative import exact_f32_matmul
from repro_torch.core.tree import EncodedTree
from repro_torch.kernels.tree_eval import ops
from repro_torch.models.schema import PSpec, SchemaModule


def padded_experts(moe: MoEConfig, model_size: int = 1) -> int:
    """Experts padded to a multiple of the expert-parallel axis (1 on one device)."""
    m = model_size
    if moe.n_experts % m == 0 or moe.n_experts < m:
        return max(moe.n_experts, 1)
    return ((moe.n_experts + m - 1) // m) * m


def moe_schema(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name} has no MoE block")
    e_pad = padded_experts(moe)
    d, f = cfg.d_model, moe.d_ff
    out = {
        "wi": PSpec((e_pad, d, f), dtype=cfg.p_dtype),
        "wg": PSpec((e_pad, d, f), dtype=cfg.p_dtype),
        "wo": PSpec((e_pad, f, d), dtype=cfg.p_dtype),
    }
    if moe.router == "tree":
        n_internal = (1 << moe.tree_depth()) - 1
        out["router_proj"] = PSpec((d, n_internal), dtype=torch.float32)
        out["router_thr"] = PSpec((n_internal,), init="zeros", dtype=torch.float32)
    else:
        out["router"] = PSpec((d, e_pad), dtype=torch.float32)
    if moe.shared_d_ff:
        out["shared_wi"] = PSpec((d, moe.shared_d_ff), dtype=cfg.p_dtype)
        out["shared_wg"] = PSpec((d, moe.shared_d_ff), dtype=cfg.p_dtype)
        out["shared_wo"] = PSpec((moe.shared_d_ff, d), dtype=cfg.p_dtype)
    return out


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------


def _tree_cfg(cfg: ModelConfig, e_pad: int) -> st.SoftTreeConfig:
    return st.SoftTreeConfig(depth=cfg.moe.tree_depth(), in_features=cfg.d_model,
                             n_outputs=e_pad, temperature=1.0)


def _leaf_map(cfg: ModelConfig, device) -> torch.Tensor:
    n_leaves = 1 << cfg.moe.tree_depth()
    return torch.arange(n_leaves, dtype=torch.int32, device=device) % cfg.moe.n_experts


def router_probs(params: dict, x: torch.Tensor, *, cfg: ModelConfig, e_pad: int) -> torch.Tensor:
    """(..., E_pad) routing probabilities; phantom experts get no mass."""
    moe = cfg.moe
    xf = x.to(torch.float32)
    if moe.router == "tree":
        tp = st.SoftTreeParams(proj=params["router_proj"], threshold=params["router_thr"],
                               leaf_map=_leaf_map(cfg, x.device))
        # leaf_map targets only [0, n_experts): phantom outputs carry zero mass
        return st.output_probs(_tree_cfg(cfg, e_pad), tp, xf)
    logits = xf @ params["router"]
    if e_pad > moe.n_experts:
        mask = torch.arange(e_pad, device=x.device) < moe.n_experts
        logits = torch.where(mask, logits, -1e30)
    return torch.softmax(logits, dim=-1)


def router_tree(cfg: ModelConfig, router_thr: torch.Tensor) -> EncodedTree:
    """The hardened router: ``soft_tree.harden`` of the layer's perfect tree.

    Node n < I tests projected feature n against ``router_thr[n]``; leaf ℓ
    answers expert ``ℓ mod n_experts``.  Reads the thresholds to the host.
    """
    tp = st.SoftTreeParams(proj=None, threshold=router_thr, leaf_map=_leaf_map(cfg, "cpu"))
    return st.harden(_tree_cfg(cfg, padded_experts(cfg.moe)), tp)


def pack_router(cfg: ModelConfig, router_thr: torch.Tensor) -> ops.PackedTree:
    """The hardened router's tables on ``router_thr``'s device, for K1."""
    depth = cfg.moe.tree_depth()
    return ops.PackedTree(router_tree(cfg, router_thr), (1 << depth) - 1,
                          max_depth=depth, device=router_thr.device)


def router_features(x: torch.Tensor, router_proj: torch.Tensor) -> torch.Tensor:
    """z = x @ router_proj, (..., I), a full-f32 product (TF32 off on the card)."""
    with exact_f32_matmul():
        return x.to(torch.float32) @ router_proj.to(torch.float32)


def hard_tree_route(
    params: dict, x: torch.Tensor, *, cfg: ModelConfig, e_pad: int,
    packed: Optional[ops.PackedTree] = None,
) -> torch.Tensor:
    """Serving-path routing with the paper's speculative evaluator.

    Projects tokens to per-node features and classifies them with the
    hardened tree: K1 onehot on the card, its plain version on CPU tensors,
    through one ``ops.tree_eval`` call over all of ``x``'s tokens.
    ``packed`` is the router's prebuilt tables (:func:`pack_router`); without
    it they are built here, as the JAX function builds them every call.
    ``e_pad`` is the JAX signature's; the tree answers real experts only.
    Returns (...,) int32 expert ids.
    """
    if packed is None:
        packed = pack_router(cfg, params["router_thr"])
    z = router_features(x, params["router_proj"])
    out = ops.tree_eval(z.reshape(-1, z.shape[-1]), packed, algorithm="speculative", jump_mode="onehot")
    return out.reshape(x.shape[:-1])


class TreeRouter(nn.Module):
    """The hard tree route of one MoE layer, as a module a forward hook can see.

    ``forward(x, router_proj)`` takes the layer's normed hidden state
    (``h2``, grouped) and returns its expert ids.  It holds the packed
    router tables (:meth:`pack`), built once when weights are loaded and
    never rebuilt behind the caller's back: a missing pack raises, and so
    does a stale one (``router_thr`` written since the pack); the owner packs
    again (``DecoderModel.pack_routers``).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.packed: Optional[ops.PackedTree] = None
        # (the thresholds packed from, their version then): a tuple, so that
        # the parameter is not registered on this module too
        self._source: Optional[tuple[torch.Tensor, int]] = None

    def pack(self, router_thr: torch.Tensor) -> None:
        self.packed = pack_router(self.cfg, router_thr)
        self._source = (router_thr, router_thr._version)

    def share_pack(self, other: "TreeRouter") -> None:
        """Route with ``other``'s tables (a working copy sharing its thresholds)."""
        self.packed, self._source = other.packed, other._source

    @property
    def stale(self) -> bool:
        """True when the thresholds were written after the pack (an optimizer step)."""
        return self._source is not None and self._source[0]._version != self._source[1]

    def forward(self, x: torch.Tensor, router_proj: torch.Tensor) -> torch.Tensor:
        if self.packed is None:
            raise RuntimeError("the router tree is not packed: load or init the weights "
                               "(or call DecoderModel.pack_routers()) first")
        if self.stale:
            raise RuntimeError("router_thr changed since the router tree was packed (a training step?): "
                               "call DecoderModel.pack_routers() before routing hard")
        return hard_tree_route({"router_proj": router_proj}, x, cfg=self.cfg,
                               e_pad=padded_experts(self.cfg.moe), packed=self.packed)


# ---------------------------------------------------------------------------
# Dispatch-einsum MoE (GShard/T5X)
# ---------------------------------------------------------------------------


def _capacity(group: int, moe: MoEConfig, e_pad: int) -> int:
    c = int(math.ceil(group * moe.top_k * moe.capacity_factor / e_pad))
    return max(4, ((c + 3) // 4) * 4)


def moe_apply(
    params: dict,
    x: torch.Tensor,              # (B, S, D)
    *,
    cfg: ModelConfig,
    group_size: int = 512,
    serve_hard_tree: bool = False,
    route: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux_loss scalar).

    ``route(xg) → experts`` serves the hard tree path (a layer's
    :class:`TreeRouter`); without it :func:`hard_tree_route` builds the
    router tables for this call.
    """
    moe = cfg.moe
    b, s, d = x.shape
    e_pad = params["wi"].shape[0]
    t = b * s
    g = min(group_size, t)
    n_groups = t // g
    if n_groups * g != t:
        raise ValueError(f"tokens {t} not divisible by group {g}")
    xg = x.reshape(n_groups, g, d)
    dev = x.device

    if serve_hard_tree and moe.router == "tree":
        # paper's serving path: hard speculative routing, uniform gates; the
        # tree's expert plus (k-1) neighbours mod E, as in the reference
        if route is not None:
            experts = route(xg)
        else:
            experts = hard_tree_route(params, xg, cfg=cfg, e_pad=e_pad)        # (n, g)
        k = moe.top_k
        offs = torch.arange(k, device=dev)
        top_idx = (experts.long()[..., None] + offs) % moe.n_experts
        top_gates = torch.full((n_groups, g, k), 1.0 / k, dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        probs = router_probs(params, xg, cfg=cfg, e_pad=e_pad)              # (n, g, E)
        top_gates, top_idx = torch.topk(probs, moe.top_k, dim=-1)            # (n, g, k)
        top_gates = top_gates / torch.clamp(top_gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss over real experts
        me = probs.mean(dim=(0, 1))                                          # (E,)
        onehot_top1 = torch.nn.functional.one_hot(top_idx[..., 0], e_pad).to(torch.float32)
        ce = onehot_top1.mean(dim=(0, 1))
        aux = moe.aux_loss_weight * e_pad * torch.sum(me * ce)

    cap = _capacity(g, moe, e_pad)
    dtype = x.dtype
    e_ids = torch.arange(e_pad, device=dev)
    c_ids = torch.arange(cap, device=dev)

    dispatch = torch.zeros((n_groups, g, e_pad, cap), dtype=dtype, device=dev)
    combine = torch.zeros((n_groups, g, e_pad, cap), dtype=torch.float32, device=dev)
    # running per-expert fill count across the k priority classes
    fill = torch.zeros((n_groups, e_pad), dtype=torch.long, device=dev)
    for j in range(moe.top_k):
        idx_j = top_idx[..., j]                                              # (n, g)
        mask_j = (idx_j[..., None] == e_ids).long()                          # (n, g, E)
        pos_in_e = torch.cumsum(mask_j, dim=1) - 1 + fill[:, None, :]        # (n, g, E)
        fill = fill + mask_j.sum(dim=1)
        pos_j = pos_in_e.gather(-1, idx_j[..., None])[..., 0]
        keep = pos_j < cap
        # a position past the capacity one-hots to zeros, as jax.nn.one_hot does
        oh_pos = (pos_j[..., None] == c_ids).to(dtype) * keep[..., None].to(dtype)
        oh_e = (idx_j[..., None] == e_ids).to(dtype)
        d_j = oh_e[..., :, None] * oh_pos[..., None, :]                      # (n, g, E, C)
        dispatch = dispatch + d_j
        combine = combine + d_j.to(torch.float32) * (
            top_gates[..., j] * keep.to(torch.float32)
        )[..., None, None]

    # --- expert compute: every expert over all of its capacity slots ---
    exp_in = torch.einsum("ngec,ngd->necd", dispatch, xg)
    h = torch.einsum("necd,edf->necf", exp_in, params["wi"].to(dtype))
    gate = torch.einsum("necd,edf->necf", exp_in, params["wg"].to(dtype))
    h = torch.nn.functional.silu(gate) * h
    out_e = torch.einsum("necf,efd->necd", h, params["wo"].to(dtype))
    y = torch.einsum("ngec,necd->ngd", combine.to(dtype), out_e)

    if moe.shared_d_ff:
        hs = xg @ params["shared_wi"].to(dtype)
        gs = xg @ params["shared_wg"].to(dtype)
        y = y + (torch.nn.functional.silu(gs) * hs) @ params["shared_wo"].to(dtype)

    return y.reshape(b, s, d), aux


class MoE(SchemaModule):
    """One MoE block's weights, and its :class:`TreeRouter` for tree routers."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(moe_schema(cfg), device)
        self.cfg = cfg
        self.tree_router = TreeRouter(cfg) if cfg.moe.router == "tree" else None

    def pack_router(self) -> None:
        if self.tree_router is not None:
            self.tree_router.pack(self.router_thr)

    def forward(self, x: torch.Tensor, *, group_size: int = 512, serve_hard_tree: bool = False):
        route = None
        if self.tree_router is not None:
            route = lambda xg: self.tree_router(xg, self.router_proj)   # noqa: E731
        return moe_apply(self.params, x, cfg=self.cfg, group_size=group_size,
                         serve_hard_tree=serve_hard_tree, route=route)
