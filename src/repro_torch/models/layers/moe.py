"""Mixture-of-Experts layer: GShard-style capacity dispatch and the paper's
**tree router**.

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
capacity are dropped in the top-k priority order of the reference.  Experts
are padded to a multiple of the mesh's ``model`` size
(:func:`padded_experts`; on one device, and for granite's 40 on ``model``
2 or 4, none is).

Across cards each rank routes its own tokens: its batch shard, and under a
sequence-split residual its positions of it (``parallel.sharding``).  The
groups are JAX's, cut from the flattened (B·S) tokens of the batch shard,
so a shard must hold whole groups, and a group may span the sequence
shards of several ranks: a token's capacity position then counts the
earlier tokens of its group on other ranks, from their per-class,
per-expert counts, all-gathered over ``model`` (JAX ``moe.py:205-216``), so
the kept and dropped tokens are one device's.  The load-balance loss takes
``me`` and ``ce`` as means over all the tokens before their product.

Expert parallelism (``exp_in``/``out_e`` at ``P(batch, model, None, None)``,
JAX ``moe.py:221-228``): with the experts sharded over ``model`` each rank
computes the FFN of its ``e_pad/|model|`` experts on their stored slices.
Sequence-split tokens reach their experts and come back by an all-to-all
over ``model``; a group spread over several ranks is merged (its ranks'
slots are disjoint) before the FFN, so each expert runs over a group's
capacity once.  Tokens every rank holds alike (decode) are dispatched to
the rank's own experts and the outputs summed over ``model``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import soft_tree as st
from repro_torch.core.eval_speculative import exact_f32_matmul
from repro_torch.core.tree import EncodedTree
from repro_torch.kernels.tree_eval import ops
from repro_torch.models.schema import PSpec, SchemaModule
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P


def padded_experts(moe: MoEConfig, model_size: int = 1) -> int:
    """Experts padded to a multiple of the expert-parallel axis (the mesh's
    ``model`` size; 1 on one device)."""
    m = model_size
    if moe.n_experts % m == 0 or moe.n_experts < m:
        return max(moe.n_experts, 1)
    return ((moe.n_experts + m - 1) // m) * m


def moe_schema(cfg: ModelConfig, axes: shd.MeshAxes | None = None) -> dict:
    axes = axes or shd.single_device_axes()
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name} has no MoE block")
    e_pad = padded_experts(moe, axes.model_size)
    specs = shd.moe_specs(axes, e_pad, moe.d_ff, cfg.d_model)
    d, f = cfg.d_model, moe.d_ff
    out = {
        "wi": PSpec((e_pad, d, f), specs["wi"], dtype=cfg.p_dtype),
        "wg": PSpec((e_pad, d, f), specs["wg"], dtype=cfg.p_dtype),
        "wo": PSpec((e_pad, f, d), specs["wo"], dtype=cfg.p_dtype),
    }
    if moe.router == "tree":
        n_internal = (1 << moe.tree_depth()) - 1
        out["router_proj"] = PSpec((d, n_internal), P(None, None), dtype=torch.float32)
        out["router_thr"] = PSpec((n_internal,), P(None), init="zeros", dtype=torch.float32)
    else:
        out["router"] = PSpec((d, e_pad), P(None, None), dtype=torch.float32)
    if moe.shared_d_ff:
        sspecs = shd.mlp_specs(axes, moe.shared_d_ff, cfg.d_model)
        out["shared_wi"] = PSpec((d, moe.shared_d_ff), sspecs["wi"], dtype=cfg.p_dtype)
        out["shared_wg"] = PSpec((d, moe.shared_d_ff), sspecs["wg"], dtype=cfg.p_dtype)
        out["shared_wo"] = PSpec((moe.shared_d_ff, d), sspecs["wo"], dtype=cfg.p_dtype)
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


def router_tree(cfg: ModelConfig, router_thr: torch.Tensor, e_pad: int | None = None) -> EncodedTree:
    """The hardened router: ``soft_tree.harden`` of the layer's perfect tree.

    Node n < I tests projected feature n against ``router_thr[n]``; leaf ℓ
    answers expert ``ℓ mod n_experts``.  Reads the thresholds to the host.
    """
    tp = st.SoftTreeParams(proj=None, threshold=router_thr, leaf_map=_leaf_map(cfg, "cpu"))
    return st.harden(_tree_cfg(cfg, e_pad or padded_experts(cfg.moe)), tp)


def holds_values(t: torch.Tensor) -> bool:
    """False for a meta or fake tensor (a dry-run's), whose values cannot be read."""
    from torch._subclasses.fake_tensor import is_fake

    return not (t.is_meta or is_fake(t))


def pack_router(cfg: ModelConfig, router_thr: torch.Tensor, e_pad: int | None = None) -> ops.PackedTree:
    """The hardened router's tables on ``router_thr``'s device, for K1.

    Thresholds that hold no values (meta or fake) give tables of the same
    shapes and dtypes with none either: K1's shape rule plans through them.
    """
    depth = cfg.moe.tree_depth()
    n_internal = (1 << depth) - 1
    if not holds_values(router_thr):
        return ops.PackedTree.shapes_only(2 * n_internal + 1, n_internal, depth, router_thr.device)
    return ops.PackedTree(router_tree(cfg, router_thr, e_pad), n_internal,
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
    again (``DecoderModel.pack_routers``).  A sharded model's thresholds
    are a DTensor: the tables are packed from the gathered whole, and the
    staleness is read on this rank's block, which the optimizer writes.
    """

    def __init__(self, cfg: ModelConfig, e_pad: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.e_pad = e_pad or padded_experts(cfg.moe)
        self.packed: Optional[ops.PackedTree] = None
        # (the thresholds packed from, their version then): a tuple, so that
        # the parameter is not registered on this module too
        self._source: Optional[tuple[torch.Tensor, int]] = None

    @torch.no_grad()
    def pack(self, router_thr: torch.Tensor) -> None:
        """Pack the tables from ``router_thr``; thresholds with no values
        (meta or fake, a dry-run's) give tables of their shapes alone, with
        no gather and no host read."""
        if isinstance(router_thr, DTensor):
            local = router_thr.to_local()
            whole = router_thr.full_tensor() if holds_values(local) else local.new_empty(router_thr.shape)
            self.packed = pack_router(self.cfg, whole, self.e_pad)
            router_thr = local
        else:
            self.packed = pack_router(self.cfg, router_thr, self.e_pad)
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
                               e_pad=self.e_pad, packed=self.packed)


# ---------------------------------------------------------------------------
# Dispatch-einsum MoE (GShard/T5X)
# ---------------------------------------------------------------------------


def _capacity(group: int, moe: MoEConfig, e_pad: int) -> int:
    c = int(math.ceil(group * moe.top_k * moe.capacity_factor / e_pad))
    return max(4, ((c + 3) // 4) * 4)


def _experts(params: dict, exp_in: torch.Tensor) -> torch.Tensor:
    """The SwiGLU FFN of each expert over its capacity slots: (n, E, C, D)."""
    dtype = exp_in.dtype
    h = torch.einsum("necd,edf->necf", exp_in, params["wi"].to(dtype))
    gate = torch.einsum("necd,edf->necf", exp_in, params["wg"].to(dtype))
    h = torch.nn.functional.silu(gate) * h
    return torch.einsum("necf,efd->necd", h, params["wo"].to(dtype))


def _piece_groups(b: int, s: int, g: int, shards: shd.ModelShards) -> tuple[torch.Tensor, torch.Tensor]:
    """(starts, groups), each (|model|·b,), rank-major: the flat index in the
    batch shard's (B·S) tokens of each rank's sequence shard of each row
    (``s`` positions a rank), and the group of ``g`` tokens it lies in."""
    starts = (torch.arange(b)[None, :] * (s * shards.size) + torch.arange(shards.size)[:, None] * s).reshape(-1)
    return starts, starts // g


def _spanning_offsets(counts: torch.Tensor, s: int, g: int, shards: shd.ModelShards) -> torch.Tensor:
    """(b, k, E): for each of this rank's pieces (a row's sequence shard,
    inside a group that spans ranks), the slots of each class already taken
    when its first token is placed.  ``counts`` (b, k, E) are this rank's
    pieces' tokens by class and expert; every rank's are all-gathered over
    ``model``.  JAX's order (``moe.py:205-216``): class by class over the
    whole group, each class in token order."""
    b, k, e = counts.shape
    every = shd.model_gather(counts[None], 0, shards).reshape(-1, k, e)   # (|model|·b, k, E)
    starts, groups = _piece_groups(b, s, g, shards)
    mine = slice(shards.index * b, (shards.index + 1) * b)
    same = (groups[None, :] == groups[mine, None]).to(counts.device)
    earlier = same & (starts[None, :] < starts[mine, None]).to(counts.device)
    before = (earlier[..., None, None] * every[None]).sum(dim=1)                        # this class, earlier pieces
    whole = (same[..., None, None] * every[None]).sum(dim=1)                            # every class, the group
    return before + torch.cumsum(whole, dim=1) - whole                                  # + earlier classes


def capacity_positions(top_idx: torch.Tensor, e_pad: int, g: int,
                       shards: Optional[shd.ModelShards] = None) -> torch.Tensor:
    """(n, p, k): each assignment's slot in its expert's capacity, JAX's
    order (``moe.py:205-216``): class by class over the whole group, each
    class in token order; a slot at or past the capacity is a dropped
    assignment.  ``top_idx`` (n, p, k) are the experts of pieces of ``p``
    tokens: whole groups (``p == g``), or with ``shards`` one sequence
    shard of a row each, inside groups that span ranks."""
    e_ids = torch.arange(e_pad, device=top_idx.device)
    masks = [(top_idx[..., j][..., None] == e_ids).long() for j in range(top_idx.shape[-1])]   # (n, p, E)
    counts = torch.stack([mk.sum(dim=1) for mk in masks], dim=1)                          # (n, k, E)
    if shards is not None:
        offsets = _spanning_offsets(counts, top_idx.shape[1], g, shards)
    else:       # whole groups: the fill of the earlier classes
        offsets = torch.cumsum(counts, dim=1) - counts
    pos = [(torch.cumsum(mk, dim=1) - 1 + offsets[:, j, None, :]).gather(-1, top_idx[..., j, None])[..., 0]
           for j, mk in enumerate(masks)]
    return torch.stack(pos, dim=-1)


def moe_apply(
    params: dict,
    x: torch.Tensor,              # (B, S, D)
    *,
    cfg: ModelConfig,
    group_size: int = 512,
    serve_hard_tree: bool = False,
    route: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    e_pad: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux_loss scalar).

    ``route(xg) → experts`` serves the hard tree path (a layer's
    :class:`TreeRouter`); without it :func:`hard_tree_route` builds the
    router tables for this call.  ``e_pad`` (default: ``wi``'s leading dim)
    is the padded expert count: under split compute ``params`` may hold
    this rank's experts only (module docstring).  Under a sequence-split
    residual ``x`` is this rank's positions.
    """
    moe = cfg.moe
    b, s, d = x.shape
    e_pad = e_pad or params["wi"].shape[0]
    ms = shd.active_model()
    seq = ms is not None and ms.seq
    t = b * s * (ms.size if seq else 1)            # the batch shard's tokens
    g = min(group_size, t)
    if t % g:
        raise ValueError(f"tokens {t} not divisible by group {g}")
    shards = shd.active_shards()
    if shards is not None and shards.count > 1 and t % group_size:
        raise ValueError(f"a batch shard of {t} tokens does not hold whole groups of {group_size}: "
                         "its capacity, and so its dropped tokens, would differ from one device's")
    # this rank's tokens in pieces of p, each inside one group of g
    p = min(s, g) if seq else g
    if seq and s % g and g % s:
        raise ValueError(f"sequence shards of {s} positions and groups of {g} tokens do not nest")
    n = b * s // p
    xg = x.reshape(n, p, d)
    dev = x.device

    if serve_hard_tree and moe.router == "tree":
        # paper's serving path: hard speculative routing, uniform gates; the
        # tree's expert plus (k-1) neighbours mod E, as in the reference
        if route is not None:
            experts = route(xg)
        else:
            experts = hard_tree_route(params, xg, cfg=cfg, e_pad=e_pad)        # (n, p)
        k = moe.top_k
        offs = torch.arange(k, device=dev)
        top_idx = (experts.long()[..., None] + offs) % moe.n_experts
        top_gates = torch.full((n, p, k), 1.0 / k, dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        probs = router_probs(params, xg, cfg=cfg, e_pad=e_pad)              # (n, p, E)
        top_gates, top_idx = torch.topk(probs, moe.top_k, dim=-1)            # (n, p, k)
        top_gates = top_gates / torch.clamp(top_gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss over real experts, on the means
        # over every token of the step
        me = shd.token_mean(probs.mean(dim=(0, 1)))                          # (E,)
        onehot_top1 = torch.nn.functional.one_hot(top_idx[..., 0], e_pad).to(torch.float32)
        ce = shd.token_mean(onehot_top1.mean(dim=(0, 1)))
        aux = moe.aux_loss_weight * e_pad * torch.sum(me * ce)

    cap = _capacity(g, moe, e_pad)
    dtype = x.dtype
    e_ids = torch.arange(e_pad, device=dev)
    c_ids = torch.arange(cap, device=dev)
    slots = capacity_positions(top_idx, e_pad, g, ms if p < g else None)                 # (n, p, k)

    dispatch = torch.zeros((n, p, e_pad, cap), dtype=dtype, device=dev)
    combine = torch.zeros((n, p, e_pad, cap), dtype=torch.float32, device=dev)
    for j in range(moe.top_k):
        idx_j = top_idx[..., j]                                              # (n, p)
        pos_j = slots[..., j]
        keep = pos_j < cap
        # a position past the capacity one-hots to zeros, as jax.nn.one_hot does
        oh_pos = (pos_j[..., None] == c_ids).to(dtype) * keep[..., None].to(dtype)
        oh_e = (idx_j[..., None] == e_ids).to(dtype)
        d_j = oh_e[..., :, None] * oh_pos[..., None, :]                      # (n, p, E, C)
        dispatch = dispatch + d_j
        combine = combine + d_j.to(torch.float32) * (
            top_gates[..., j] * keep.to(torch.float32)
        )[..., None, None]

    # --- expert compute: every expert over all of its capacity slots ---
    e_loc = params["wi"].shape[0]
    partial = None                 # this rank's share of a sum over 'model'
    if ms is None or e_loc == e_pad:         # every expert on this rank
        exp_in = torch.einsum("ngec,ngd->necd", dispatch, xg)
        y = torch.einsum("ngec,necd->ngd", combine.to(dtype), _experts(params, exp_in))
    elif seq:
        y = torch.einsum("ngec,necd->ngd", combine.to(dtype),
                         _experts_all_to_all(params, torch.einsum("ngec,ngd->necd", dispatch, xg), b, s, g, ms))
    else:                                    # the same tokens on every rank: its own experts
        own = slice(ms.index * e_loc, (ms.index + 1) * e_loc)
        if torch.is_grad_enabled():
            exp_in = torch.einsum("ngec,ngd->necd", dispatch[:, :, own], shd.enter_split(xg, ms))
            out_e = shd.gather_alike(_experts(params, exp_in), 1, ms)
            y = torch.einsum("ngec,necd->ngd", combine.to(dtype), out_e)
        else:
            exp_in = torch.einsum("ngec,ngd->necd", dispatch[:, :, own], xg)
            y, partial = None, torch.einsum("ngec,necd->ngd", combine[:, :, own].to(dtype), _experts(params, exp_in))

    if moe.shared_d_ff:
        hs = xg @ params["shared_wi"].to(dtype)
        gs = xg @ params["shared_wg"].to(dtype)
        shared = (torch.nn.functional.silu(gs) * hs) @ params["shared_wo"].to(dtype)
        if params["shared_wi"].shape[1] < moe.shared_d_ff:     # this rank's slice of d_ff (decode)
            partial = shared if partial is None else partial + shared
        else:
            y = shared if y is None else y + shared
    if partial is not None:
        partial = shd.model_sum(partial, ms)
        y = partial if y is None else y + partial

    return y.reshape(b, s, d), aux


def _experts_all_to_all(params: dict, exp_in: torch.Tensor, b: int, s: int, g: int,
                        ms: shd.ModelShards) -> torch.Tensor:
    """``out_e`` (n, E, C, D) of this rank's pieces ``exp_in`` (n, E, C, D),
    the FFN of each expert computed on the rank that stores it: each
    expert block's slots go to its rank by an all-to-all over ``model``, the
    pieces of a group that spans ranks are merged there (their slots are
    disjoint), and the outputs come back the same way."""
    n, e_pad, cap, d = exp_in.shape
    m = ms.size
    e_loc = e_pad // m
    recv = shd.model_all_to_all(exp_in.reshape(n, m, e_loc, cap, d).transpose(0, 1), ms)   # (m from, n, E_l, C, D)
    recv = recv.reshape(m * n, e_loc, cap, d)
    if s >= g:                               # each piece a whole group
        back = _experts(params, recv)
    else:
        _, groups = _piece_groups(n, s, g, ms)
        groups = groups.to(exp_in.device)
        merged = torch.zeros((n * s * m // g, e_loc, cap, d), dtype=recv.dtype, device=recv.device)
        back = _experts(params, merged.index_add(0, groups, recv))[groups]
    out = shd.model_all_to_all(back.reshape(m, n, e_loc, cap, d), ms)                    # (m owner, n, E_l, C, D)
    return out.transpose(0, 1).reshape(n, e_pad, cap, d)


class MoE(SchemaModule):
    """One MoE block's weights, and its :class:`TreeRouter` for tree routers."""

    def __init__(self, cfg: ModelConfig, device, axes: shd.MeshAxes | None = None):
        schema = moe_schema(cfg, axes)
        super().__init__(schema, device)
        self.cfg = cfg
        self.e_pad = schema["wi"].shape[0]
        self.tree_router = TreeRouter(cfg, self.e_pad) if cfg.moe.router == "tree" else None

    def pack_router(self) -> None:
        if self.tree_router is not None:
            self.tree_router.pack(self.router_thr)

    def forward(self, x: torch.Tensor, *, group_size: int = 512, serve_hard_tree: bool = False):
        route = None
        if self.tree_router is not None:
            route = lambda xg: self.tree_router(xg, self.router_proj)   # noqa: E731
        return moe_apply(self.params, x, cfg=self.cfg, group_size=group_size,
                         serve_hard_tree=serve_hard_tree, route=route, e_pad=self.e_pad)
