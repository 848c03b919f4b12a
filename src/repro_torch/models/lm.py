"""Decoder-only LM for the dense / moe / vlm families, on one device.

The port's counterpart of the JAX package's ``models/lm.py``:

  * parameters are declared by the schema and held by modules: a
    ``ModuleList`` of blocks where JAX scans a stacked (L, …) tree, so the
    ``state_dict`` key ``layers.3.moe.router_proj`` is the JAX leaf
    ``params["layers"]["moe"]["router_proj"][3]``;
  * the f32 master weights are cast to the activation dtype where they are
    used, as JAX's ``cast_for_compute`` does inside every call; a serving
    engine makes its working copy once (:meth:`DecoderModel.cast_for_compute`)
    so that no call re-casts;
  * full-sequence attention is blockwise past one KV block;
  * decode writes the stacked KV cache in place.

Modes: ``forward`` (teacher-forced logits), ``loss`` (the chunked
cross-entropy plus the MoE aux loss, for training), ``prefill`` (forward +
cache), ``decode_step`` (one token against the cache).  The ``hybrid``
family (SSM) is not ported.

Rematerialization follows ``ParallelConfig.remat`` block by block, as the
JAX package's ``_remat`` wraps its scanned layer body, and only while grad
is enabled (the serving paths run under ``no_grad`` and never checkpoint):
``"none"`` saves every activation, ``"full"`` (the default) recomputes each
block in the backward pass (non-reentrant ``torch.utils.checkpoint``),
``"dots"`` saves the blocks' matmul outputs (``aten.mm``: the products with
no batch dims, as JAX's ``dots_with_no_batch_dims_saveable``) and recomputes
the rest.  ``"offload"`` (residuals to pinned host memory) is not ported
(ROADMAP.md §1 item 5).  Remat changes no number.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.mlp import MLP, RMSNorm, rmsnorm_schema, mlp_schema
from repro_torch.models.layers.moe import MoE, TreeRouter, moe_schema
from repro_torch.models.layers.rope import positions_for
from repro_torch.parallel.sharding import pad_vocab
from repro_torch.utils.losses import chunked_softmax_xent

FAMILIES = ("dense", "moe", "vlm")
REMAT_MODES = ("none", "full", "dots", "offload")


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products with no batch dims."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


class DecodeCache(NamedTuple):
    kv: attn.KVCache          # stacked (L, B, S_max, KV, hd)
    ssm: Optional[Any]        # the hybrid family's SSM state; None here
    pos: int                  # tokens already in the cache


class Block(nn.Module):
    """One transformer block: attention, then the MoE or dense MLP."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def _ffn(self, h2, *, group_size: int, serve_hard_tree: bool):
        if self.cfg.moe is not None:
            return self.moe(h2, group_size=group_size, serve_hard_tree=serve_hard_tree)
        return self.mlp(h2), None

    def forward(self, x, positions, is_global, *, serve_hard_tree=False, kv_block):
        """Full sequence. Returns (x, aux, k, v); k/v feed prefill's cache."""
        h = self.ln1(x)
        a, k, v = self.attn(h, positions, window=self.cfg.sliding_window, is_global=is_global,
                            kv_block=kv_block)
        x = x + a
        y, aux = self._ffn(self.ln2(x), group_size=512, serve_hard_tree=serve_hard_tree)
        return x + y, aux, k, v

    def decode(self, x, kv: attn.KVCache, pos: int, positions, is_global):
        """One token for every sequence against this layer's cache (written in place)."""
        h = self.ln1(x)
        a, _ = self.attn.decode(h, kv, pos, positions, window=self.cfg.sliding_window, is_global=is_global)
        x = x + a
        h2 = self.ln2(x)
        # decode routes all B·1 tokens as one group
        moe = self.cfg.moe
        y, _ = self._ffn(h2, group_size=h2.shape[0] * h2.shape[1],
                         serve_hard_tree=moe is not None and moe.router == "tree")
        return x + y


class DecoderModel(nn.Module):
    """The decoder LM; ``device=None`` is the card (raises without one)."""

    def __init__(self, cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: it needs the SSM, xLSTM or "
                "encoder-decoder layers (ROADMAP.md §1 item 5)")
        dev = _device.resolve(None, device)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.v_pad = pad_vocab(cfg.vocab_size)
        # The table's module is named "embed" for the state_dict key
        # "embed.table"; the method embed() shadows the attribute, so the
        # module is reached as self._modules["embed"] (embed_table).
        self.embed = sch.SchemaModule({"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)}, dev)
        self.layers = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = sch.SchemaModule({"w": sch.PSpec((cfg.d_model, self.v_pad), dtype=cfg.p_dtype)}, dev)

    # ----------------------------- schema -----------------------------

    def layer_schema(self) -> dict:
        cfg = self.cfg
        out = {"ln1": rmsnorm_schema(cfg), "attn": attn.attn_schema(cfg), "ln2": rmsnorm_schema(cfg)}
        if cfg.moe is not None:
            out["moe"] = moe_schema(cfg)
        else:
            out["mlp"] = mlp_schema(cfg)
        return out

    def schema(self) -> dict:
        """The JAX model's schema: layers stacked (L, …), as its scanned stack."""
        cfg = self.cfg
        out = {
            "embed": {"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)},
            "layers": sch.stacked(self.layer_schema(), cfg.n_layers),
            "final_norm": rmsnorm_schema(cfg),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = {"w": sch.PSpec((cfg.d_model, self.v_pad), dtype=cfg.p_dtype)}
        return out

    def layer_params(self, path: str) -> list[torch.Tensor]:
        """The parameters behind one schema path: L of them for a ``layers.`` path."""
        if path.startswith("layers."):
            rest = path[len("layers."):]
            return [dict(layer.named_parameters())[rest] for layer in self.layers]
        return [dict(self.named_parameters())[path]]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderModel":
        """Draw every weight from ``generator`` (on the model's device), leaf by
        leaf as the schema declares them, each stacked leaf layer by layer
        at the stack's fan-in; then pack the routers."""
        for path, spec in sch.leaves(self.schema()):
            for p in self.layer_params(path):
                sch.init_leaf_(p, spec, generator)
        self.pack_routers()
        return self

    def tree_routers(self) -> list[TreeRouter]:
        return [m for m in self.modules() if isinstance(m, TreeRouter)]

    def pack_routers(self) -> None:
        """Harden and pack every layer's router tree (after a change of weights:
        a router whose ``router_thr`` changed since its pack refuses to route)."""
        for layer in self.layers:
            if self.cfg.moe is not None:
                layer.moe.pack_router()

    def cast_for_compute(self, dtype: str | None = None) -> "DecoderModel":
        """The working copy: a model whose weights are in the activation dtype.

        ``dtype`` replaces the config's activation dtype.  Leaves kept in f32
        by design (router, norm scales) and leaves already in the dtype are
        the master tensors, shared; the packed routers are shared too.
        With ``dtype="float32"`` every weight is shared and nothing is copied.
        """
        cfg = self.cfg if dtype is None else dataclasses.replace(self.cfg, dtype=dtype)
        work = DecoderModel(cfg, device="meta", parallel=self.parallel)
        work.load_state_dict(sch.cast_for_compute(self.state_dict(), cfg.act_dtype), assign=True)
        work.requires_grad_(False)
        for mine, theirs in zip(work.tree_routers(), self.tree_routers()):
            mine.share_pack(theirs)
        return work

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def embed_table(self) -> torch.Tensor:
        return self._modules["embed"].table

    # ------------------------------ forward ------------------------------

    def _is_global_flags(self) -> list[bool]:
        cfg = self.cfg
        if cfg.sliding_window == 0:
            return [True] * cfg.n_layers
        return [i in set(cfg.global_attn_layers) for i in range(cfg.n_layers)]

    def embed(self, batch: dict) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x (B,S,D) in the activation dtype, positions) for ``batch``'s
        ``tokens`` (B,S) or ``embeds`` (B,S,D)."""
        cfg = self.cfg
        if cfg.embeds_input:
            x = batch["embeds"].to(cfg.act_dtype)
        else:
            # the table is cast before the gather, as in JAX: in training the
            # gradient then accumulates repeated tokens in the activation dtype
            x = self.embed_table.to(cfg.act_dtype)[batch["tokens"].long()]
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None and cfg.rope_style != "none":
            positions = positions_for(b, s, style=cfg.rope_style, device=x.device)
        return x, positions

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self._out_w(x.dtype)

    def _remat(self, fn):
        """``fn`` (one block) wrapped as ``parallel.remat`` says; see the module
        docstring.  As in the JAX package, only the scanned layer stack is
        rematerialized."""
        mode = self.parallel.remat
        if mode not in REMAT_MODES:
            raise ValueError(f"remat {mode!r} is not one of {REMAT_MODES}")
        if mode == "none" or not torch.is_grad_enabled() or not self.parallel.scan_layers:
            return fn
        if mode == "offload":
            raise NotImplementedError("remat='offload' (residuals to pinned host memory) is not ported: "
                                      "ROADMAP.md §1 item 5")
        kw = {"use_reentrant": False, "preserve_rng_state": False}
        if mode == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, fn, **kw)

    def hidden(self, batch: dict, *, serve_hard_tree: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Final normed hidden states (B,S,D) + aux loss."""
        x, positions = self.embed(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, is_g in zip(self.layers, self._is_global_flags()):
            def block(x, layer=layer, is_g=is_g):
                x, a, _, _ = layer(x, positions, is_g, serve_hard_tree=serve_hard_tree,
                                   kv_block=self.parallel.attn_kv_block)
                return x, a
            x, a = self._remat(block)(x)
            if a is not None:
                aux = aux + a
        return self.final_norm(x), aux

    def forward(self, batch: dict, *, serve_hard_tree: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits (B,S,V_pad), aux_loss)."""
        x, aux = self.hidden(batch, serve_hard_tree=serve_hard_tree)
        return self.logits(x), aux

    def _out_w(self, dtype: torch.dtype) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed_table.to(dtype).T
        return self.lm_head.w.to(dtype)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(total, {"nll", "aux"}): the chunked next-token cross-entropy over
        ``batch["labels"]`` (negative ids masked, the padded vocabulary
        excluded) plus the MoE load-balance loss, all 0-d f32."""
        x, aux = self.hidden(batch)
        nll, _ = chunked_softmax_xent(x, self._out_w(x.dtype), batch["labels"], vocab_size=self.cfg.vocab_size)
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------- decode -------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> DecodeCache:
        """The cache's shapes and dtypes as meta tensors (nothing allocated)."""
        return self.init_cache(batch, max_len, device="meta")

    def init_cache(self, batch: int, max_len: int, device=None) -> DecodeCache:
        shape, dtype = attn.cache_shape(self.cfg, batch, max_len)
        dev = self.device if device is None else device
        k = torch.zeros((self.cfg.n_layers, *shape), dtype=dtype, device=dev)
        return DecodeCache(kv=attn.KVCache(k=k, v=torch.zeros_like(k)), ssm=None, pos=0)

    @torch.no_grad()
    def decode_step(self, cache: DecodeCache, batch: dict) -> tuple[torch.Tensor, DecodeCache]:
        """One token for every sequence in the batch: ``{"tokens": (B,1)}`` (or
        ``{"embeds": (B,1,D)}``); positions are ``cache.pos``.  Writes the
        cache in place and returns it with ``pos + 1``."""
        cfg = self.cfg
        x, _ = self.embed(batch)
        b = x.shape[0]
        pos = cache.pos
        if cfg.rope_style == "mrope":
            positions = torch.full((b, 3, 1), pos, dtype=torch.int32, device=x.device)
        elif cfg.rope_style == "rope":
            positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        else:
            positions = None
        for i, (layer, is_g) in enumerate(zip(self.layers, self._is_global_flags())):
            kv = attn.KVCache(k=cache.kv.k[i], v=cache.kv.v[i])
            x = layer.decode(x, kv, pos, positions, is_g)
        logits = self.logits(self.final_norm(x))
        return logits, DecodeCache(kv=cache.kv, ssm=None, pos=pos + 1)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int | None = None) -> tuple[torch.Tensor, DecodeCache]:
        """Forward + KV-cache construction; the tree router routes hard.

        ``max_len``: cache capacity; defaults to the prompt length.  Serving
        passes prompt + generation budget.  Returns the last position's
        logits (B,1,V_pad) and the cache with ``pos`` = prompt length.
        """
        cfg = self.cfg
        x, positions = self.embed(batch)
        b, s = x.shape[:2]
        cache = self.init_cache(b, max(s, max_len or s))
        hard = cfg.moe is not None and cfg.moe.router == "tree"
        for i, (layer, is_g) in enumerate(zip(self.layers, self._is_global_flags())):
            x, _, k, v = layer(x, positions, is_g, serve_hard_tree=hard,
                               kv_block=self.parallel.attn_kv_block)
            cache.kv.k[i, :, :s] = k
            cache.kv.v[i, :, :s] = v
        logits = self.logits(self.final_norm(x[:, -1:, :]))
        return logits, cache._replace(pos=s)
