"""Decoder-only LM for the dense / moe / hybrid / vlm families, on one device.

The port's counterpart of the JAX package's ``models/lm.py``:

  * parameters are declared by the schema and held by modules: a
    ``ModuleList`` of blocks where JAX scans a stacked (L, …) tree, so the
    ``state_dict`` key ``layers.3.moe.router_proj`` is the JAX leaf
    ``params["layers"]["moe"]["router_proj"][3]``;
  * the f32 master weights are cast to the activation dtype where they are
    used, as JAX's ``cast_for_compute`` does inside every call; a serving
    engine makes its working copy once (:meth:`SchemaModel.cast_for_compute`)
    so that no call re-casts;
  * full-sequence attention is blockwise past one KV block;
  * decode writes the stacked KV cache (and the hybrid family's stacked
    SSM state) in place.

The ``hybrid`` family (hymba) runs an SSM head beside attention in every
block, on the same normed input, and adds ``0.5 · (attention + ssm)`` to
the residual; its sliding windows lift on ``global_attn_layers``.  Its
prefill carries the SSM's conv tail into the cache but, as the JAX
package's does (``src/repro/models/lm.py:384-387``), restarts the SSM's
``h`` from zero, so the first decode step after a prefill does not continue
the prompt's scan (ROADMAP.md §3 item 13).

Modes: ``forward`` (teacher-forced logits), ``loss`` (the chunked
cross-entropy plus the MoE aux loss, for training), ``prefill`` (forward +
cache), ``decode_step`` (one token against the cache).

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

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.mlp import MLP, RMSNorm, rmsnorm_schema, mlp_schema
from repro_torch.models.layers.moe import MoE, TreeRouter, moe_schema
from repro_torch.models.layers.rope import positions_for
from repro_torch.models.layers.ssm import SSM, SSMState, ssm_schema, ssm_state_shape
from repro_torch.parallel.sharding import pad_vocab
from repro_torch.utils.losses import chunked_softmax_xent

DECODER_FAMILIES = ("dense", "moe", "hybrid", "vlm")
FAMILIES = DECODER_FAMILIES + ("ssm", "audio")    # every family models.build_model builds


class DecodeCache(NamedTuple):
    kv: attn.KVCache          # stacked (L, B, S_max, KV, hd)
    ssm: Optional[SSMState]   # the hybrid family's, stacked (L, …); else None
    pos: int                  # tokens already in the cache


class Block(nn.Module):
    """One transformer block: attention (beside an SSM head in the hybrid
    family), then the MoE or dense MLP."""

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
        if cfg.family == "hybrid":
            self.ssm = SSM(cfg, device)

    def _ffn(self, h2, *, group_size: int, serve_hard_tree: bool):
        if self.cfg.moe is not None:
            return self.moe(h2, group_size=group_size, serve_hard_tree=serve_hard_tree)
        return self.mlp(h2), None

    def forward(self, x, positions, is_global, *, serve_hard_tree=False, kv_block):
        """Full sequence. Returns (x, aux, k, v, ssm state); k/v and the SSM's
        terminal state (hybrid; else None) feed prefill's cache."""
        h = self.ln1(x)
        a, k, v = self.attn(h, positions, window=self.cfg.sliding_window, is_global=is_global,
                            kv_block=kv_block)
        sstate = None
        if self.cfg.family == "hybrid":
            sm, sstate = self.ssm(h, return_state=True)
            x = x + 0.5 * (a + sm)
        else:
            x = x + a
        y, aux = self._ffn(self.ln2(x), group_size=512, serve_hard_tree=serve_hard_tree)
        return x + y, aux, k, v, sstate

    def decode(self, x, kv: attn.KVCache, pos: int, positions, is_global, sstate: Optional[SSMState] = None):
        """One token for every sequence against this layer's cache (written in
        place). Returns (x, the new SSM state or None)."""
        h = self.ln1(x)
        a, _ = self.attn.decode(h, kv, pos, positions, window=self.cfg.sliding_window, is_global=is_global)
        if self.cfg.family == "hybrid":
            s_out, sstate = self.ssm.decode(h, sstate)
            x = x + 0.5 * (a + s_out)
        else:
            x = x + a
        h2 = self.ln2(x)
        # decode routes all B·1 tokens as one group
        moe = self.cfg.moe
        y, _ = self._ffn(h2, group_size=h2.shape[0] * h2.shape[1],
                         serve_hard_tree=moe is not None and moe.router == "tree")
        return x + y, sstate


class DecoderModel(sch.SchemaModel):
    """The decoder LM; ``device=None`` is the card (raises without one)."""

    def __init__(self, cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None):
        super().__init__()
        if cfg.family not in DECODER_FAMILIES:
            raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not a decoder-only family: "
                             "build it with models.build_model")
        dev = _device.resolve(None, device)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.stacks = {"layers": cfg.n_layers}
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
        if cfg.family == "hybrid":
            out["ssm"] = ssm_schema(cfg)
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

    def jax_leaf_dims(self) -> dict[str, int]:
        if not self.parallel.scan_layers:      # JAX's tree is then per layer
            return {n: p.ndim for n, p in self.named_parameters()}
        return super().jax_leaf_dims()

    def tree_routers(self) -> list[TreeRouter]:
        return [m for m in self.modules() if isinstance(m, TreeRouter)]

    def pack_routers(self) -> None:
        """Harden and pack every layer's router tree (after a change of weights:
        a router whose ``router_thr`` changed since its pack refuses to route)."""
        for layer in self.layers:
            if self.cfg.moe is not None:
                layer.moe.pack_router()

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
        if not self.parallel.scan_layers:
            return fn
        if mode == "offload" and torch.is_grad_enabled():
            raise NotImplementedError("remat='offload' (residuals to pinned host memory) is not ported: "
                                      "ROADMAP.md §1 item 5")
        return sch.checkpointed(fn, mode)

    def hidden(self, batch: dict, *, serve_hard_tree: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Final normed hidden states (B,S,D) + aux loss."""
        x, positions = self.embed(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, is_g in zip(self.layers, self._is_global_flags()):
            def block(x, layer=layer, is_g=is_g):
                x, a, _, _, _ = layer(x, positions, is_g, serve_hard_tree=serve_hard_tree,
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
        cfg = self.cfg
        shape, dtype = attn.cache_shape(cfg, batch, max_len)
        dev = self.device if device is None else device
        k = torch.zeros((cfg.n_layers, *shape), dtype=dtype, device=dev)
        sstate = None
        if cfg.family == "hybrid":
            conv_shape, conv_dtype, h_shape, h_dtype = ssm_state_shape(cfg, batch)
            sstate = SSMState(conv=torch.zeros((cfg.n_layers, *conv_shape), dtype=conv_dtype, device=dev),
                              h=torch.zeros((cfg.n_layers, *h_shape), dtype=h_dtype, device=dev))
        return DecodeCache(kv=attn.KVCache(k=k, v=torch.zeros_like(k)), ssm=sstate, pos=0)

    @torch.no_grad()
    def decode_step(self, cache: DecodeCache, batch: dict) -> tuple[torch.Tensor, DecodeCache]:
        """One token for every sequence in the batch: ``{"tokens": (B,1)}`` (or
        ``{"embeds": (B,1,D)}``); positions are ``cache.pos``.  Writes the
        cache (KV and SSM state) in place and returns it with ``pos + 1``."""
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
            ss = None if cache.ssm is None else SSMState(conv=cache.ssm.conv[i], h=cache.ssm.h[i])
            x, new_ss = layer.decode(x, kv, pos, positions, is_g, ss)
            if new_ss is not None:
                cache.ssm.conv[i].copy_(new_ss.conv)
                cache.ssm.h[i].copy_(new_ss.h)
        logits = self.logits(self.final_norm(x))
        return logits, cache._replace(pos=pos + 1)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int | None = None) -> tuple[torch.Tensor, DecodeCache]:
        """Forward + cache construction; the tree router routes hard.

        ``max_len``: cache capacity; defaults to the prompt length.  Serving
        passes prompt + generation budget.  Returns the last position's
        logits (B,1,V_pad) and the cache with ``pos`` = prompt length.  The
        hybrid family's SSM state gets the conv tail and a zero ``h`` (see
        the module docstring).
        """
        cfg = self.cfg
        x, positions = self.embed(batch)
        b, s = x.shape[:2]
        cache = self.init_cache(b, max(s, max_len or s))
        hard = cfg.moe is not None and cfg.moe.router == "tree"
        for i, (layer, is_g) in enumerate(zip(self.layers, self._is_global_flags())):
            x, _, k, v, ss = layer(x, positions, is_g, serve_hard_tree=hard,
                                   kv_block=self.parallel.attn_kv_block)
            cache.kv.k[i, :, :s] = k
            cache.kv.v[i, :, :s] = v
            if ss is not None:
                cache.ssm.conv[i] = ss.conv        # h stays zero, as in JAX
        logits = self.logits(self.final_norm(x[:, -1:, :]))
        return logits, cache._replace(pos=s)
