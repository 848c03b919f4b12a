"""Decoder-only LM for the dense / moe / hybrid / vlm families.

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

Across cards (:meth:`~repro_torch.models.schema.SchemaModel.distribute`)
each block gathers its weights inside its rematerialized body, so a
"full" or "offload" block gathers them again in the backward pass.  With
``tp`` on and ``model`` > 1 the dense, MoE and VLM families split the step
over ``model`` as the JAX mesh program lays out its activations
(:meth:`DecoderModel.model_split`, ``parallel.sharding``): the residual
stream holds ``S/|model|`` positions a rank between blocks where
``free_model_seq`` names ``model`` and ``parallel.seq_shard`` is on (the
embedding takes the rank's positions at their global offsets), the logits
and the loss are vocab-sharded, the MoE is expert-parallel, and decode
splits its cache by KV heads, else by sequence (:meth:`cache_specs`).  The
hybrid family splits the same way, and its SSM runs on the rank's
``d_inner/|model|`` channels over the whole sequence of its rows
(``layers.ssm``: the sequence all-gathered in, the partial output
reduce-scattered back to the rank's positions, JAX's constraint on the
scan at ``src/repro/models/layers/ssm.py:122``); hymba's 25 heads divide
no ``model`` axis, so its attention projections stay whole on every rank,
and its decode state is the rank's channels.

Rematerialization follows ``ParallelConfig.remat`` block by block, as the
JAX package's ``_remat`` wraps its scanned layer body, and only while grad
is enabled (the serving paths run under ``no_grad`` and never checkpoint):
``"none"`` saves every activation, ``"full"`` (the default) recomputes each
block in the backward pass (non-reentrant ``torch.utils.checkpoint``),
``"dots"`` saves the blocks' matmul outputs (``aten.mm``: the products with
no batch dims, as JAX's ``dots_with_no_batch_dims_saveable``) and recomputes
the rest.  ``"offload"`` recomputes each block as ``"full"`` does and keeps
the one tensor that ``"full"`` saves, the block's input (JAX's ``"resid"``),
in pinned host memory until the backward pass needs it.  Remat changes no
number.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.mlp import MLP, RMSNorm, rmsnorm_schema, mlp_schema
from repro_torch.models.layers.moe import MoE, TreeRouter, moe_schema
from repro_torch.models.layers.rope import positions_for
from repro_torch.models.layers.ssm import CHANNEL_LEAVES, SSM, SSMState, ssm_schema, ssm_state_shape, ssm_state_spec
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P, pad_vocab
from repro_torch.utils.losses import chunked_softmax_xent

DECODER_FAMILIES = ("dense", "moe", "hybrid", "vlm")
FAMILIES = DECODER_FAMILIES + ("ssm", "audio")    # every family models.build_model builds


def _to_host(t: torch.Tensor):
    """Saved-tensor pack hook of ``"offload"``: a copy of ``t`` in host memory
    (pinned for a CUDA tensor).  The copy is queued without a host sync on
    the current stream, the stream that frees ``t``: the caching allocator
    hands ``t``'s memory only to later work on that stream, which runs after
    the copy."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=True)
    return t.device, host


def _to_device(packed) -> torch.Tensor:
    device, host = packed
    return host.to(device, non_blocking=True)


def _offloaded(checkpointed_block, x):
    """A block under a non-reentrant checkpoint whose saved input goes to the
    host.  The checkpoint saves its inputs through the hooks active around
    it and its block's own saves through its own hooks, so ``x`` is the one
    tensor packed (``tests/test_torch_train.py`` counts it).
    ``torch.autograd.graph.save_on_cpu`` would move it too, but its copy
    waits for the card, a host sync a block."""
    with torch.autograd.graph.saved_tensors_hooks(_to_host, _to_device):
        return checkpointed_block(x)


class DecodeCache(NamedTuple):
    kv: attn.KVCache          # stacked (L, B, S_max, KV, hd)
    ssm: Optional[SSMState]   # the hybrid family's, stacked (L, …); else None
    pos: int                  # tokens already in the cache


class Block(nn.Module):
    """One transformer block: attention (beside an SSM head in the hybrid
    family), then the MoE or dense MLP."""

    def __init__(self, cfg: ModelConfig, device, axes: shd.MeshAxes | None = None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes or shd.single_device_axes()
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg, device, axes)
        else:
            self.mlp = MLP(cfg, device)
        if cfg.family == "hybrid":
            self.ssm = SSM(cfg, device)

    def model_local_names(self, decode: bool) -> set:
        """The weights a step split over ``model`` takes as this rank's block
        (``shd.gather(keep_model=True)``, where they are sharded over it): the
        experts and the SSM's channel leaves; at decode also the attention's
        (its heads, where the cache splits by heads) and the dense or shared
        FFN's ``d_ff`` slices."""
        names = {"moe.wi", "moe.wg", "moe.wo"} if self.cfg.moe is not None else set()
        if self.cfg.family == "hybrid":
            names |= {f"ssm.{n}" for n in CHANNEL_LEAVES}
        if decode:
            if attn.cache_split_by_heads(self.cfg, self.axes):
                names |= {"attn.wq", "attn.wk", "attn.wv", "attn.wo"}
            names |= {"mlp.wi", "mlp.wg", "mlp.wo", "moe.shared_wi", "moe.shared_wg", "moe.shared_wo"}
        return names

    def model_partial_names(self) -> set:
        """The whole weights of which each rank of a split step uses its own
        slice: the SSM's ``in_proj`` (its ``x_in`` and ``z`` columns)."""
        return {"ssm.in_proj"} if self.cfg.family == "hybrid" else set()

    def _ffn(self, h2, *, group_size: int, serve_hard_tree: bool):
        if self.cfg.moe is not None:
            return self.moe(h2, group_size=group_size, serve_hard_tree=serve_hard_tree)
        y = self.mlp(h2)
        if self.mlp.wi.shape[1] < self.cfg.d_ff:       # this rank's d_ff slice (split decode)
            y = shd.model_sum(y)
        return y, None

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
    """The decoder LM; ``device=None`` is the card (raises without one).
    ``axes`` (default: one device) are the mesh's, whose ``model`` size pads
    the vocabulary and the experts."""

    def __init__(self, cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None, *,
                 axes: shd.MeshAxes | None = None):
        super().__init__()
        if cfg.family not in DECODER_FAMILIES:
            raise ValueError(f"family {cfg.family!r} ({cfg.name}) is not a decoder-only family: "
                             "build it with models.build_model")
        dev = _device.resolve(None, device)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.axes = axes or shd.single_device_axes()
        self.stacks = {"layers": cfg.n_layers}
        self.v_pad = pad_vocab(cfg.vocab_size, self.axes)
        # The table's module is named "embed" for the state_dict key
        # "embed.table"; the method embed() shadows the attribute, so the
        # module is reached as self._modules["embed"] (embed_table).
        self.embed = sch.SchemaModule({"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)}, dev)
        self.layers = nn.ModuleList(Block(cfg, dev, self.axes) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = sch.SchemaModule({"w": sch.PSpec((cfg.d_model, self.v_pad), dtype=cfg.p_dtype)}, dev)

    # ----------------------------- schema -----------------------------

    def layer_schema(self) -> dict:
        cfg, axes = self.cfg, self.axes
        out = {"ln1": rmsnorm_schema(cfg), "attn": attn.attn_schema(cfg, axes), "ln2": rmsnorm_schema(cfg)}
        if cfg.moe is not None:
            out["moe"] = moe_schema(cfg, axes)
        else:
            out["mlp"] = mlp_schema(cfg, axes)
        if cfg.family == "hybrid":
            out["ssm"] = ssm_schema(cfg, axes)
        return out

    def schema(self) -> dict:
        """The JAX model's schema with the layers stacked (L, …), as its
        scanned stack (:meth:`jax_leaves` unstacks them without ``scan_layers``)."""
        cfg, axes = self.cfg, self.axes
        d_fsdp = axes.fsdp_if(cfg.d_model)
        out = {
            "embed": {"table": sch.PSpec((self.v_pad, cfg.d_model), P(axes.tp_axis, d_fsdp), dtype=cfg.p_dtype)},
            "layers": sch.stacked(self.layer_schema(), cfg.n_layers),
            "final_norm": rmsnorm_schema(cfg),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = {"w": sch.PSpec((cfg.d_model, self.v_pad), P(d_fsdp, axes.tp_axis), dtype=cfg.p_dtype)}
        return out

    @property
    def scanned(self) -> bool:
        return self.parallel.scan_layers

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

    # --------------------------- split over 'model' ---------------------------

    def model_split(self, batch: dict) -> bool | None:
        """None on one device and with ``tp`` off or ``model`` 1; else True
        where the residual is sequence-split (``parallel.
        seq_shard`` on and ``free_model_seq`` naming ``model`` for the global
        batch), False where the ranks of ``model`` hold the same tokens."""
        if not self.splits():
            return None
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        b, s = x.shape[:2]
        return bool(self.parallel.seq_shard and shd.free_model_seq(self.axes, b, s) == self.axes.model)

    def cache_split(self) -> tuple[str | None, int, int]:
        """("heads" | "seq" | None, |model|, this rank's index on it): how this
        rank's decode cache splits (:meth:`cache_specs`)."""
        if not self.splits():
            return None, 1, 0
        m = self.axes.model_size
        r = self.mesh.get_coordinate()[shd.model_dim(self.mesh, self.axes)]
        return ("heads" if attn.cache_split_by_heads(self.cfg, self.axes) else "seq"), m, r

    def _seq_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's positions of ``t`` along ``dim`` under a sequence split."""
        ms = shd.active_model()
        if ms is None or not ms.seq:
            return t
        n = t.shape[dim] // ms.size
        return t.narrow(dim, ms.index * n, n)

    def embed(self, batch: dict) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x (B,S,D) in the activation dtype, positions) for ``batch``'s
        ``tokens`` (B,S) or ``embeds`` (B,S,D).  Under a sequence split, this
        rank's positions, at their global offsets (JAX's ``_constrain_resid``
        after the gather, ``lm.py:116-121``); under split decode the lookup
        is vocab-sharded, summed over ``model``."""
        cfg = self.cfg
        ms = shd.active_model()
        if cfg.embeds_input:
            x = self._seq_slice(batch["embeds"], 1).to(cfg.act_dtype)
        else:
            tokens = self._seq_slice(batch["tokens"], 1).long()
            table = self.embed_table
            if isinstance(table, DTensor):      # split decode: this rank's vocabulary rows
                x = shd.vocab_lookup(shd.gather(table, keep_model=True).to(cfg.act_dtype), tokens, ms)
            else:
                # the table is cast before the gather, as in JAX: in training the
                # gradient then accumulates repeated tokens in the activation dtype
                x = table.to(cfg.act_dtype)[tokens]
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is not None:
            positions = self._seq_slice(positions, positions.dim() - 1)
        elif cfg.rope_style != "none":
            offset = ms.index * s if ms is not None and ms.seq else 0
            positions = positions_for(b, s, style=cfg.rope_style, offset=offset, device=x.device)
        return x, positions

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``x @`` the output projection.  Under split compute ``x`` is this
        rank's positions (sequence split) or the whole (else), and the
        result this rank's ``V_pad/|model|`` columns of every position
        (JAX's ``P(batch, None, model)``, ``lm.py:195-203``)."""
        return self._every_position(x) @ self._out_w(x.dtype)

    @staticmethod
    def _every_position(x: torch.Tensor) -> torch.Tensor:
        """Under split compute, every position of this rank's rows for a
        vocab-sharded projection: all-gathered along a split sequence, else
        entering the split (its gradient summed over ``model``)."""
        ms = shd.active_model()
        return x if ms is None else shd.whole_tokens(x, ms)

    def _remat(self, fn):
        """``fn`` (one block) wrapped as ``parallel.remat`` says; see the module
        docstring.  As in the JAX package, only the scanned layer stack is
        rematerialized."""
        mode = self.parallel.remat
        if not self.parallel.scan_layers:
            return fn
        if mode == "offload" and torch.is_grad_enabled():
            return functools.partial(_offloaded, sch.checkpointed(fn, "full"))
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

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(total, {"nll", "aux"}): the chunked next-token cross-entropy over
        ``batch["labels"]`` (negative ids masked, the padded vocabulary
        excluded) plus the MoE load-balance loss, all 0-d f32."""
        x, aux = self.hidden(batch)
        x = self._every_position(x)
        nll, _ = chunked_softmax_xent(x, self._out_w(x.dtype), batch["labels"], vocab_size=self.cfg.vocab_size,
                                      shards=shd.active_model())
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------- decode -------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> DecodeCache:
        """The cache's shapes and dtypes as meta tensors (nothing allocated)."""
        return self.init_cache(batch, max_len, device="meta")

    def init_cache(self, batch: int, max_len: int, device=None) -> DecodeCache:
        """The zero cache of ``batch`` rows and ``max_len`` positions; on a mesh
        whose ``model`` splits the cache (:meth:`cache_split`), this rank's
        shard of it: its KV heads, or its ``max_len/|model|`` positions, and
        the hybrid family's SSM state its ``d_inner/|model|`` channels."""
        cfg = self.cfg
        shape, dtype = attn.cache_shape(cfg, batch, max_len)
        layout, m, _ = self.cache_split()
        if layout == "heads":
            shape = (shape[0], shape[1], shape[2] // m, shape[3])
        elif layout == "seq":
            if max_len % m:
                raise ValueError(f"a cache of {max_len} positions does not split over model={m}")
            shape = (shape[0], shape[1] // m, *shape[2:])
        dev = self.device if device is None else device
        k = torch.zeros((cfg.n_layers, *shape), dtype=dtype, device=dev)
        sstate = None
        if cfg.family == "hybrid":
            conv_shape, conv_dtype, h_shape, h_dtype = ssm_state_shape(cfg, batch, m)
            sstate = SSMState(conv=torch.zeros((cfg.n_layers, *conv_shape), dtype=conv_dtype, device=dev),
                              h=torch.zeros((cfg.n_layers, *h_shape), dtype=h_dtype, device=dev))
        return DecodeCache(kv=attn.KVCache(k=k, v=torch.zeros_like(k)), ssm=sstate, pos=0)

    def cache_specs(self, global_batch: int = 0) -> DecodeCache:
        """The JAX model's cache specs (``src/repro/models/lm.py:265``): batch
        over the batch axes that divide it, KV heads (else the sequence)
        over a free ``model`` axis, the stack dim unsharded, the hybrid
        family's SSM state by ``d_inner``.  A split rank's cache is its block
        of these (:meth:`init_cache`)."""
        cfg, axes = self.cfg, self.axes
        kv = attn.cache_spec(cfg, axes, global_batch)
        kv = attn.KVCache(k=P(None, *kv.k), v=P(None, *kv.v))
        sstate = None
        if cfg.family == "hybrid":
            ss = ssm_state_spec(cfg, axes, global_batch)
            sstate = SSMState(conv=P(None, *ss.conv), h=P(None, *ss.h))
        return DecodeCache(kv=kv, ssm=sstate, pos=P())

    def _write_prefill_cache(self, cache: DecodeCache, i: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Layer ``i``'s K/V of the whole prompt (B, S, KV, hd) into this rank's
        shard of the cache."""
        s = k.shape[1]
        layout, m, r = self.cache_split()
        if layout == "heads":
            n = k.shape[2] // m
            k, v = k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n]
        elif layout == "seq":
            n = cache.kv.k.shape[2]
            k, v = k[:, r * n:min(s, (r + 1) * n)], v[:, r * n:min(s, (r + 1) * n)]
            s = k.shape[1]
        if s:
            cache.kv.k[i, :, :s] = k
            cache.kv.v[i, :, :s] = v

    @torch.no_grad()
    def decode_step(self, cache: DecodeCache, batch: dict) -> tuple[torch.Tensor, DecodeCache]:
        """One token for every sequence in the batch: ``{"tokens": (B,1)}`` (or
        ``{"embeds": (B,1,D)}``); positions are ``cache.pos``.  Writes the
        cache (KV and SSM state) in place and returns it with ``pos + 1``.
        Across cards ``batch`` is the global one and the cache and logits
        this rank's rows (:meth:`~repro_torch.models.schema.SchemaModel.on_batch_shards`);
        under split compute the cache is this rank's shard and the logits
        this rank's vocabulary columns (:meth:`gathered_logits` gathers them)."""
        with self.on_batch_shards(batch, decode=True) as local:
            return self._decode_step(cache, local)

    def _decode_step(self, cache: DecodeCache, batch: dict) -> tuple[torch.Tensor, DecodeCache]:
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
            with self.block_weights(layer):
                x, new_ss = layer.decode(x, kv, pos, positions, is_g, ss)
            if new_ss is not None:
                cache.ssm.conv[i].copy_(new_ss.conv)
                cache.ssm.h[i].copy_(new_ss.h)
        logits = self.final_norm(x) @ self._out_w(x.dtype)
        return logits, cache._replace(pos=pos + 1)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int | None = None) -> tuple[torch.Tensor, DecodeCache]:
        """Forward + cache construction; the tree router routes hard.

        ``max_len``: cache capacity; defaults to the prompt length.  Serving
        passes prompt + generation budget.  Returns the last position's
        logits (B,1,V_pad) and the cache with ``pos`` = prompt length.  The
        hybrid family's SSM state gets the conv tail and a zero ``h`` (see
        the module docstring).  Across cards ``batch`` is the global one and
        the logits and cache this rank's rows; under split compute the cache
        is this rank's shard and the logits this rank's vocabulary columns
        (:meth:`decode_step`).
        """
        with self.on_batch_shards(batch) as local:
            return self._prefill(local, max_len)

    def _prefill(self, batch: dict, max_len: int | None) -> tuple[torch.Tensor, DecodeCache]:
        cfg = self.cfg
        x, positions = self.embed(batch)
        ms = shd.active_model()
        b = x.shape[0]
        s = x.shape[1] * (ms.size if ms is not None and ms.seq else 1)
        cache = self.init_cache(b, max(s, max_len or s))
        hard = cfg.moe is not None and cfg.moe.router == "tree"
        for i, (layer, is_g) in enumerate(zip(self.layers, self._is_global_flags())):
            x, _, k, v, ss = layer(x, positions, is_g, serve_hard_tree=hard,
                                   kv_block=self.parallel.attn_kv_block)
            self._write_prefill_cache(cache, i, k, v)
            if ss is not None:
                cache.ssm.conv[i] = ss.conv        # h stays zero, as in JAX
        last = x[:, -1:, :]
        if ms is not None and ms.seq:           # the last position is the last rank's
            last = shd.model_gather(last, dim=1)[:, -1:]
        logits = self.final_norm(last) @ self._out_w(last.dtype)
        return logits, cache._replace(pos=s)
