"""Encoder-decoder model (the whisper-medium backbone).

The port's counterpart of the JAX package's ``models/encdec.py``.  The conv
audio frontend is a stub: a batch carries precomputed frame embeddings
``embeds`` (B, F, d_model) beside the decoder's ``tokens``.  The encoder
adds fixed sinusoidal positions and runs bidirectional attention; the
decoder is causal, with cross-attention to the encoder output and learned
positions (a table of ``max_positions`` rows).  Both stacks are stacked
(L, …) in the JAX schema, so the ``state_dict`` key
``dec_layers.3.cross.wq`` is the JAX leaf ``params["dec_layers"]["cross"]
["wq"][3]``.

Decode caches the decoder's self-attention K/V (written in place) and each
layer's cross-attention K/V, computed once from the encoder output at
prefill.  A decoder position past the table's end reads its last rows: JAX
takes them with ``lax.dynamic_slice_in_dim``, which clamps the start, and
the port clamps alike (ROADMAP.md §3 item 15).

Rematerialization, while grad is enabled, of every encoder and decoder
layer: ``"none"``, ``"dots"``, else (``"full"``, ``"offload"``) the whole
layer, as the JAX model's ``_remat`` (only the decoder families move a
saved input to the host under ``"offload"``).

Across cards with ``tp`` on and ``model`` > 1 the step splits over
``model`` as the JAX mesh program lays it out
(:meth:`EncDecModel.model_split`).  The encoder's residual stays whole on
the ranks of a ``model`` row (``src/repro/models/encdec.py:131``, ``:139``):
its attention and MLP run on the rank's heads and ``d_ff`` block and their
partial outputs are summed over ``model``.  The decoder's residual is
sequence-split where ``parallel.seq_shard`` is on and ``free_model_seq``
names ``model`` (``:169``, ``:262-264``): causal self-attention against
K/V gathered along the sequence, cross-attention from the rank's positions
to the whole encoder output.  The tied logits and the loss are
vocab-sharded (``:195``).  Decode splits the self-attention cache by KV
heads, else by sequence, and the cross cache by heads (``:220-235``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.mlp import MLP, RMSNorm, mlp_schema, rmsnorm_schema
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P, pad_vocab
from repro_torch.utils.losses import chunked_softmax_xent


class EncDecCache(NamedTuple):
    self_kv: attn.KVCache     # (L, B, S_max, KV, hd) decoder self-attention
    cross_kv: attn.KVCache    # (L, B, F, KV, hd) the encoder's K/V per layer
    pos: int


def sinusoid_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n_pos, d), f32."""
    half = d // 2
    log_timescale = np.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    scaled = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


class EncoderBlock(nn.Module):
    """One encoder layer.  Under split compute it runs the rank's heads and
    ``d_ff`` block on the whole frames every rank holds, and sums the
    partial outputs over ``model``."""

    # the encoder's tokens are the same on every rank of a 'model' row, also
    # in a step whose decoder is sequence-split (its whole weights' gradients)
    tokens_split = False

    def __init__(self, cfg: ModelConfig, device, axes: shd.MeshAxes | None = None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes or shd.single_device_axes()
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def splits(self) -> bool:
        """Whether the heads and ``d_ff`` divide ``model`` (else the layer runs
        whole on every rank of a ``model`` row)."""
        cfg, m = self.cfg, self.axes.model_size
        return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0 and cfg.d_ff % m == 0

    def model_local_names(self, decode: bool) -> set:
        """The heads' projections and the MLP's ``d_ff`` block."""
        if not self.splits():
            return set()
        return {"attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi", "mlp.wg", "mlp.wo"}

    def forward(self, x):
        ms = shd.active_model()
        if ms is None or not self.splits():
            x = x + attn.attention(self.attn.params, self.ln1(x), cfg=self.cfg, positions=None, causal=False)
            return x + self.mlp(self.ln2(x))
        p = self.attn.params
        a = attn.attention(p, shd.enter_split(self.ln1(x), ms), cfg=attn.local_heads_cfg(self.cfg, p),
                           positions=None, causal=False)
        x = x + shd.model_sum(a, ms)
        return x + shd.model_sum(self.mlp(shd.enter_split(self.ln2(x), ms)), ms)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device, axes: shd.MeshAxes | None = None):
        super().__init__()
        self.cfg = cfg
        self.axes = axes or shd.single_device_axes()
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln_x = RMSNorm(cfg, device)
        self.cross = sch.SchemaModule(attn.attn_schema(cfg), device)
        self.ln2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def model_local_names(self, decode: bool) -> set:
        """At split decode: the self-attention's heads where the cache splits
        by heads, the cross-attention's heads where its cache does, and the
        MLP's ``d_ff`` block; a full sequence uses the whole weights."""
        if not decode:
            return set()
        names = {"mlp.wi", "mlp.wg", "mlp.wo"}
        if attn.cache_split_by_heads(self.cfg, self.axes):
            names |= {f"{m}.{w}" for m in ("attn", "cross") for w in ("wq", "wk", "wv", "wo")}
        return names

    def forward(self, x, enc_out):
        """Teacher-forced (JAX ``_dec_layer``): cross-attention projects the
        encoder output here.  On a sequence-split residual ``x`` holds this
        rank's positions and ``enc_out`` every frame."""
        a, _, _ = self.attn(self.ln1(x), None)
        x = x + a
        x = x + attn.attention(self.cross.params, self.ln_x(x), cfg=self.cfg, positions=None, kv_x=enc_out)
        return x + self.mlp(self.ln2(x))

    def prefill(self, x, enc_out):
        """As :meth:`forward`, through the cross cache; returns (x, k, v, cross)
        (``k``/``v`` the whole prompt's)."""
        a, k, v = self.attn(self.ln1(x), None)
        x = x + a
        cross = attn.cross_cache_from_encoder(self.cross.params, enc_out, self.cfg)
        x = x + attn.cross_attention_cached(self.cross.params, self.ln_x(x), cross, cfg=self.cfg)
        return x + self.mlp(self.ln2(x)), k, v, cross

    def decode(self, x, kv: attn.KVCache, cross: attn.KVCache, pos: int):
        """One token against this layer's caches; under split decode each in
        its layout (heads where this rank holds its heads' slices)."""
        a, _ = self.attn.decode(self.ln1(x), kv, pos, None)
        x = x + a
        ms = shd.active_model()
        p = self.cross.params
        if ms is not None and p["wq"].shape[1] < self.cfg.n_heads * self.cfg.head_dim_:
            c = attn.cross_attention_cached(p, self.ln_x(x), cross, cfg=attn.local_heads_cfg(self.cfg, p))
            x = x + shd.model_sum(c, ms)
        else:
            x = x + attn.cross_attention_cached(p, self.ln_x(x), cross, cfg=self.cfg)
        y = self.mlp(self.ln2(x))
        if self.mlp.wi.shape[1] < self.cfg.d_ff:       # this rank's d_ff slice (split decode)
            y = shd.model_sum(y, ms)
        return x + y


class EncDecModel(sch.SchemaModel):
    """The encoder-decoder; ``device=None`` is the card (raises without one)."""

    def __init__(self, cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None,
                 max_positions: int = 32_768, *, axes: shd.MeshAxes | None = None):
        super().__init__()
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder config")
        dev = _device.resolve(None, device)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.axes = axes or shd.single_device_axes()
        self.max_positions = max_positions
        self.stacks = {"enc_layers": cfg.encoder.n_layers, "dec_layers": cfg.n_layers}
        self.v_pad = pad_vocab(cfg.vocab_size, self.axes)
        self.embed = sch.SchemaModule({"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)}, dev)
        self.pos_embed = nn.Parameter(torch.empty((max_positions, cfg.d_model), dtype=cfg.p_dtype, device=dev))
        self.enc_layers = nn.ModuleList(EncoderBlock(cfg, dev, self.axes) for _ in range(cfg.encoder.n_layers))
        self.enc_norm = RMSNorm(cfg, dev)
        self.dec_layers = nn.ModuleList(DecoderBlock(cfg, dev, self.axes) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, dev)

    def _meta_copy(self, cfg) -> "EncDecModel":
        return EncDecModel(cfg, device="meta", parallel=self.parallel, max_positions=self.max_positions,
                           axes=self.axes)

    # ----------------------------- schema -----------------------------

    def schema(self) -> dict:
        cfg, axes = self.cfg, self.axes
        enc_layer = {"ln1": rmsnorm_schema(cfg), "attn": attn.attn_schema(cfg, axes), "ln2": rmsnorm_schema(cfg),
                     "mlp": mlp_schema(cfg, axes)}
        dec_layer = {"ln1": rmsnorm_schema(cfg), "attn": attn.attn_schema(cfg, axes), "ln_x": rmsnorm_schema(cfg),
                     "cross": attn.attn_schema(cfg, axes), "ln2": rmsnorm_schema(cfg),
                     "mlp": mlp_schema(cfg, axes)}
        return {
            "embed": {"table": sch.PSpec((self.v_pad, cfg.d_model), P(axes.tp_axis, None), dtype=cfg.p_dtype)},
            "pos_embed": sch.PSpec((self.max_positions, cfg.d_model), P(None, None), dtype=cfg.p_dtype),
            "enc_layers": sch.stacked(enc_layer, cfg.encoder.n_layers),
            "enc_norm": rmsnorm_schema(cfg),
            "dec_layers": sch.stacked(dec_layer, cfg.n_layers),
            "final_norm": rmsnorm_schema(cfg),
        }

    def _remat(self, fn):
        return sch.checkpointed(fn, self.parallel.remat)

    # --------------------------- split over 'model' ---------------------------

    def model_split(self, batch: dict) -> bool | None:
        """None on one device and with ``tp`` off or ``model`` 1; else True
        where the decoder's residual is sequence-split (``parallel.
        seq_shard`` on and ``free_model_seq`` naming ``model`` for the
        decoder's tokens), False where its ranks hold the same tokens.  The
        encoder splits its heads and ``d_ff`` either way, where they divide
        ``model``."""
        if not self.splits():
            return None
        b, s = batch["tokens"].shape[:2]
        return bool(self.parallel.seq_shard and shd.free_model_seq(self.axes, b, s) == self.axes.model)

    def top_local_names(self, decode: bool) -> set:
        """The tied table's (the default's) and the encoder's final norm,
        gathered with the encoder's tokens the same on every rank of a
        ``model`` row (:meth:`encode`)."""
        return super().top_local_names(decode) | {"enc_norm.scale"}

    def cache_split(self) -> tuple[str | None, int, int]:
        """("heads" | "seq" | None, |model|, this rank's index on it): how this
        rank's self-attention cache splits (:meth:`cache_specs`); the cross
        cache splits by heads where this one does, else not."""
        if not self.splits():
            return None, 1, 0
        r = self.mesh.get_coordinate()[shd.model_dim(self.mesh, self.axes)]
        return ("heads" if attn.cache_split_by_heads(self.cfg, self.axes) else "seq"), self.axes.model_size, r

    # ------------------------------ encoder ------------------------------

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, F, D) frame embeddings → the encoder output (B, F, D), the
        same on every rank of a ``model`` row under split compute."""
        cfg = self.cfg
        f = embeds.shape[1]
        x = embeds.to(cfg.act_dtype)
        x = x + sinusoid_positions(f, cfg.d_model, device=x.device).to(cfg.act_dtype)[None]
        for layer in self.enc_layers:
            x = self._remat(layer)(x)
        if shd.active_model() is None:
            return self.enc_norm(x)
        with shd.gathered(self, ["enc_norm.scale"], seq=False):
            return self.enc_norm(x)

    # ------------------------------ decoder ------------------------------

    def _embed_tokens(self, tokens: torch.Tensor, pos_start: int) -> torch.Tensor:
        """Token rows plus the learned positions from ``pos_start``, the start
        clamped into the table as ``lax.dynamic_slice_in_dim`` clamps it.
        Under a sequence split, this rank's positions at their global rows;
        under split decode the lookup is vocab-sharded."""
        act = self.cfg.act_dtype
        s = tokens.shape[1]
        start = min(max(pos_start, 0), self.max_positions - s)
        ms = shd.active_model()
        if ms is not None and ms.seq:
            n = s // ms.size
            tokens, start, s = tokens[:, ms.index * n:(ms.index + 1) * n], start + ms.index * n, n
        table = self.embed.table
        if isinstance(table, DTensor):          # split decode: this rank's vocabulary rows
            x = shd.vocab_lookup(shd.gather(table, keep_model=True).to(act), tokens.long(), ms)
        else:
            x = table.to(act)[tokens.long()]
        return x + self.pos_embed[start:start + s].to(act)[None]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``x @`` the tied table: under split compute ``x`` is this rank's
        positions (sequence split) or every position, and the result this
        rank's ``V_pad/|model|`` columns of every position."""
        ms = shd.active_model()
        if ms is not None:
            x = shd.whole_tokens(x, ms)
        return x @ self._out_w(x.dtype)

    def hidden(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Final normed decoder hidden states (B,S,D) + a zero aux loss; under
        a sequence split this rank's positions."""
        enc_out = self.encode(batch["embeds"])
        ms = shd.active_model()
        if ms is not None and ms.seq:       # each rank's positions attend to every frame
            enc_out = shd.enter_split(enc_out, ms)
        x = self._embed_tokens(batch["tokens"], 0)
        for layer in self.dec_layers:
            x = self._remat(layer)(x, enc_out)
        return self.final_norm(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decode over the full target sequence."""
        x, aux = self.hidden(batch)
        return self.logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        x, aux = self.hidden(batch)
        ms = shd.active_model()
        if ms is not None:
            x = shd.whole_tokens(x, ms)
        nll, _ = chunked_softmax_xent(x, self._out_w(x.dtype), batch["labels"], vocab_size=self.cfg.vocab_size,
                                      shards=ms)
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------- decode -------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> EncDecCache:
        """The cache's shapes and dtypes as meta tensors (nothing allocated)."""
        return self.init_cache(batch, max_len, device="meta")

    def _kv_zeros(self, batch: int, s_len: int, heads: int, device) -> attn.KVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, s_len, heads, cfg.head_dim_)
        return attn.KVCache(k=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                            v=torch.zeros(shape, dtype=cfg.act_dtype, device=device))

    def init_cache(self, batch: int, max_len: int, device=None) -> EncDecCache:
        """The zero caches; on a mesh whose ``model`` splits them
        (:meth:`cache_split`), this rank's shards: its KV heads of both, or
        its ``max_len/|model|`` positions of the self-attention cache."""
        dev = self.device if device is None else device
        layout, m, _ = self.cache_split()
        kv = self.cfg.n_kv_heads
        if layout == "seq" and max_len % m:
            raise ValueError(f"a cache of {max_len} positions does not split over model={m}")
        heads = kv // m if layout == "heads" else kv
        s_len = max_len // m if layout == "seq" else max_len
        return EncDecCache(self_kv=self._kv_zeros(batch, s_len, heads, dev),
                           cross_kv=self._kv_zeros(batch, self.cfg.encoder.n_frames, heads, dev), pos=0)

    def cache_specs(self, global_batch: int = 0) -> EncDecCache:
        """The JAX model's cache specs (``src/repro/models/encdec.py:220``);
        a split rank's caches are its blocks of these (:meth:`init_cache`)."""
        ba, seq, kv, _ = attn.cache_spec(self.cfg, self.axes, global_batch).k
        spec, cross_spec = P(None, ba, seq, kv, None), P(None, ba, None, kv, None)
        return EncDecCache(self_kv=attn.KVCache(k=spec, v=spec), cross_kv=attn.KVCache(k=cross_spec, v=cross_spec),
                           pos=P())

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int | None = None) -> tuple[torch.Tensor, EncDecCache]:
        """Encode ``batch["embeds"]`` and run the prompt ``batch["tokens"]``
        teacher-forced, building both caches.  Returns the last position's
        logits (B,1,V_pad) and the cache with ``pos`` = prompt length.
        Across cards ``batch`` is the global one and the logits and caches
        this rank's rows; under split compute the caches are this rank's
        shards and the logits its vocabulary columns (:meth:`gathered_logits`)."""
        with self.on_batch_shards(batch) as local:
            return self._prefill(local, max_len)

    def _prefill(self, batch: dict, max_len: int | None) -> tuple[torch.Tensor, EncDecCache]:
        enc_out = self.encode(batch["embeds"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, max(s, max_len or s), device=enc_out.device)
        layout, m, r = self.cache_split()
        x = self._embed_tokens(tokens, 0)
        for i, layer in enumerate(self.dec_layers):
            with self.block_weights(layer, decode=False):
                x, k, v, cross = layer.prefill(x, enc_out)
            if layout == "heads":
                n = k.shape[2] // m
                k, v, cross = k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n], attn.KVCache(
                    k=cross.k[:, :, r * n:(r + 1) * n], v=cross.v[:, :, r * n:(r + 1) * n])
            elif layout == "seq":
                n = cache.self_kv.k.shape[2]
                k, v = k[:, r * n:min(s, (r + 1) * n)], v[:, r * n:min(s, (r + 1) * n)]
            cache.self_kv.k[i, :, :k.shape[1]] = k
            cache.self_kv.v[i, :, :v.shape[1]] = v
            cache.cross_kv.k[i] = cross.k
            cache.cross_kv.v[i] = cross.v
        last = x[:, -1:, :]
        ms = shd.active_model()
        if ms is not None and ms.seq:           # the last position is the last rank's
            last = shd.model_gather(last, dim=1)[:, -1:]
        logits = self.final_norm(last) @ self._out_w(last.dtype)
        return logits, cache._replace(pos=s)

    @torch.no_grad()
    def decode_step(self, cache: EncDecCache, batch: dict) -> tuple[torch.Tensor, EncDecCache]:
        """One token per sequence: ``{"tokens": (B, 1)}``.  Writes the
        self-attention cache in place and returns it with ``pos + 1``.
        Across cards ``batch`` is the global one and the cache and logits
        this rank's rows; under split compute the caches are this rank's
        shards and the logits its vocabulary columns."""
        with self.on_batch_shards(batch, decode=True) as local:
            return self._decode_step(cache, local)

    def _decode_step(self, cache: EncDecCache, batch: dict) -> tuple[torch.Tensor, EncDecCache]:
        pos = cache.pos
        x = self._embed_tokens(batch["tokens"], pos)
        for i, layer in enumerate(self.dec_layers):
            kv = attn.KVCache(k=cache.self_kv.k[i], v=cache.self_kv.v[i])
            cross = attn.KVCache(k=cache.cross_kv.k[i], v=cache.cross_kv.v[i])
            with self.block_weights(layer):
                x = layer.decode(x, kv, cross, pos)
        x = self.final_norm(x)
        return x @ self._out_w(x.dtype), cache._replace(pos=pos + 1)
