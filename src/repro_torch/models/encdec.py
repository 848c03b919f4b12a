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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

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
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x):
        x = x + attn.attention(self.attn.params, self.ln1(x), cfg=self.cfg, positions=None, causal=False)
        return x + self.mlp(self.ln2(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.ln_x = RMSNorm(cfg, device)
        self.cross = sch.SchemaModule(attn.attn_schema(cfg), device)
        self.ln2 = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, enc_out):
        """Teacher-forced (JAX ``_dec_layer``): cross-attention projects the
        encoder output here."""
        a, _, _ = self.attn(self.ln1(x), None)
        x = x + a
        x = x + attn.attention(self.cross.params, self.ln_x(x), cfg=self.cfg, positions=None, kv_x=enc_out)
        return x + self.mlp(self.ln2(x))

    def prefill(self, x, enc_out):
        """As :meth:`forward`, through the cross cache; returns (x, k, v, cross)."""
        a, k, v = self.attn(self.ln1(x), None)
        x = x + a
        cross = attn.cross_cache_from_encoder(self.cross.params, enc_out, self.cfg)
        x = x + attn.cross_attention_cached(self.cross.params, self.ln_x(x), cross, cfg=self.cfg)
        return x + self.mlp(self.ln2(x)), k, v, cross

    def decode(self, x, kv: attn.KVCache, cross: attn.KVCache, pos: int):
        a, _ = self.attn.decode(self.ln1(x), kv, pos, None)
        x = x + a
        x = x + attn.cross_attention_cached(self.cross.params, self.ln_x(x), cross, cfg=self.cfg)
        return x + self.mlp(self.ln2(x))


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
        self.enc_layers = nn.ModuleList(EncoderBlock(cfg, dev) for _ in range(cfg.encoder.n_layers))
        self.enc_norm = RMSNorm(cfg, dev)
        self.dec_layers = nn.ModuleList(DecoderBlock(cfg, dev) for _ in range(cfg.n_layers))
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

    # ------------------------------ encoder ------------------------------

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """(B, F, D) frame embeddings → the encoder output (B, F, D)."""
        cfg = self.cfg
        f = embeds.shape[1]
        x = embeds.to(cfg.act_dtype)
        x = x + sinusoid_positions(f, cfg.d_model, device=x.device).to(cfg.act_dtype)[None]
        for layer in self.enc_layers:
            x = self._remat(layer)(x)
        return self.enc_norm(x)

    # ------------------------------ decoder ------------------------------

    def _embed_tokens(self, tokens: torch.Tensor, pos_start: int) -> torch.Tensor:
        """Token rows plus the learned positions from ``pos_start``, the start
        clamped into the table as ``lax.dynamic_slice_in_dim`` clamps it."""
        act = self.cfg.act_dtype
        x = self.embed.table.to(act)[tokens.long()]
        s = tokens.shape[1]
        start = min(max(pos_start, 0), self.max_positions - s)
        return x + self.pos_embed[start:start + s].to(act)[None]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embed.table.to(x.dtype).T       # whisper ties its embeddings

    def hidden(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Final normed decoder hidden states (B,S,D) + a zero aux loss."""
        enc_out = self.encode(batch["embeds"])
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
        w = self.embed.table.to(x.dtype).T
        nll, _ = chunked_softmax_xent(x, w, batch["labels"], vocab_size=self.cfg.vocab_size)
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------- decode -------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> EncDecCache:
        """The cache's shapes and dtypes as meta tensors (nothing allocated)."""
        return self.init_cache(batch, max_len, device="meta")

    def _kv_zeros(self, batch: int, s_len: int, device) -> attn.KVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, s_len, cfg.n_kv_heads, cfg.head_dim_)
        return attn.KVCache(k=torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                            v=torch.zeros(shape, dtype=cfg.act_dtype, device=device))

    def init_cache(self, batch: int, max_len: int, device=None) -> EncDecCache:
        dev = self.device if device is None else device
        return EncDecCache(self_kv=self._kv_zeros(batch, max_len, dev),
                           cross_kv=self._kv_zeros(batch, self.cfg.encoder.n_frames, dev), pos=0)

    def cache_specs(self, global_batch: int = 0) -> EncDecCache:
        """The JAX model's cache specs (``src/repro/models/encdec.py:220``)."""
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
        this rank's rows."""
        with self.on_batch_shards(batch) as local:
            return self._prefill(local, max_len)

    def _prefill(self, batch: dict, max_len: int | None) -> tuple[torch.Tensor, EncDecCache]:
        enc_out = self.encode(batch["embeds"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        self_kv = self._kv_zeros(b, max(s, max_len or s), enc_out.device)
        crosses = []
        x = self._embed_tokens(tokens, 0)
        for i, layer in enumerate(self.dec_layers):
            with self.block_weights(layer):
                x, k, v, cross = layer.prefill(x, enc_out)
            self_kv.k[i, :, :s] = k
            self_kv.v[i, :, :s] = v
            crosses.append(cross)
        cross_kv = attn.KVCache(k=torch.stack([c.k for c in crosses]), v=torch.stack([c.v for c in crosses]))
        logits = self.logits(self.final_norm(x[:, -1:, :]))
        return logits, EncDecCache(self_kv=self_kv, cross_kv=cross_kv, pos=s)

    @torch.no_grad()
    def decode_step(self, cache: EncDecCache, batch: dict) -> tuple[torch.Tensor, EncDecCache]:
        """One token per sequence: ``{"tokens": (B, 1)}``.  Writes the
        self-attention cache in place and returns it with ``pos + 1``.
        Across cards ``batch`` is the global one and the cache and logits
        this rank's rows."""
        with self.on_batch_shards(batch) as local:
            return self._decode_step(cache, local)

    def _decode_step(self, cache: EncDecCache, batch: dict) -> tuple[torch.Tensor, EncDecCache]:
        pos = cache.pos
        x = self._embed_tokens(batch["tokens"], pos)
        for i, layer in enumerate(self.dec_layers):
            kv = attn.KVCache(k=cache.self_kv.k[i], v=cache.self_kv.v[i])
            cross = attn.KVCache(k=cache.cross_kv.k[i], v=cache.cross_kv.v[i])
            with self.block_weights(layer):
                x = layer.decode(x, kv, cross, pos)
        return self.logits(self.final_norm(x)), cache._replace(pos=pos + 1)
