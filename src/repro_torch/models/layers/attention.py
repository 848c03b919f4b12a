"""Grouped-query attention with RoPE/M-RoPE, sliding windows, cross-attention
and KV-cache decode.

The port's counterpart of the JAX package's ``models/layers/attention.py``,
in the same formulation (plain torch, no library attention kernel):

  * q heads are grouped over kv heads (GQA): q is reshaped to
    (B, S, KV, G, hd) with G = n_heads // n_kv_heads, and scores come from a
    grouped einsum, so K/V are never repeated to H heads;
  * scores and softmax in float32 with masked scores at ``NEG_INF``;
    outputs in the activation dtype;
  * full sequences longer than one KV block run **blockwise** (online
    softmax over KV chunks, a loop where JAX scans), with masks computed
    per chunk from global positions;
  * decode (Sq = 1) takes the direct path against the whole cache, which
    is written in place (a slice copy at the cache position) where JAX
    returns a new one;
  * cross-attention (the encoder-decoder's) projects K/V from the encoder
    output, unmasked and without RoPE; serving computes them once per
    request (:func:`cross_cache_from_encoder`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.rope import apply_mrope, apply_rope
from repro_torch.models.schema import PSpec, SchemaModule

NEG_INF = -1e30
DEFAULT_KV_BLOCK = 1024


def attn_schema(cfg: ModelConfig) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo``; a cross-attention block's are the same."""
    hd = cfg.head_dim_
    d = cfg.d_model
    return {
        "wq": PSpec((d, cfg.n_heads * hd), dtype=cfg.p_dtype),
        "wk": PSpec((d, cfg.n_kv_heads * hd), dtype=cfg.p_dtype),
        "wv": PSpec((d, cfg.n_kv_heads * hd), dtype=cfg.p_dtype),
        "wo": PSpec((cfg.n_heads * hd, d), dtype=cfg.p_dtype),
    }


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, KV, hd), or (L, B, S_max, KV, hd) stacked
    v: torch.Tensor


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> tuple[tuple, torch.dtype]:
    """(shape, dtype) of one layer's K (and V) cache."""
    return (batch, max_len, cfg.n_kv_heads, cfg.head_dim_), cfg.act_dtype


def _project_qkv(params, x, kv_x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    k = (src @ params["wk"].to(x.dtype)).reshape(b, sk, cfg.n_kv_heads, hd)
    v = (src @ params["wv"].to(x.dtype)).reshape(b, sk, cfg.n_kv_heads, hd)
    if cfg.rope_style == "rope" and positions is not None:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, theta=cfg.rope_theta)
    elif cfg.rope_style == "mrope" and positions is not None:
        q = apply_mrope(q, positions, theta=cfg.rope_theta, sections=tuple(cfg.mrope_sections))
        if kv_x is None:
            k = apply_mrope(k, positions, theta=cfg.rope_theta, sections=tuple(cfg.mrope_sections))
    return q, k, v


# ---------------------------------------------------------------------------
# Direct (small / decode) path
# ---------------------------------------------------------------------------


def _grouped_attention(q, k, v, mask, cfg: ModelConfig):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable to (B,KV,G,Sq,Sk)."""
    b, sq, h, hd = q.shape
    kv = cfg.n_kv_heads
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32), k.to(torch.float32))
    scores = scores * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.to(torch.float32))
    return out.reshape(b, sq, h * hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise (online-softmax) path — the full-sequence default
# ---------------------------------------------------------------------------


def _block_mask(q_pos, k_pos, *, causal, window, is_global):
    """(Sq, bk) bool validity from global positions.

    causal: key ≤ query.  window > 0 additionally restricts to the last
    ``window`` positions unless ``is_global`` (a bool, per layer of a
    hybrid stack) lifts the restriction.
    """
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0 and not is_global:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def blockwise_attention(
    q: torch.Tensor,                  # (B, Sq, H, hd)
    k: torch.Tensor,                  # (B, Sk, KV, hd)
    v: torch.Tensor,                  # (B, Sk, KV, hd)
    *,
    cfg: ModelConfig,
    causal: bool = True,
    window: int = 0,
    is_global: Optional[bool] = None,
    q_offset: int = 0,
    kv_block: int = DEFAULT_KV_BLOCK,
) -> torch.Tensor:
    """Flash-style attention: loop over KV chunks with a running (m, l, acc)."""
    b, sq, h, hd = q.shape
    kvh = cfg.n_kv_heads
    g = h // kvh
    sk = k.shape[1]
    bk = min(kv_block, sk)
    while sk % bk:
        bk //= 2
    nb = sk // bk
    scale = hd ** -0.5
    dev = q.device

    qg = q.reshape(b, sq, kvh, g, hd).to(torch.float32).permute(0, 2, 3, 1, 4)   # (B,KV,G,Sq,hd)
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=dev)
    for j in range(nb):
        kc = k[:, j * bk:(j + 1) * bk].to(torch.float32)
        vc = v[:, j * bk:(j + 1) * bk].to(torch.float32)
        s = torch.einsum("bkgqh,btkh->bkgqt", qg, kc) * scale                   # (B,KV,G,Sq,bk)
        k_pos = j * bk + torch.arange(bk, device=dev)
        valid = _block_mask(q_pos, k_pos, causal=causal, window=window, is_global=is_global)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]                          # (B,KV,G,Sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * hd)
    return out.to(q.dtype)


def grouped_attention(
    q, k, v, *, cfg: ModelConfig, causal=True, window=0, is_global=None,
    q_offset: int = 0, kv_block: int = DEFAULT_KV_BLOCK,
) -> torch.Tensor:
    """Dispatch: blockwise for full sequences, direct for short ones."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 1 or sk <= kv_block:
        mask = None
        if causal:
            q_pos = q_offset + torch.arange(sq, device=q.device)
            k_pos = torch.arange(sk, device=q.device)
            mask = _block_mask(q_pos, k_pos, causal=causal, window=window, is_global=is_global)
        return _grouped_attention(q, k, v, mask, cfg)
    return blockwise_attention(
        q, k, v, cfg=cfg, causal=causal, window=window, is_global=is_global,
        q_offset=q_offset, kv_block=kv_block,
    )


def causal_mask(sq: int, sk: int, *, window: int = 0, offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Sk) mask; query i (global position i+offset) sees keys j ≤ i+offset,
    within ``window`` when sliding.  (A small-sequence and test helper; the
    model paths use arithmetic per-block masks.)"""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def attention(
    params: dict,
    x: torch.Tensor,                  # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor],
    causal: bool = True,
    window: int = 0,
    is_global=None,
    kv_x: Optional[torch.Tensor] = None,   # cross-attention source
) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross)."""
    q, k, v = _project_qkv(params, x, kv_x, cfg, positions)
    out = grouped_attention(q, k, v, cfg=cfg, causal=causal and kv_x is None, window=window,
                            is_global=is_global)
    return out @ params["wo"].to(x.dtype)


def decode_mask(cache_pos: int, s_max: int, *, window: int = 0, is_global=None, device=None) -> torch.Tensor:
    """(Sk,) validity for one decode step against a cache of length s_max."""
    t = torch.arange(s_max, device=device)
    valid = t <= cache_pos
    if window > 0 and not is_global:
        valid &= t > cache_pos - window
    return valid


def attention_decode(
    params: dict,
    x: torch.Tensor,                  # (B, 1, D)
    cache: KVCache,                   # one layer's (B, S_max, KV, hd)
    cache_pos: int,                   # index to write
    *,
    cfg: ModelConfig,
    positions: Optional[torch.Tensor],   # (B, 1) or (B, 3, 1) or None
    window: int = 0,
    is_global=None,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step against a persistent KV cache.

    Writes the new K/V into ``cache`` in place at ``cache_pos`` and returns
    it (JAX returns an updated copy).  ``cache_pos`` must lie inside the
    cache: JAX clamps an index past the end, the port raises.
    """
    q, k_new, v_new = _project_qkv(params, x, None, cfg, positions)
    s_max = cache.k.shape[1]
    if not 0 <= cache_pos < s_max:
        raise IndexError(f"cache position {cache_pos} outside a cache of {s_max}")
    # a slice copy, not index_copy_ with an index tensor: building that tensor
    # from a host int is a blocking host-to-device copy every layer
    cache.k.narrow(1, cache_pos, 1).copy_(k_new)
    cache.v.narrow(1, cache_pos, 1).copy_(v_new)
    valid = decode_mask(cache_pos, s_max, window=window, is_global=is_global, device=x.device)
    out = _grouped_attention(q, cache.k, cache.v, valid, cfg)
    return out @ params["wo"].to(x.dtype), cache


def cross_cache_from_encoder(params: dict, enc_out: torch.Tensor, cfg: ModelConfig) -> KVCache:
    """Cross-attention K/V from the encoder output, once per request."""
    b, sk, _ = enc_out.shape
    hd = cfg.head_dim_
    k = (enc_out @ params["wk"].to(enc_out.dtype)).reshape(b, sk, cfg.n_kv_heads, hd)
    v = (enc_out @ params["wv"].to(enc_out.dtype)).reshape(b, sk, cfg.n_kv_heads, hd)
    return KVCache(k=k, v=v)


def cross_attention_cached(params: dict, x: torch.Tensor, cross: KVCache, *, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, D) against precomputed encoder K/V."""
    b, s, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    out = grouped_attention(q, cross.k, cross.v, cfg=cfg, causal=False)
    return out @ params["wo"].to(x.dtype)


class Attention(SchemaModule):
    """Self-attention weights (``wq``, ``wk``, ``wv``, ``wo``) of one block."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(attn_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x, positions, *, window=0, is_global=None, kv_block=DEFAULT_KV_BLOCK):
        """Full sequence, causal: (output (B,S,D), k, v), k/v for the cache."""
        q, k, v = _project_qkv(self.params, x, None, self.cfg, positions)
        a = grouped_attention(q, k, v, cfg=self.cfg, causal=True, window=window,
                              is_global=is_global, kv_block=kv_block)
        return a @ self.params["wo"].to(x.dtype), k, v

    def decode(self, x, cache: KVCache, cache_pos: int, positions, *, window=0, is_global=None):
        return attention_decode(self.params, x, cache, cache_pos, cfg=self.cfg, positions=positions,
                                window=window, is_global=is_global)
