"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

The port's counterpart of the JAX package's ``models/layers/rope.py``: the
head dim is split into halves that rotate together (not interleaved pairs),
in f32, and cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., hd) rotated pairwise with cos/sin (..., hd/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(
    x: torch.Tensor,            # (B, S, H, hd)
    positions: torch.Tensor,    # (B, S) int
    *,
    theta: float,
) -> torch.Tensor:
    hd = x.shape[-1]
    inv = _freqs(hd, theta, x.device)                         # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def apply_mrope(
    x: torch.Tensor,            # (B, S, H, hd)
    positions: torch.Tensor,    # (B, 3, S) int: (t, h, w) position streams
    *,
    theta: float,
    sections: tuple,            # frequency bands per stream; sums to hd/2
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the hd/2 frequency bands are partitioned
    into (temporal, height, width) sections, each rotated by its own position
    stream.  For pure-text positions the three streams coincide and M-RoPE
    reduces to standard RoPE."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2 = {hd // 2}")
    inv = _freqs(hd, theta, x.device)                          # (hd/2,)
    ang_all = positions[..., None].to(torch.float32) * inv     # (B, 3, S, hd/2)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[:, i, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                             # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def positions_for(batch: int, seq: int, *, style: str, offset: int = 0, device=None) -> torch.Tensor:
    """Default position streams (text only): (B, S) int32, or (B, 3, S) for M-RoPE."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if style == "mrope":
        return pos[:, None, :].expand(batch, 3, seq)
    return pos
