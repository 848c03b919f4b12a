"""Feed-forward blocks (SwiGLU for the llama family, GELU for whisper) and RMSNorm.

The port's counterpart of the JAX package's ``models/layers/mlp.py``.  The
functions take a dict of the block's weights, as the JAX ones do; the
modules hold the weights and call them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import PSpec, SchemaModule


def mlp_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    out = {
        "wi": PSpec((d, d_ff), dtype=cfg.p_dtype),
        "wo": PSpec((d_ff, d), dtype=cfg.p_dtype),
    }
    if cfg.act == "silu":
        out["wg"] = PSpec((d, d_ff), dtype=cfg.p_dtype)
    return out


def mlp(params: dict, x: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    h = x @ params["wi"].to(x.dtype)
    if cfg.act == "silu":
        g = x @ params["wg"].to(x.dtype)
        h = torch.nn.functional.silu(g) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ params["wo"].to(x.dtype)


def rmsnorm_schema(cfg: ModelConfig) -> dict:
    return {"scale": PSpec((cfg.d_model,), init="ones", dtype=torch.float32)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float) -> torch.Tensor:
    """Computed in f32 and cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


class RMSNorm(SchemaModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(rmsnorm_schema(cfg), device)
        self.eps = cfg.norm_eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.params, x, eps=self.eps)


class MLP(SchemaModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(mlp_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.params, x, cfg=self.cfg)
