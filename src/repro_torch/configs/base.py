"""Configuration dataclasses for models, parallelism and runs.

The port's copy of the JAX package's ``configs/base.py``: the same fields,
defaults and parameter arithmetic; ``dtype`` / ``param_dtype`` name torch
dtypes here.  ``ParallelConfig``'s fields are carried for parity; on one
device the port reads only ``attn_kv_block`` (an eager loop has nothing to
unroll).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config."""

    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden width
    router: str = "softmax"         # "softmax" | "tree" (paper integration)
    router_tree_depth: int = 0      # 0 → ceil(log2(n_experts))
    capacity_factor: float = 1.25
    shared_d_ff: int = 0            # optional shared (always-on) expert width
    aux_loss_weight: float = 0.01

    def tree_depth(self) -> int:
        if self.router_tree_depth:
            return self.router_tree_depth
        d = 1
        while (1 << d) < self.n_experts:
            d += 1
        return d


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective-SSM config."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix: which layers are sLSTM (others mLSTM)."""

    slstm_every: int = 4            # layer i is sLSTM iff i % slstm_every == slstm_every-1
    proj_factor: float = 2.0        # mLSTM up-projection
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) models; frontend is a stub."""

    n_layers: int
    n_frames: int = 1500            # whisper 30 s @ 50 Hz after conv stub


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Families: dense | moe | hybrid | ssm | audio | vlm."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads
    rope_theta: float = 10_000.0
    rope_style: str = "rope"        # "rope" | "mrope" | "none"
    mrope_sections: Sequence[int] = (16, 24, 24)
    norm_eps: float = 1e-5
    act: str = "silu"               # mlp activation: "silu"(SwiGLU) | "gelu"
    tie_embeddings: bool = False
    sliding_window: int = 0         # 0 → full attention
    global_attn_layers: Sequence[int] = ()   # hybrid: layers with full attn
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    embeds_input: bool = False      # vlm/audio stub: inputs are embeddings
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "float32"
    # paper integration
    tree_head_classes: int = 0      # >0 → attach tree token-classification head

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def act_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/recurrent/sliding-window)."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def n_params(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.xlstm is not None:
            per_layer = self._xlstm_layer_params()
        else:
            if self.moe is not None:
                mlp = 3 * d * self.moe.d_ff * self.moe.n_experts
                if self.moe.shared_d_ff:
                    mlp += 3 * d * self.moe.shared_d_ff
                mlp += self._router_params()
            else:
                mlp = (3 if self.act == "silu" else 2) * d * f
            per_layer = attn + mlp + 2 * d
            if self.ssm is not None and self.family == "hybrid":
                per_layer += self._ssm_layer_params()
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += v * d
        if self.encoder is not None:
            enc_layer = attn + 2 * d * f + 2 * d  # gelu mlp (2 mats) + cross-kv reuse
            total += self.encoder.n_layers * enc_layer
        return int(total)

    def _router_params(self) -> int:
        assert self.moe is not None
        if self.moe.router == "tree":
            n_internal = (1 << self.moe.tree_depth()) - 1
            return self.d_model * n_internal + n_internal
        return self.d_model * self.moe.n_experts

    def _ssm_layer_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        dt_rank = s.dt_rank or -(-self.d_model // 16)
        return (
            2 * self.d_model * d_in          # in_proj (x, z)
            + s.conv_width * d_in            # depthwise conv
            + d_in * (dt_rank + 2 * s.state_dim)  # x→(dt,B,C)
            + dt_rank * d_in                 # dt proj
            + d_in * s.state_dim             # A
            + d_in                            # D skip
            + d_in * self.d_model            # out proj
        )

    def _xlstm_layer_params(self) -> int:
        x = self.xlstm
        d = self.d_model
        d_in = int(x.proj_factor * d)
        # mLSTM block: up 2×, qkv, gates, out
        m = 2 * d * d_in + 3 * d_in * d_in // max(1, self.n_heads) * self.n_heads
        m += 2 * d_in + d_in * d
        # sLSTM block approximated same order
        return m

    def active_params(self) -> int:
        """MoE: params touched per token (top-k experts + shared + backbone)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * 3 * d * self.moe.d_ff * self.moe.n_experts
        active_mlp = self.n_layers * 3 * d * self.moe.d_ff * self.moe.top_k
        return int(dense + active_mlp)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh."""

    batch_axes: tuple = ("data",)   # ("pod","data") on the multi-pod mesh
    model_axis: str = "model"
    remat: str = "full"             # "none" | "full" | "dots" | "offload"
    scan_layers: bool = True
    seq_shard: bool = True          # sequence-parallel residual stream
    attn_kv_block: int = 1024       # blockwise-attention KV chunk
    attn_unroll: int = 4            # unroll factor for the KV-block scan
                                    # (fuses acc updates across blocks:
                                    #  +35% roofline frac on ds67, §Perf D7)
    zero1: bool = True              # shard optimizer state over data axis
    grad_compression: bool = False  # int8 cross-pod gradient compression


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0             # 0 → no accumulation
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"
