"""Mamba-style selective SSM block (hymba's parallel-head SSM side).

The port's counterpart of the JAX package's ``models/layers/ssm.py``.
Training and prefill split the sequence into chunks of ``chunk`` steps
(256, and a sequence must be a whole number of them); within a chunk the
linear recurrence ``h_t = dA_t ⊙ h_{t-1} + dB_t x_t`` is solved by an
inclusive scan with JAX's combine ``(a1, b1), (a2, b2) → (a1·a2,
a2·b1 + b2)`` in log2(chunk) doubling steps (Hillis–Steele: each step one
pass over the (B, chunk, Di, Ns) state, exact f32 products and sums, no
division), and a loop over the chunks carries the boundary state, where
JAX runs ``lax.associative_scan`` inside a ``lax.scan``.

Decode keeps a recurrent state per layer: ``(conv (B, W-1, Di),
h (B, Di, Ns))``, O(1) in sequence length.

Split over ``model`` (``shards``, a ``parallel.sharding.ModelShards``), as
JAX's constraint on the scan (``src/repro/models/layers/ssm.py:122``) lays
it out: each rank computes its ``Di/|model|`` channels over every token of
its rows (the sequence all-gathered where the residual is sequence-split).
Its ``x_in`` and ``z`` channels are columns of the whole ``in_proj`` (the
weight's own ``model`` block is not that slice); ``conv_w``, ``conv_b``,
``dt_proj``'s columns, ``dt_bias``, ``a_log``, ``d_skip`` and
``out_proj``'s rows are the rank's blocks.  ``x_dtbc`` contracts over the
split channels, so Δ, B and C are summed over ``model``, and the rank's
partial output returns to the residual's layout by a reduce-scatter (an
all-reduce where the ranks hold the same tokens).  The decode state is the
rank's channels: ``conv P(ba, None, di)``, ``h P(ba, di, None)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import PSpec, SchemaModule
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, Di), or (L, B, W-1, Di) stacked
    h: torch.Tensor      # (B, Di, Ns) f32, or (L, B, Di, Ns)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.state_dim, s.conv_width


def ssm_schema(cfg: ModelConfig, axes: shd.MeshAxes | None = None) -> dict:
    axes = axes or shd.single_device_axes()
    d = cfg.d_model
    d_in, dt_rank, ns, w = _dims(cfg)
    pd = cfg.p_dtype
    di = axes.shard_if(d_in)
    return {
        "in_proj": PSpec((d, 2 * d_in), P(axes.fsdp_if(d), di), dtype=pd),
        "conv_w": PSpec((w, d_in), P(None, di), dtype=pd),
        "conv_b": PSpec((d_in,), P(di), init="zeros", dtype=pd),
        "x_dtbc": PSpec((d_in, dt_rank + 2 * ns), P(di, None), dtype=pd),
        "dt_proj": PSpec((dt_rank, d_in), P(None, di), dtype=pd),
        "dt_bias": PSpec((d_in,), P(di), init="zeros", dtype=pd),
        "a_log": PSpec((d_in, ns), P(di, None), init="ssm_log_a", dtype=torch.float32),
        "d_skip": PSpec((d_in,), P(di), init="ones", dtype=torch.float32),
        "out_proj": PSpec((d_in, d), P(di, axes.fsdp_if(d)), dtype=pd),
    }


def ssm_state_shape(cfg: ModelConfig, batch: int, model: int = 1) -> tuple[tuple, torch.dtype, tuple, torch.dtype]:
    """(conv shape, conv dtype, h shape, h dtype) of one layer's state; with
    ``model`` > 1 a rank's block of ``Di/model`` channels."""
    d_in, _, ns, w = _dims(cfg)
    d_in = split_channels(d_in, model)
    return (batch, w - 1, d_in), cfg.act_dtype, (batch, d_in, ns), torch.float32


def split_channels(d_in: int, model: int) -> int:
    """A rank's share of ``d_in`` channels over ``model`` (JAX's ``shard_if``:
    the SSM splits only where they divide)."""
    if d_in % model:
        raise ValueError(f"d_inner {d_in} does not split over model={model}")
    return d_in // model


def ssm_state_spec(cfg: ModelConfig, axes: shd.MeshAxes, global_batch: int = 0) -> SSMState:
    """One layer's state specs, as JAX's ``ssm_state_spec``."""
    d_in, _, _, _ = _dims(cfg)
    di = axes.shard_if(d_in)
    ba = axes.batch_axes_for(global_batch) if global_batch else axes.batch
    return SSMState(conv=P(ba, None, di), h=P(ba, di, None))


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,Di), w (W,Di) depthwise causal conv along S, plus the bias
    ``b`` (Di,) where there is one (the mLSTM's conv has none)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):  # W is tiny (4): unrolled shifts, as in JAX
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out if b is None else out + b


def _dt_b_c(params, x_a, cfg: ModelConfig, shards: Optional[shd.ModelShards] = None):
    d_in, dt_rank, ns, _ = _dims(cfg)
    dtbc = x_a @ params["x_dtbc"].to(x_a.dtype)
    if shards is not None:          # a partial sum over this rank's channels
        dtbc = shd.shared_sum(dtbc, shards)
    dt_r, bm, cm = torch.split(dtbc, [dt_rank, ns, ns], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"].to(x_a.dtype) + params["dt_bias"].to(x_a.dtype))
    return dt.float(), bm.float(), cm.float()


def _scan(da: torch.Tensor, dbx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of (da, dbx) under JAX's combine: returns
    (∏_{s≤t} da_s, the state at t from a zero start)."""
    a, b = da, dbx
    d, c = 1, da.shape[1]
    while d < c:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _channel_params(params: dict, cfg: ModelConfig, shards: shd.ModelShards) -> dict:
    """``params`` with ``in_proj`` (whole) cut to this rank's ``x_in`` and
    ``z`` columns; the other leaves are already its channel blocks."""
    d_in = _dims(cfg)[0]
    n = split_channels(d_in, shards.size)
    if params["conv_w"].shape[1] != n:
        raise ValueError(f"the SSM's channel weights hold {params['conv_w'].shape[1]} channels, not {n}")
    lo = shards.index * n
    w_in = params["in_proj"]
    return dict(params, in_proj=torch.cat([w_in[:, lo:lo + n], w_in[:, d_in + lo:d_in + lo + n]], dim=1))


def ssm_apply(
    params: dict,
    x: torch.Tensor,             # (B, S, D)
    *,
    cfg: ModelConfig,
    chunk: int = 256,
    return_state: bool = False,
    shards: Optional[shd.ModelShards] = None,
):
    """Full-sequence selective scan (train / prefill).

    ``S`` must be a multiple of ``min(chunk, S)``: a ``ValueError`` where
    JAX fails its assert.  With
    ``return_state`` also returns the terminal :class:`SSMState`: the last
    W − 1 inputs of the conv and the scan's last ``h``.  With ``shards``
    ``x`` is in the residual's layout and the scan runs on this rank's
    channels (module docstring); the state is its channels' too.
    """
    if shards is not None:
        x = shd.whole_tokens(x, shards)
        params = _channel_params(params, cfg, shards)
    b, s, _ = x.shape
    _, _, ns, w = _dims(cfg)
    d_in = params["conv_w"].shape[1]
    xz = x @ params["in_proj"].to(x.dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_a = F.silu(causal_depthwise_conv(x_in, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype)))
    dt, bm, cm = _dt_b_c(params, x_a, cfg, shards)
    a = -torch.exp(params["a_log"])                      # (Di, Ns)
    x_f = x_a.float()

    chunk = min(chunk, s)
    n_chunks = s // chunk
    if n_chunks * chunk != s:       # the JAX package asserts it
        raise ValueError(f"sequence {s} is not a multiple of the scan's chunk {chunk}")

    h = torch.zeros((b, d_in, ns), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        dt_c, bm_c, cm_c, xa_c = dt[:, sl], bm[:, sl], cm[:, sl], x_f[:, sl]
        da = torch.exp(dt_c[..., None] * a)              # (B, c, Di, Ns)
        dbx = (dt_c * xa_c)[..., None] * bm_c[:, :, None, :]
        pa, pb = _scan(da, dbx)
        hs = pb + pa * h[:, None]                        # fold in the carry
        ys.append((hs * cm_c[:, :, None, :]).sum(-1))    # (B, c, Di)
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + params["d_skip"] * x_f
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    if shards is not None:
        out = shd.residual_sum(out, shards)
    if return_state:
        return out, SSMState(conv=x_in[:, -(w - 1):, :].to(cfg.act_dtype), h=h)
    return out


def ssm_decode(
    params: dict,
    x: torch.Tensor,             # (B, 1, D)
    state: SSMState,
    *,
    cfg: ModelConfig,
    shards: Optional[shd.ModelShards] = None,
) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step; returns the output and a new state.
    With ``shards`` the state is this rank's channels and the output is
    summed over ``model``."""
    if shards is not None:
        params = _channel_params(params, cfg, shards)
    xz = x @ params["in_proj"].to(x.dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)                 # (B,1,Di)
    window = torch.cat([state.conv.to(x.dtype), x_in], dim=1)   # (B,W,Di)
    conv_out = (window * params["conv_w"].to(x.dtype)[None]).sum(dim=1, keepdim=True)
    x_a = F.silu(conv_out + params["conv_b"].to(x.dtype))
    dt, bm, cm = _dt_b_c(params, x_a, cfg, shards)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt[:, 0, :, None] * a)                # (B, Di, Ns)
    dbx = (dt[:, 0] * x_a[:, 0].float())[..., None] * bm[:, 0, None, :]
    h = da * state.h + dbx
    y = (h * cm[:, 0, None, :]).sum(-1)                  # (B, Di)
    y = y + params["d_skip"] * x_a[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    if shards is not None:
        out = shd.model_sum(out, shards)
    return out, SSMState(conv=window[:, 1:].to(state.conv.dtype), h=h)


# the leaves a split SSM takes as its rank's channel blocks; ``in_proj`` is
# gathered whole and cut by columns (:func:`_channel_params`)
CHANNEL_LEAVES = ("conv_w", "conv_b", "x_dtbc", "dt_proj", "dt_bias", "a_log", "d_skip", "out_proj")


class SSM(SchemaModule):
    """One hybrid block's SSM weights; split over the active ``model``
    shards where a step splits."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(ssm_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, *, return_state: bool = False):
        return ssm_apply(self.params, x, cfg=self.cfg, return_state=return_state, shards=shd.active_model())

    def decode(self, x: torch.Tensor, state: SSMState) -> tuple[torch.Tensor, SSMState]:
        return ssm_decode(self.params, x, state, cfg=self.cfg, shards=shd.active_model())
