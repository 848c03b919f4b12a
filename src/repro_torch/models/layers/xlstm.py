"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port's counterpart of the JAX package's ``models/layers/xlstm.py``.

mLSTM trains in the **chunkwise-parallel form**: within a chunk the
stabilized exponential-gating quadratic form, across chunks the recurrent
matrix state ``(C, n, m)`` carried by a loop (JAX scans).  The chunk is
halved until it divides the sequence.  Decode is the exact recurrent step,
so the serving state is O(1) in sequence length.

sLSTM has a true nonlinear recurrence (``h_{t-1}`` feeds the gates), so it
runs a loop over time; the input-gate product ``x @ W`` is one matmul over
the whole sequence ahead of the loop, and only ``h_prev @ R`` stays in it.

Stabilization follows the xLSTM paper: log-sigmoid forget gates and a
running max-state ``m`` (starting at −1e30) so every exponential is ≤ 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.ssm import causal_depthwise_conv
from repro_torch.models.schema import PSpec, SchemaModule
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P

M_INIT = -1e30          # the stabilizer's start, "-inf-ish"


def _mdims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.n_heads
    return d_in, h, d_in // h


class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, dh, dh) f32
    n: torch.Tensor     # (B, H, dh) f32
    m: torch.Tensor     # (B, H) f32
    conv: torch.Tensor  # (B, W-1, Di)


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, D) f32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def mlstm_schema(cfg: ModelConfig, axes: shd.MeshAxes | None = None) -> dict:
    axes = axes or shd.single_device_axes()
    d = cfg.d_model
    d_in, h, _ = _mdims(cfg)
    w = cfg.xlstm.conv_width
    pd = cfg.p_dtype
    di = axes.shard_if(d_in)
    return {
        "up": PSpec((d, 2 * d_in), P(axes.fsdp_if(d), di), dtype=pd),
        "conv_w": PSpec((w, d_in), P(None, di), dtype=pd),
        "wq": PSpec((d_in, d_in), P(axes.fsdp_if(d_in), di), dtype=pd),
        "wk": PSpec((d_in, d_in), P(axes.fsdp_if(d_in), di), dtype=pd),
        "wv": PSpec((d_in, d_in), P(axes.fsdp_if(d_in), di), dtype=pd),
        "w_if": PSpec((d_in, 2 * h), P(di, None), dtype=torch.float32),
        "b_if": PSpec((2 * h,), P(None), init="zeros", dtype=torch.float32),
        "down": PSpec((d_in, d), P(di, axes.fsdp_if(d)), dtype=pd),
    }


def slstm_schema(cfg: ModelConfig, axes: shd.MeshAxes | None = None) -> dict:
    axes = axes or shd.single_device_axes()
    d = cfg.d_model
    pd = cfg.p_dtype
    return {
        "w_gates": PSpec((d, 4 * d), P(axes.fsdp_if(d), axes.shard_if(4 * d)), dtype=pd),    # i, f, z, o
        "r_gates": PSpec((d, 4 * d), P(axes.fsdp_if(d), axes.shard_if(4 * d)), dtype=pd),    # recurrent
        "b_gates": PSpec((4 * d,), P(None), init="zeros", dtype=torch.float32),
        "out": PSpec((d, d), P(None, axes.shard_if(d)), dtype=pd),
    }


def mlstm_state_spec(cfg: ModelConfig, axes: shd.MeshAxes, global_batch: int = 0) -> MLSTMState:
    """One mLSTM layer's state specs, as JAX's ``mlstm_state_spec``."""
    d_in, h, dh = _mdims(cfg)
    hs = axes.shard_if(h)
    ds = axes.shard_if(dh) if hs is None else None
    ba = axes.batch_axes_for(global_batch) if global_batch else axes.batch
    return MLSTMState(c=P(ba, hs, ds, None), n=P(ba, hs, ds), m=P(ba, hs), conv=P(ba, None, axes.shard_if(d_in)))


def slstm_state_spec(cfg: ModelConfig, axes: shd.MeshAxes, global_batch: int = 0) -> SLSTMState:
    """One sLSTM layer's state specs, as JAX's ``slstm_state_spec``."""
    ba = axes.batch_axes_for(global_batch) if global_batch else axes.batch
    s = P(ba, None)
    return SLSTMState(c=s, n=s, h=s, m=s)


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    """The zero state with the stabilizer at ``M_INIT``."""
    d_in, h, dh = _mdims(cfg)
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        n=torch.zeros((batch, h, dh), dtype=f32, device=device),
        m=torch.full((batch, h), M_INIT, dtype=f32, device=device),
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, d_in), dtype=cfg.act_dtype, device=device),
    )


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone(), m=torch.full_like(z, M_INIT))


def _mlstm_qkv_gates(params, x, cfg: ModelConfig):
    d_in, h, dh = _mdims(cfg)
    b, s, _ = x.shape
    xz = x @ params["up"].to(x.dtype)
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(causal_depthwise_conv(xm, params["conv_w"].to(x.dtype)))
    q = (xc @ params["wq"].to(x.dtype)).reshape(b, s, h, dh)
    k = (xc @ params["wk"].to(x.dtype)).reshape(b, s, h, dh) * (dh ** -0.5)
    v = (xm @ params["wv"].to(x.dtype)).reshape(b, s, h, dh)
    gates = xc.float() @ params["w_if"] + params["b_if"]
    ig, fg = torch.chunk(gates, 2, dim=-1)               # (B, S, H) logits
    return q, k, v, ig, fg, z, xm, xc


def _mlstm_chunk(state, qc, kc, vc, igc, fgc):
    """One chunk of the chunkwise-parallel form: (new (c, n, m), h (B,c,H,dh))."""
    c0, n0, m0 = state                                   # (B,H,dh,dh), (B,H,dh), (B,H)
    chunk = qc.shape[1]
    qf = qc.float().transpose(1, 2)                      # (B,H,c,dh)
    kf = kc.float().transpose(1, 2)
    vf = vc.float().transpose(1, 2)
    lf = F.logsigmoid(fgc).transpose(1, 2)               # (B,H,c)
    ii = igc.transpose(1, 2)                             # (B,H,c)
    bcum = torch.cumsum(lf, dim=-1)                      # (B,H,c)
    # intra-chunk log decay matrix D[t,s] = b_t - b_s + i_s  (t ≥ s)
    dmat = bcum[..., :, None] - bcum[..., None, :] + ii[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=qc.device))
    dmat = torch.where(tri, dmat, -torch.inf)
    inter_log = bcum + m0[..., None]                     # (B,H,c)
    m_t = torch.maximum(inter_log, dmat.amax(dim=-1))    # (B,H,c)
    d_exp = torch.exp(dmat - m_t[..., None])
    sc = torch.einsum("bhtd,bhsd->bhts", qf, kf) * d_exp   # (B,H,c,c)
    inter_w = torch.exp(inter_log - m_t)                 # (B,H,c)
    num = torch.einsum("bhts,bhsd->bhtd", sc, vf) + inter_w[..., None] * torch.einsum("bhtd,bhde->bhte", qf, c0)
    den = torch.abs(sc.sum(-1) + inter_w * torch.einsum("bhtd,bhd->bht", qf, n0))
    hout = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    # ---- carry the state to the chunk's end ----
    btot = bcum[..., -1]                                 # (B,H)
    scale_s = btot[..., None] - bcum + ii                # (B,H,c): decay for kv_s
    m_new = torch.maximum(btot + m0, scale_s.amax(-1))
    w_s = torch.exp(scale_s - m_new[..., None])          # (B,H,c)
    decay = torch.exp(btot + m0 - m_new)
    c_new = decay[..., None, None] * c0 + torch.einsum("bhs,bhsd,bhse->bhde", w_s, kf, vf)
    n_new = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", w_s, kf)
    return (c_new, n_new, m_new), hout.transpose(1, 2)  # (B,c,H,dh)


def mlstm_apply(
    params: dict,
    x: torch.Tensor,             # (B, S, D)
    *,
    cfg: ModelConfig,
    chunk: int = 1024,
    return_state: bool = False,
):
    """Chunkwise-parallel mLSTM over a full sequence.

    With ``return_state`` also returns the terminal :class:`MLSTMState`
    (the state the chunk loop carries, plus the conv tail), so a prefill
    seeds decode without a sequential re-pass."""
    b, s, _ = x.shape
    d_in, h, dh = _mdims(cfg)
    q, k, v, ig, fg, z, xm, _ = _mlstm_qkv_gates(params, x, cfg)
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    dev = x.device
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((b, h, dh), dtype=torch.float32, device=dev),
             torch.full((b, h), M_INIT, dtype=torch.float32, device=dev))
    hs = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        state, hc = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl])
        hs.append(hc)
    hout = torch.cat(hs, dim=1).reshape(b, s, d_in).to(x.dtype)
    out = (hout * F.silu(z)) @ params["down"].to(x.dtype)
    if return_state:
        w = cfg.xlstm.conv_width
        c_f, n_f, m_f = state
        return out, MLSTMState(c=c_f, n=n_f, m=m_f, conv=xm[:, -(w - 1):, :].to(cfg.act_dtype))
    return out


def mlstm_decode(
    params: dict,
    x: torch.Tensor,             # (B, 1, D)
    state: MLSTMState,
    *,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, MLSTMState]:
    b = x.shape[0]
    d_in, h, dh = _mdims(cfg)
    xz = x @ params["up"].to(x.dtype)
    xm, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([state.conv.to(x.dtype), xm], dim=1)
    xc = F.silu((window * params["conv_w"].to(x.dtype)[None]).sum(1, keepdim=True))
    q = (xc @ params["wq"].to(x.dtype)).reshape(b, h, dh).float()
    k = ((xc @ params["wk"].to(x.dtype)).reshape(b, h, dh) * (dh ** -0.5)).float()
    v = (xm @ params["wv"].to(x.dtype)).reshape(b, h, dh).float()
    gates = xc[:, 0].float() @ params["w_if"] + params["b_if"]
    ig, fg = torch.chunk(gates, 2, dim=-1)               # (B, H)
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + state.m, ig)
    fw = torch.exp(lf + state.m - m_new)[..., None]
    iw = torch.exp(ig - m_new)[..., None]
    c_new = fw[..., None] * state.c + iw[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = fw * state.n + iw * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new))
    hout = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    hout = hout.reshape(b, 1, d_in).to(x.dtype)
    out = (hout * F.silu(z)) @ params["down"].to(x.dtype)
    return out, MLSTMState(c=c_new, n=n_new, m=m_new, conv=window[:, 1:].to(state.conv.dtype))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_step(w: dict, carry, gx_t):
    """carry: (c, n, h, m) each (B, D); ``gx_t`` = the precomputed input
    gates (B, 4D).  Only the recurrent ``h_prev @ R`` is computed here."""
    c, n, h_prev, m = carry
    gates = gx_t + h_prev @ w["r_gates"] + w["b_gates"]
    ig, fg, zg, og = torch.chunk(gates, 4, dim=-1)
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + m, ig)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(ig - m_new)
    c_new = fw * c + iw * torch.tanh(zg)
    n_new = fw * n + iw
    h_new = torch.sigmoid(og) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_weights(params) -> dict:
    """The f32 gate weights for the time loop, cast once."""
    return {"w_gates": params["w_gates"].float(), "r_gates": params["r_gates"].float(),
            "b_gates": params["b_gates"]}


def slstm_apply(params: dict, x: torch.Tensor, *, cfg: ModelConfig, return_state: bool = False):
    b, s, d = x.shape
    w = _slstm_weights(params)
    st = slstm_init_state(cfg, b, x.device)
    carry = (st.c, st.n, st.h, st.m)
    gx = x.float() @ w["w_gates"]                        # (B, S, 4D): one big matmul
    hs = []
    for t in range(s):
        carry, h_t = _slstm_step(w, carry, gx[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(x.dtype)
    out = h @ params["out"].to(x.dtype)
    if return_state:
        return out, SLSTMState(*carry)
    return out


def slstm_decode(params: dict, x: torch.Tensor, state: SLSTMState, *,
                 cfg: ModelConfig) -> tuple[torch.Tensor, SLSTMState]:
    w = _slstm_weights(params)
    gx = x[:, 0].float() @ w["w_gates"]
    carry, h = _slstm_step(w, tuple(state), gx)
    out = h[:, None].to(x.dtype) @ params["out"].to(x.dtype)
    return out, SLSTMState(*carry)


class MLSTM(SchemaModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(mlstm_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x, *, return_state: bool = False):
        return mlstm_apply(self.params, x, cfg=self.cfg, return_state=return_state)

    def decode(self, x, state: MLSTMState):
        return mlstm_decode(self.params, x, state, cfg=self.cfg)

    def init_state(self, batch: int, device) -> MLSTMState:
        return mlstm_init_state(self.cfg, batch, device)


class SLSTM(SchemaModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(slstm_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x, *, return_state: bool = False):
        return slstm_apply(self.params, x, cfg=self.cfg, return_state=return_state)

    def decode(self, x, state: SLSTMState):
        return slstm_decode(self.params, x, state, cfg=self.cfg)

    def init_state(self, batch: int, device) -> SLSTMState:
        return slstm_init_state(self.cfg, batch, device)
