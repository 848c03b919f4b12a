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

Split over ``model`` (``shards``, a ``parallel.sharding.ModelShards``), as
``mlstm_schema`` and ``mlstm_state_spec`` lay the mLSTM out
(``src/repro/models/layers/xlstm.py:52-66``, ``:94-103``): each rank takes
its ``Di/|model|`` channels of ``x_m`` and ``z`` (columns of the whole
``up``: its own ``model`` block is not that slice), their conv
(``conv_w``'s block) and their share of the output (``down``'s rows,
summed over ``model``); the conv's output and ``x_m`` are all-gathered
along the channels for the projections.  In either layout below the gate
logits are summed over ``model`` from each rank's rows of ``w_if`` (JAX's
``P(di, None)``), the bias added after the sum.  Where the heads divide
``model`` the rank runs its heads (``wq``/``wk``/``wv``'s column blocks,
its heads' columns of the summed logits; the state ``c``, ``n``, ``m`` its
heads').  Where they do not it holds a ``dh/|model|`` slice of every
head's queries and keys (columns of the whole ``wq``/``wk``), of ``c``'s
rows and of ``n``; ``v`` is summed over ``model`` from ``wv``'s rows, and
the contractions over ``dh`` are summed over ``model``.  The sLSTM stays
whole on every rank: JAX gathers its gate weights replicated for the time
loop (``xlstm.py:283-290``).
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


def mlstm_layout(cfg: ModelConfig, model: int) -> str | None:
    """How an mLSTM splits over ``model`` (``mlstm_state_spec``): "heads"
    where they divide it, else "dh" where the head dim does; None on one."""
    d_in, h, dh = _mdims(cfg)
    if model <= 1:
        return None
    if d_in % model:
        raise ValueError(f"the mLSTM's d_inner {d_in} does not split over model={model}")
    if h % model == 0:
        return "heads"
    if dh % model == 0:
        return "dh"
    raise ValueError(f"neither the mLSTM's {h} heads nor its head dim {dh} split over model={model}")


def mlstm_init_state(cfg: ModelConfig, batch: int, device, model: int = 1) -> MLSTMState:
    """The zero state with the stabilizer at ``M_INIT``; with ``model`` > 1
    a rank's block of it (:func:`mlstm_layout`)."""
    d_in, h, dh = _mdims(cfg)
    layout = mlstm_layout(cfg, model)
    hs, dk = (h // model, dh) if layout == "heads" else (h, dh // model if layout == "dh" else dh)
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, hs, dk, dh), dtype=f32, device=device),
        n=torch.zeros((batch, hs, dk), dtype=f32, device=device),
        m=torch.full((batch, hs), M_INIT, dtype=f32, device=device),
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, d_in // model), dtype=cfg.act_dtype, device=device),
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


def _dh_columns(cfg: ModelConfig, shards: shd.ModelShards, device) -> torch.Tensor:
    """The columns of every head's ``dh/|model|`` slice of this rank in a
    (Di, H·dh) projection (the "dh" layout)."""
    _, h, dh = _mdims(cfg)
    dl = dh // shards.size
    lo = shards.index * dl
    return (torch.arange(h, device=device)[:, None] * dh + lo + torch.arange(dl, device=device)).reshape(-1)


def _gate_columns(h: int, hl: int, index: int, device) -> torch.Tensor:
    """The columns of this rank's ``hl`` heads in the (Di, 2H) gate weight
    (input gates, then forget gates)."""
    own = index * hl + torch.arange(hl, device=device)
    return torch.cat([own, h + own])


def _mlstm_split_qkv_gates(params, x, cfg: ModelConfig, shards: shd.ModelShards, layout: str):
    """The split mLSTM's projections on this rank (module docstring): q, k
    (its heads, or its dh slice of every head), v (its heads, or every head
    whole), the gate logits of the heads it runs (summed over ``model`` from
    its rows of ``w_if``, as JAX's ``P(di, None)`` lays them out), its ``z``
    and ``x_m`` channels.  ``x`` is in the residual's layout."""
    d_in, h, dh = _mdims(cfg)
    n = d_in // shards.size
    lo = shards.index * n
    x = shd.whole_tokens(x, shards)
    b, s, _ = x.shape
    up = params["up"]
    xz = x @ torch.cat([up[:, lo:lo + n], up[:, d_in + lo:d_in + lo + n]], dim=1).to(x.dtype)
    xm_l, z_l = torch.chunk(xz, 2, dim=-1)
    xc_l = F.silu(causal_depthwise_conv(xm_l, params["conv_w"].to(x.dtype)))
    xc = shd.seq_gather(xc_l, -1, shards)                # every channel, for the projections
    part = xc_l.float() @ params["w_if"]                 # the gate logits over this rank's channel rows
    if layout == "heads":
        hl = h // shards.size
        xm = shd.seq_gather(xm_l, -1, shards)
        q = (xc @ params["wq"].to(x.dtype)).reshape(b, s, hl, dh)
        k = (xc @ params["wk"].to(x.dtype)).reshape(b, s, hl, dh) * (dh ** -0.5)
        v = (xm @ params["wv"].to(x.dtype)).reshape(b, s, hl, dh)
        gates = shd.shared_sum(part, shards) + params["b_if"]
        ig, fg = torch.chunk(gates[..., _gate_columns(h, hl, shards.index, x.device)], 2, dim=-1)
        return q, k, v, ig, fg, z_l, xm_l
    ig, fg = torch.chunk(shd.model_sum(part, shards) + params["b_if"], 2, dim=-1)   # (B, S, H) logits
    cols = _dh_columns(cfg, shards, x.device)
    dl = dh // shards.size
    q = (xc @ params["wq"][:, cols].to(x.dtype)).reshape(b, s, h, dl)
    k = (xc @ params["wk"][:, cols].to(x.dtype)).reshape(b, s, h, dl) * (dh ** -0.5)
    v = shd.model_sum(xm_l @ params["wv"][lo:lo + n].to(x.dtype), shards).reshape(b, s, h, dh)
    return q, k, v, ig, fg, z_l, xm_l


def _mlstm_chunk(state, qc, kc, vc, igc, fgc, shards: shd.ModelShards | None = None):
    """One chunk of the chunkwise-parallel form: (new (c, n, m), h (B,c,H,dh)).

    With ``shards`` (the "dh" layout) ``qc``, ``kc`` and the state's ``c``
    rows and ``n`` are this rank's slice of each head's dh: the contractions
    over it are summed over ``model``, and the tensors every rank computes
    alike enter the rank's own state update through ``enter_split``."""
    sum_d = (lambda t: shd.model_sum(t, shards)) if shards is not None else (lambda t: t)
    own = (lambda t: shd.enter_split(t, shards)) if shards is not None else (lambda t: t)
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
    sc = sum_d(torch.einsum("bhtd,bhsd->bhts", qf, kf)) * d_exp   # (B,H,c,c)
    inter_w = torch.exp(inter_log - m_t)                 # (B,H,c)
    num = torch.einsum("bhts,bhsd->bhtd", sc, vf) + inter_w[..., None] * sum_d(
        torch.einsum("bhtd,bhde->bhte", qf, c0))
    den = torch.abs(sc.sum(-1) + inter_w * sum_d(torch.einsum("bhtd,bhd->bht", qf, n0)))
    hout = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    # ---- carry the state to the chunk's end ----
    btot = bcum[..., -1]                                 # (B,H)
    scale_s = btot[..., None] - bcum + ii                # (B,H,c): decay for kv_s
    m_new = torch.maximum(btot + m0, scale_s.amax(-1))
    w_s = own(torch.exp(scale_s - m_new[..., None]))     # (B,H,c)
    decay = own(torch.exp(btot + m0 - m_new))
    c_new = decay[..., None, None] * c0 + torch.einsum("bhs,bhsd,bhse->bhde", w_s, kf, own(vf))
    n_new = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", w_s, kf)
    return (c_new, n_new, m_new), hout.transpose(1, 2)  # (B,c,H,dh)


def mlstm_apply(
    params: dict,
    x: torch.Tensor,             # (B, S, D)
    *,
    cfg: ModelConfig,
    chunk: int = 1024,
    return_state: bool = False,
    shards: shd.ModelShards | None = None,
):
    """Chunkwise-parallel mLSTM over a full sequence.

    With ``return_state`` also returns the terminal :class:`MLSTMState`
    (the state the chunk loop carries, plus the conv tail), so a prefill
    seeds decode without a sequential re-pass.  With ``shards`` ``x`` is in
    the residual's layout, the mLSTM runs on this rank's share (module
    docstring) and the state is its block."""
    b, s, _ = x.shape
    d_in, h, dh = _mdims(cfg)
    layout = None if shards is None else mlstm_layout(cfg, shards.size)
    if layout is None:
        q, k, v, ig, fg, z, xm, _ = _mlstm_qkv_gates(params, x, cfg)
    else:
        q, k, v, ig, fg, z, xm = _mlstm_split_qkv_gates(params, x, cfg, shards, layout)
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    dev = x.device
    hs_, dk = q.shape[2], q.shape[3]
    state = (torch.zeros((b, hs_, dk, dh), dtype=torch.float32, device=dev),
             torch.zeros((b, hs_, dk), dtype=torch.float32, device=dev),
             torch.full((b, hs_), M_INIT, dtype=torch.float32, device=dev))
    dh_shards = shards if layout == "dh" else None
    hs = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        state, hc = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl], dh_shards)
        hs.append(hc)
    hout = torch.cat(hs, dim=1).reshape(b, s, -1).to(x.dtype)
    if layout == "dh":                                   # every head whole: this rank's channels
        n = d_in // shards.size
        hout = shd.enter_split(hout, shards)[..., shards.index * n:(shards.index + 1) * n]
    out = (hout * F.silu(z)) @ params["down"].to(x.dtype)
    if shards is not None:
        out = shd.residual_sum(out, shards)
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
    shards: shd.ModelShards | None = None,
) -> tuple[torch.Tensor, MLSTMState]:
    """The exact recurrent step; with ``shards`` on this rank's block of the
    state, the output summed over ``model``."""
    b = x.shape[0]
    d_in, h, dh = _mdims(cfg)
    layout = None if shards is None else mlstm_layout(cfg, shards.size)
    up = params["up"]
    if layout is not None:
        n = d_in // shards.size
        lo = shards.index * n
        up = torch.cat([up[:, lo:lo + n], up[:, d_in + lo:d_in + lo + n]], dim=1)
    xz = x @ up.to(x.dtype)
    xm, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([state.conv.to(x.dtype), xm], dim=1)
    xc = F.silu((window * params["conv_w"].to(x.dtype)[None]).sum(1, keepdim=True))
    sum_d = lambda t: t                                  # noqa: E731
    if layout is None:
        q = (xc @ params["wq"].to(x.dtype)).reshape(b, h, dh).float()
        k = ((xc @ params["wk"].to(x.dtype)).reshape(b, h, dh) * (dh ** -0.5)).float()
        v = (xm @ params["wv"].to(x.dtype)).reshape(b, h, dh).float()
        gates = xc[:, 0].float() @ params["w_if"] + params["b_if"]
    else:
        xc_all = shd.model_gather(xc, -1, shards)
        gates = shd.model_sum(xc[:, 0].float() @ params["w_if"], shards) + params["b_if"]
        if layout == "heads":
            hl = h // shards.size
            xm_all = shd.model_gather(xm, -1, shards)
            q = (xc_all @ params["wq"].to(x.dtype)).reshape(b, hl, dh).float()
            k = ((xc_all @ params["wk"].to(x.dtype)).reshape(b, hl, dh) * (dh ** -0.5)).float()
            v = (xm_all @ params["wv"].to(x.dtype)).reshape(b, hl, dh).float()
            gates = gates[:, _gate_columns(h, hl, shards.index, x.device)]
        else:
            cols = _dh_columns(cfg, shards, x.device)
            dl = dh // shards.size
            q = (xc_all @ params["wq"][:, cols].to(x.dtype)).reshape(b, h, dl).float()
            k = ((xc_all @ params["wk"][:, cols].to(x.dtype)).reshape(b, h, dl) * (dh ** -0.5)).float()
            v = shd.model_sum(xm @ params["wv"][lo:lo + n].to(x.dtype), shards).reshape(b, h, dh).float()
            sum_d = lambda t: shd.model_sum(t, shards)  # noqa: E731
    ig, fg = torch.chunk(gates, 2, dim=-1)               # (B, H)
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + state.m, ig)
    fw = torch.exp(lf + state.m - m_new)[..., None]
    iw = torch.exp(ig - m_new)[..., None]
    c_new = fw[..., None] * state.c + iw[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = fw * state.n + iw * k
    num = sum_d(torch.einsum("bhd,bhde->bhe", q, c_new))
    den = torch.abs(sum_d(torch.einsum("bhd,bhd->bh", q, n_new)))
    hout = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    hout = hout.reshape(b, 1, -1).to(x.dtype)
    if layout == "dh":
        hout = hout[..., lo:lo + n]
    out = (hout * F.silu(z)) @ params["down"].to(x.dtype)
    if layout is not None:
        out = shd.model_sum(out, shards)
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
    """One mLSTM block's weights; split over the active ``model`` shards
    where a step splits."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(mlstm_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x, *, return_state: bool = False):
        return mlstm_apply(self.params, x, cfg=self.cfg, return_state=return_state, shards=shd.active_model())

    def decode(self, x, state: MLSTMState):
        return mlstm_decode(self.params, x, state, cfg=self.cfg, shards=shd.active_model())

    def init_state(self, batch: int, device, model: int = 1) -> MLSTMState:
        return mlstm_init_state(self.cfg, batch, device, model)

    def model_local_names(self, model: int) -> set:
        """The leaves a split step takes as this rank's ``model`` block: the
        conv, ``down``'s and the gates' rows, and (the "heads" layout) the
        heads' projections."""
        if mlstm_layout(self.cfg, model) == "heads":
            return {"conv_w", "down", "w_if", "wq", "wk", "wv"}
        return {"conv_w", "down", "w_if"}

    def model_partial_names(self, model: int) -> set:
        """The whole leaves of which each rank uses its slice: ``up``'s
        columns, and the gate bias's columns of its heads or (the "dh"
        layout) ``wq``/``wk``'s columns and ``wv``'s rows."""
        if mlstm_layout(self.cfg, model) == "heads":
            return {"up", "b_if"}
        return {"up", "wq", "wk", "wv"}


class SLSTM(SchemaModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(slstm_schema(cfg), device)
        self.cfg = cfg

    def forward(self, x, *, return_state: bool = False):
        return slstm_apply(self.params, x, cfg=self.cfg, return_state=return_state)

    def decode(self, x, state: SLSTMState):
        return slstm_decode(self.params, x, state, cfg=self.cfg)

    def init_state(self, batch: int, device, model: int = 1) -> SLSTMState:
        return slstm_init_state(self.cfg, batch, device)

    def model_local_names(self, model: int) -> set:
        return set()

    def model_partial_names(self, model: int) -> set:
        return set()
