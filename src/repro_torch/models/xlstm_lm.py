"""xLSTM language model (sLSTM + mLSTM block stack, xlstm-125m), on one device.

The port's counterpart of the JAX package's ``models/xlstm_lm.py``.  Layer
``i`` is an sLSTM block iff ``i % slstm_every == slstm_every - 1`` (every
4th), all others are mLSTM: the 1:3 ratio of the xLSTM paper's 125M
configuration.  The blocks differ in their parameters, so the layers are
not stacked: the ``state_dict`` key ``layers.layer_003.block.w_gates`` is
the JAX leaf ``params["layers"]["layer_003"]["block"]["w_gates"]``.

Training uses the chunkwise-parallel mLSTM and the sLSTM time loop
(:mod:`repro_torch.models.layers.xlstm`); decode carries O(1) recurrent
state per layer; prefill is one pass whose blocks return their terminal
states.  Rematerialization: any ``remat`` but ``"none"`` recomputes each
block in the backward pass, as the JAX model checkpoints each block whole
(``"dots"`` and ``"offload"`` included), and only while grad is enabled.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import schema as sch
from repro_torch.models.layers import xlstm as xl
from repro_torch.models.layers.mlp import RMSNorm, rmsnorm_schema
from repro_torch.parallel.sharding import pad_vocab
from repro_torch.utils.losses import chunked_softmax_xent


class XLSTMCache(NamedTuple):
    states: tuple          # per-layer MLSTMState | SLSTMState
    pos: int


class XLSTMBlock(nn.Module):
    """``ln`` then the layer's mLSTM or sLSTM ``block``, added to the residual."""

    def __init__(self, cfg: ModelConfig, slstm: bool, device):
        super().__init__()
        self.ln = RMSNorm(cfg, device)
        self.block = (xl.SLSTM if slstm else xl.MLSTM)(cfg, device)

    def forward(self, x, *, return_state: bool = False):
        y = self.block(self.ln(x), return_state=return_state)
        if return_state:
            y, state = y
            return x + y, state
        return x + y

    def decode(self, x, state):
        y, state = self.block.decode(self.ln(x), state)
        return x + y, state


class XLSTMModel(sch.SchemaModel):
    """The xLSTM LM; ``device=None`` is the card (raises without one)."""

    def __init__(self, cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None):
        super().__init__()
        if cfg.xlstm is None:
            raise ValueError(f"{cfg.name} has no xLSTM config")
        dev = _device.resolve(None, device)
        self.cfg = cfg
        self.parallel = parallel or ParallelConfig()
        self.stacks = {}
        self.v_pad = pad_vocab(cfg.vocab_size)
        self.embed = sch.SchemaModule({"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)}, dev)
        self.layers = nn.ModuleDict({f"layer_{i:03d}": XLSTMBlock(cfg, self.is_slstm(i), dev)
                                     for i in range(cfg.n_layers)})
        self.final_norm = RMSNorm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = sch.SchemaModule({"w": sch.PSpec((cfg.d_model, self.v_pad), dtype=cfg.p_dtype)}, dev)

    def is_slstm(self, i: int) -> bool:
        k = self.cfg.xlstm.slstm_every
        return k > 0 and i % k == k - 1

    # ----------------------------- schema -----------------------------

    def schema(self) -> dict:
        cfg = self.cfg
        layers = {}
        for i in range(cfg.n_layers):
            body = xl.slstm_schema(cfg) if self.is_slstm(i) else xl.mlstm_schema(cfg)
            layers[f"layer_{i:03d}"] = {"ln": rmsnorm_schema(cfg), "block": body}
        out = {
            "embed": {"table": sch.PSpec((self.v_pad, cfg.d_model), dtype=cfg.p_dtype)},
            "layers": layers,
            "final_norm": rmsnorm_schema(cfg),
        }
        if not cfg.tie_embeddings:
            out["lm_head"] = {"w": sch.PSpec((cfg.d_model, self.v_pad), dtype=cfg.p_dtype)}
        return out

    # ------------------------------ forward ------------------------------

    def _tokens(self, batch: dict) -> torch.Tensor:
        return self.embed.table.to(self.cfg.act_dtype)[batch["tokens"].long()]

    def _out_w(self, dtype: torch.dtype) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.table.to(dtype).T
        return self.lm_head.w.to(dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self._out_w(x.dtype)

    def hidden(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Final normed hidden states (B,S,D) + a zero aux loss."""
        x = self._tokens(batch)
        mode = "none" if self.parallel.remat == "none" else "full"
        for layer in self.layers.values():
            x = sch.checkpointed(layer, mode)(x)
        return self.final_norm(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits (B,S,V_pad), aux_loss)."""
        x, aux = self.hidden(batch)
        return self.logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(total, {"nll", "aux"}): the chunked next-token cross-entropy."""
        x, aux = self.hidden(batch)
        nll, _ = chunked_softmax_xent(x, self._out_w(x.dtype), batch["labels"], vocab_size=self.cfg.vocab_size)
        return nll + aux, {"nll": nll, "aux": aux}

    # ------------------------------- decode -------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> XLSTMCache:
        """The cache's shapes and dtypes as meta tensors (nothing allocated)."""
        return self.init_cache(batch, max_len, device="meta")

    def init_cache(self, batch: int, max_len: int, device=None) -> XLSTMCache:
        """Zero states, the stabilizers at −1e30; ``max_len`` is unused (O(1) state)."""
        dev = self.device if device is None else device
        return XLSTMCache(states=tuple(layer.block.init_state(batch, dev) for layer in self.layers.values()),
                          pos=0)

    @torch.no_grad()
    def decode_step(self, cache: XLSTMCache, batch: dict) -> tuple[torch.Tensor, XLSTMCache]:
        """One token for every sequence: ``{"tokens": (B,1)}``."""
        x = self._tokens(batch)
        states = []
        for layer, st in zip(self.layers.values(), cache.states):
            x, st = layer.decode(x, st)
            states.append(st)
        return self.logits(self.final_norm(x)), XLSTMCache(states=tuple(states), pos=cache.pos + 1)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int | None = None) -> tuple[torch.Tensor, XLSTMCache]:
        """One parallel pass giving the last logits (B,1,V_pad) and every
        block's terminal state; ``max_len`` is unused."""
        x = self._tokens(batch)
        states = []
        for layer in self.layers.values():
            x, st = layer(x, return_state=True)
            states.append(st)
        logits = self.logits(self.final_norm(x[:, -1:, :]))
        return logits, XLSTMCache(states=tuple(states), pos=batch["tokens"].shape[1])
