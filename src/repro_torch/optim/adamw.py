"""AdamW with global-norm clipping and the warmup-cosine LR schedule.

The port's counterpart of the JAX package's ``optim/adamw.py``, on one
device and in PyTorch idiom:

    state = adamw_init(model)
    model, state, stats = adamw_apply(model, grads, state, cfg)

``m`` and ``v`` are dicts of f32 tensors keyed by parameter name, ``count``
an int32 tensor on the parameters' device; the update runs in place under
``no_grad`` and reads nothing back to the host.

This is not ``torch.optim.AdamW``, whose update is another function: it
divides by ``sqrt(v)/sqrt(1 - b2^t) + eps`` where this one divides by
``sqrt(v / (1 - b2^t)) + eps``, and it decays ``p·(1 - lr·wd)`` before the
step where this one adds ``wd·p`` to the step.

**The decay mask.**  The JAX default decays every leaf with ``ndim >= 2``
of *its* parameter tree, where the scanned layers are stacked (L, …): so
every layer's norm scales and router thresholds are decayed, and only
``final_norm.scale`` is not.  The port's per-layer tensors are 1-D, so for a
model the default is taken from the dims of the JAX leaf that holds each
tensor (``model.jax_leaf_dims()``, :func:`default_decay_mask`): one more
than its own in a stack, its own where JAX does not stack (``scan_layers``
off, the xLSTM's unstacked layers).  The ZeRO-1 state shardings
(``adamw_state_shapes`` / ``adamw_state_specs``) wait for the multi-card
LM work.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig

EPS = 1e-8


class AdamWState(NamedTuple):
    m: dict          # parameter name → f32 tensor
    v: dict
    count: torch.Tensor   # 0-d int32, on the parameters' device


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    """Zero moments for ``params``: a module (its named parameters) or a dict."""
    named = _named(params)
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    dev = next(iter(named.values())).device if named else torch.device("cpu")
    return AdamWState(m=m, v=v, count=torch.zeros((), dtype=torch.int32, device=dev))


def default_decay_mask(model) -> dict:
    """The JAX default mask (``ndim >= 2`` on JAX's parameter tree) by parameter name.

    A stacked JAX leaf (the scanned layers) has one more dim than the
    port's per-layer tensor: ``model.jax_leaf_dims()`` counts the JAX one.
    """
    return {name: dims >= 2 for name, dims in model.jax_leaf_dims().items()}


def lr_at(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to 10%, in f32 on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Mapping) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # torch computes a float over a tensor as reciprocal-then-multiply:
    # divide two f32 tensors, as JAX does
    return torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Mapping, max_norm: float):
    """(``tree`` scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in tree.items()}, norm


@torch.no_grad()
def adamw_apply(params, grads: Mapping, state: AdamWState, cfg: TrainConfig, *,
                decay_mask: Optional[Mapping] = None):
    """One AdamW step, in place: ``params`` (a module or a name → tensor dict),
    ``state.m``, ``state.v`` and ``state.count`` are updated.

    ``decay_mask`` (name → bool) selects the weight-decayed tensors; the
    default is :func:`default_decay_mask` for a module and ``ndim >= 2``
    for a dict.  Returns (params, state, {"grad_norm", "lr"}).
    """
    named = _named(params)
    if decay_mask is None:
        decay_mask = default_decay_mask(params) if isinstance(params, nn.Module) else \
            {k: p.ndim >= 2 for k, p in named.items()}
    # clipped leaf by leaf in the loop below, so no clipped copy of every
    # gradient is live at once
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state.count.add_(1)
    cf = state.count.to(torch.float32)
    lr = lr_at(cfg, state.count)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf
    for k, p in named.items():
        gf = grads[k].to(torch.float32) * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + EPS)
        pf = p.to(torch.float32)
        if decay_mask[k]:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
