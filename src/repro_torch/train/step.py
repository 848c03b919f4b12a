"""Train-step construction: loss and gradients → AdamW, with optional
microbatch gradient accumulation.

The port's counterpart of the JAX package's ``train/step.py``, on one
device.  The parameters live in the model and are updated in place:

    train_step(model, opt_state, batch) -> (model, opt_state, metrics)

``metrics`` holds 0-d tensors on the model's device (``loss``,
``grad_norm``, ``lr``, and ``nll``/``aux`` without microbatching, as in
JAX), so nothing inside the step waits for the host.  Microbatching splits
the batch (B, S) into k parts of B/k, accumulates f32 gradients and divides
gradients and loss by k; one microbatch's activations are live at a time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.adamw import AdamWState, adamw_apply, default_decay_mask


def device_batch(batch: dict, device) -> dict:
    """A pipeline's numpy batch as tensors on ``device`` (ints as int32)."""
    out = {}
    for k, x in batch.items():
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        out[k] = t.to(device)
    return out


def make_loss_fn(model) -> Callable:
    """``loss_fn(model, batch) -> (total, {"nll", "aux"})``: the JAX
    ``loss_fn(params, batch)``, the parameters being the model's own."""
    def loss_fn(model, batch):
        return model.loss(batch)

    return loss_fn


def _grads(loss_fn, model, batch: dict):
    """(loss, aux, {name: f32 gradient}) of ``loss_fn`` on ``batch``; a
    parameter the loss does not reach gets zeros, as under ``jax.grad``."""
    named = dict(model.named_parameters())
    loss, aux = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(named, grads))


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Build the canonical train step for ``model``.

    The decay mask is the JAX default for the model's parameter layout
    (:func:`~repro_torch.optim.adamw.default_decay_mask`).  The step moves
    the tree routers' thresholds: serve the model only after
    ``model.pack_routers()`` (a stale router raises).
    """
    loss_fn = make_loss_fn(model)
    decay_mask = default_decay_mask(model)

    def compute_grads(model, batch):
        k = tcfg.microbatch
        if k and k > 1:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} microbatches")
            g_acc, l_acc = None, torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(k):
                mb = {name: x[i * (b // k):(i + 1) * (b // k)] for name, x in batch.items()}
                loss, _, g = _grads(loss_fn, model, mb)
                if g_acc is None:
                    g_acc = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for n, t in g.items()}
                for n, t in g.items():
                    g_acc[n].add_(t.to(torch.float32))
                del g              # freed before the next microbatch's backward
                l_acc = l_acc + loss
            return l_acc / k, {}, {n: t / k for n, t in g_acc.items()}
        return _grads(loss_fn, model, batch)

    def train_step(model, opt_state: AdamWState, batch: dict):
        loss, aux, grads = compute_grads(model, batch)
        model, opt_state, stats = adamw_apply(model, grads, opt_state, tcfg, decay_mask=decay_mask)
        return model, opt_state, {"loss": loss, **stats, **aux}

    return train_step


def make_eval_step(model) -> Callable:
    """``eval_step(model, batch) -> {"loss", "nll", "aux"}`` without gradients."""
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(model, batch):
        loss, aux = loss_fn(model, batch)
        return {"loss": loss, **aux}

    return eval_step
