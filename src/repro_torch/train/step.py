"""Train-step construction: loss and gradients → AdamW, with optional
microbatch gradient accumulation.

The port's counterpart of the JAX package's ``train/step.py``.  The
parameters live in the model and are updated in place:

    train_step(model, opt_state, batch) -> (model, opt_state, metrics)

``metrics`` holds 0-d tensors on the model's device (``loss``,
``grad_norm``, ``lr``, and ``nll``/``aux`` without microbatching, as in
JAX), so nothing inside the step waits for the host.  Microbatching splits
the batch (B, S) into k parts of B/k, accumulates f32 gradients and divides
gradients and loss by k; one microbatch's activations are live at a time.

**Across cards.**  The signature is the same; the step reads the mesh
from the model (``model.distribute(mesh)``).  Every rank passes the same
global batch and computes on its own rows: the batch is split over the
mesh axes that ``axes.batch_axes_for(B)`` picks (with ``tp`` off, the
model axis among them).  With ``tp`` on and ``model`` above 1 the ranks
that share a batch shard split its work (``DecoderModel.model_split``: the
sequence-parallel residual, vocab-sharded loss and expert-parallel MoE);
the models that do not split compute it whole on each.  The loss is the
global token mean (the sums and counts of ``softmax_xent_sums`` summed
over the shards), the MoE load-balance loss takes its statistics over all
the tokens, and the gradients come back in the parameters' placement,
reduce-scattered.  Microbatching splits each rank's rows.  ``metrics``
are the same on every rank.
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


def _grads(loss_fn, model, batch: dict, named: dict | None = None):
    """(loss, aux, {name: f32 gradient}) of ``loss_fn`` on ``batch``; a
    parameter the loss does not reach gets zeros, as under ``jax.grad``.
    ``named`` (default: the model's) are the parameters to differentiate."""
    named = dict(model.named_parameters()) if named is None else named
    loss, aux = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(named, grads))


def loss_and_grads(model, batch: dict, *, microbatch: int = 0, loss_fn: Callable | None = None):
    """(loss, aux, {name: f32 gradient}) of ``model`` on ``batch``: the
    gradients the train step hands AdamW.

    ``microbatch`` k > 1 accumulates k parts of each rank's rows and divides
    gradients and loss by k (``aux`` is then empty).  For a model placed on a
    mesh the batch is the global one and the gradients are DTensors in the
    parameters' placement (module docstring).
    """
    loss_fn = loss_fn or make_loss_fn(model)

    def compute_grads(batch, named=None):
        k = microbatch
        if k and k > 1:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} microbatches")
            g_acc, l_acc = None, torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(k):
                mb = {name: x[i * (b // k):(i + 1) * (b // k)] for name, x in batch.items()}
                loss, _, g = _grads(loss_fn, model, mb, named)
                if g_acc is None:
                    g_acc = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in g.items()}
                for n, t in g.items():
                    g_acc[n].add_(t.to(torch.float32))
                del g              # freed before the next microbatch's backward
                l_acc = l_acc + loss
            return l_acc / k, {}, {n: t / k for n, t in g_acc.items()}
        return _grads(loss_fn, model, batch, named)

    if getattr(model, "mesh", None) is None:
        return compute_grads(batch)
    named = dict(model.named_parameters())     # the DTensors, before the gather swaps them
    with model.on_batch_shards(batch) as local:
        return compute_grads(local, named)


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Build the canonical train step for ``model``.

    The decay mask is the JAX default for the model's parameter layout
    (:func:`~repro_torch.optim.adamw.default_decay_mask`).  The step moves
    the tree routers' thresholds: serve the model only after
    ``model.pack_routers()`` (a stale router raises).
    """
    loss_fn = make_loss_fn(model)
    decay_mask = default_decay_mask(model)

    def train_step(model, opt_state: AdamWState, batch: dict):
        loss, aux, grads = loss_and_grads(model, batch, microbatch=tcfg.microbatch, loss_fn=loss_fn)
        model, opt_state, stats = adamw_apply(model, grads, opt_state, tcfg, decay_mask=decay_mask)
        return model, opt_state, {"loss": loss, **stats, **aux}

    return train_step


def make_eval_step(model) -> Callable:
    """``eval_step(model, batch) -> {"loss", "nll", "aux"}`` without gradients."""
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(model, batch):
        with model.on_batch_shards(batch) as local:
            loss, aux = loss_fn(model, local)
        return {"loss": loss, **aux}

    return eval_step
