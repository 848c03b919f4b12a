"""AdamW with global-norm clipping and the warmup-cosine LR schedule.

The port's counterpart of the JAX package's ``optim/adamw.py``, in
PyTorch idiom:

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
off, the xLSTM's unstacked layers).

**Across cards (ZeRO-1).**  For a model placed on a mesh
(``model.distribute``) the state is JAX's tree: ``m`` and ``v`` are keyed
by JAX leaf path (``layers.attn.wq``, stacked (L, …) where JAX scans the
layers), each a DTensor placed by :func:`adamw_state_specs`, the
parameter's spec plus a ``data`` slice where ``zero1_spec`` finds one.
:func:`adamw_apply` updates each rank's slice of ``m``, ``v`` and the
parameter, then all-gathers the parameter's new values into its own
placement; a slice over the stack dim updates the layers this rank holds.
``global_norm`` is the norm of the whole gradient, each block counted once.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import TrainConfig
from repro_torch.parallel import sharding as shd

EPS = 1e-8


class AdamWState(NamedTuple):
    m: dict          # parameter name → f32 tensor
    v: dict
    count: torch.Tensor   # 0-d int32, on the parameters' device


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_state_shapes(param_shapes) -> AdamWState:
    """The state's leaves as f32 ``meta`` tensors (nothing allocated), for a
    tree of shapes (``model.param_shapes()``)."""
    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        return torch.empty(tuple(getattr(t, "shape", t)), dtype=torch.float32, device="meta")

    zl = meta(param_shapes)
    return AdamWState(m=zl, v=meta(param_shapes), count=torch.empty((), dtype=torch.int32, device="meta"))


def adamw_state_specs(param_specs, param_shapes, axes: shd.MeshAxes, *, zero1: bool = True) -> AdamWState:
    """m/v follow the parameter spec, plus a ZeRO-1 'data' slice when enabled."""
    def walk(sp, sh):
        if isinstance(sp, dict):
            return {k: walk(sp[k], sh[k]) for k in sp}
        return shd.zero1_spec(sp, tuple(getattr(sh, "shape", sh)), axes) if zero1 else sp

    return AdamWState(m=walk(param_specs, param_shapes), v=walk(param_specs, param_shapes), count=shd.P())


def _sharded_init(model) -> AdamWState:
    """Zero moments keyed by JAX leaf path, placed by :func:`adamw_state_specs`."""
    mesh = model.mesh
    m, v = {}, {}
    for path, s, _, _ in model.jax_leaves():
        spec = shd.zero1_spec(s.spec, s.shape, model.axes) if model.parallel.zero1 else s.spec
        plc = shd.placements(spec, mesh)
        for tree in (m, v):
            local = torch.zeros(shd.local_shape(s.shape, mesh, plc), dtype=torch.float32, device=shd.mesh_device(mesh))
            tree[path] = DTensor.from_local(local, mesh, plc, run_check=False, shape=torch.Size(s.shape),
                                            stride=torch.empty(s.shape, device="meta").stride())
    return AdamWState(m=m, v=v, count=torch.zeros((), dtype=torch.int32, device=shd.mesh_device(mesh)))


def adamw_init(params) -> AdamWState:
    """Zero moments for ``params``: a module (its named parameters) or a dict;
    for a module placed on a mesh, JAX's sharded tree (module docstring)."""
    if getattr(params, "mesh", None) is not None:
        return _sharded_init(params)
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
    """sqrt of the sum of every leaf's squares, in f32; a DTensor leaf over
    its whole extent."""
    if any(isinstance(t, DTensor) for t in tree.values()):
        return torch.sqrt(shd.sharded_sumsq(tree.values()))
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
    if getattr(params, "mesh", None) is not None:
        _sharded_update(params, named, grads, state, cfg, decay_mask, (lr, b1c, b2c, scale))
    else:
        for k, p in named.items():
            p.copy_(_update(p.to(torch.float32), grads[k], state.m[k], state.v[k], cfg, (lr, b1c, b2c, scale),
                            decay_mask[k]))
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update(p_f32, g, m, v, cfg: TrainConfig, step, decay: bool):
    """One leaf's AdamW update on local tensors: ``m``/``v`` in place; returns
    the new parameter values.  ``step`` is (lr, 1 − b1^t, 1 − b2^t, clip scale)."""
    lr, b1c, b2c, scale = step
    gf = g.to(torch.float32) * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + EPS)
    if decay:
        delta = delta + cfg.weight_decay * p_f32
    return p_f32 - lr * delta


def _sharded_update(model, named: dict, grads: Mapping, state: AdamWState, cfg: TrainConfig, decay_mask, step):
    """:func:`adamw_apply`'s update of a model placed on a mesh (module docstring)."""
    mesh = model.mesh
    for path, _, names, stacked in model.jax_leaves():
        m, v = state.m[path], state.v[path]
        zplc = m.placements
        decay = decay_mask[names[0]]
        stack_dim = [k for k, pl in enumerate(zplc) if stacked and isinstance(pl, Shard) and pl.dim == 0]
        if not stack_dim:
            # each layer's slice of m/v is m/v's local [i]: update it, then
            # all-gather the new values into the parameter's placement
            lplc = [Shard(pl.dim - 1) if stacked and isinstance(pl, Shard) else pl for pl in zplc]
            for i, n in enumerate(names):
                p = named[n]
                ml, vl = (m.to_local()[i], v.to_local()[i]) if stacked else (m.to_local(), v.to_local())
                g = grads[n].redistribute(mesh, lplc).to_local()
                pz = p.redistribute(mesh, lplc).to_local()
                new = _update(pz.to(torch.float32), g, ml, vl, cfg, step, decay)
                new = DTensor.from_local(new.to(p.dtype), mesh, lplc, run_check=False, shape=p.shape, stride=p.stride())
                p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
            continue
        # the stack dim is sliced over mesh dim k: this rank updates the layers
        # it holds, and the new layers are all-gathered over k
        k = stack_dim[0]
        per = len(names) // mesh.size(k)
        first = mesh.get_coordinate()[k] * per
        ml, vl = m.to_local(), v.to_local()
        new = torch.empty(ml.shape, dtype=named[names[0]].dtype, device=ml.device)
        for j in range(per):
            p = named[names[first + j]]
            new[j] = _update(p.to_local().to(torch.float32), grads[names[first + j]].to_local(), ml[j], vl[j],
                             cfg, step, decay)
        full_plc = [Replicate() if d == k else pl for d, pl in enumerate(zplc)]
        stack = DTensor.from_local(new, mesh, zplc, run_check=False, shape=m.shape, stride=m.stride())
        stack = stack.redistribute(mesh, full_plc).to_local()
        for i, n in enumerate(names):
            named[n].to_local().copy_(stack[i])
