"""Parameter schema: one declaration → shapes, counts and initializers.

The port's counterpart of the JAX package's ``models/schema.py``.  A model
declares its parameters as a nested dict of :class:`PSpec`; the modules
allocate their ``nn.Parameter``s from it, :func:`param_count` counts it
with no allocation, and :func:`init_params` / :func:`init_leaf_` fill it.
``PSpec`` carries no ``PartitionSpec``: the port's LM runs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    init: str = "normal"    # normal | zeros | ones | ssm_log_a | uniform
    dtype: torch.dtype = torch.float32
    scale: float = 0.0      # 0 → fan-in default for "normal"


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def leaves(schema, prefix: str = "") -> Iterator[tuple[str, PSpec]]:
    """(dotted path, spec) of every leaf, in declaration order."""
    for name, sub in schema.items():
        path = f"{prefix}{name}"
        if is_pspec(sub):
            yield path, sub
        else:
            yield from leaves(sub, path + ".")


def stacked(schema, n: int):
    """``schema`` with a leading axis of ``n`` on every leaf (a scanned layer stack)."""
    return {
        k: dataclasses.replace(s, shape=(n, *s.shape)) if is_pspec(s) else stacked(s, n)
        for k, s in schema.items()
    }


def param_count(schema) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in leaves(schema)))


def init_scale(s: PSpec) -> float:
    """The "normal" init's standard deviation: ``s.scale``, else 1/√fan-in.

    The fan-in is the leading dim of a 1-D leaf, else the product of all
    dims but the last, counted on the spec's shape: for a scanned layer
    stack that is the stacked (L, …) shape, as in the JAX package.
    """
    fan_in = s.shape[0] if len(s.shape) == 1 else int(np.prod(s.shape[:-1]))
    return s.scale or 1.0 / max(1.0, float(np.sqrt(fan_in)))


@torch.no_grad()
def init_leaf_(t: torch.Tensor, s: PSpec, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place as ``_init_leaf`` (JAX ``schema.py:47``) draws ``s``.

    ``t`` may be one slice of the spec's shape (one layer of a stack); the
    init's scale comes from the spec.  Random leaves draw from
    ``generator``, which must live on ``t``'s device: the bits differ from
    ``jax.random``'s, so parity tests carry weights across instead.
    """
    if s.init == "zeros":
        return t.zero_()
    if s.init == "ones":
        return t.fill_(1.0)
    if s.init == "ssm_log_a":
        n = t.shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=t.device))
        return t.copy_(a.expand(t.shape))
    if s.init == "uniform":
        return t.uniform_(-0.5, 0.5, generator=generator)
    if t.dtype == torch.float32:
        return t.normal_(0.0, 1.0, generator=generator).mul_(init_scale(s))
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return t.copy_(draw.normal_(0.0, 1.0, generator=generator).mul_(init_scale(s)))


def init_params(schema, generator: torch.Generator, device=None) -> dict:
    """A nested dict of tensors for ``schema``, drawn leaf by leaf from ``generator``.

    ``device`` defaults to the card (see :func:`repro_torch._device.resolve`).
    """
    from repro_torch import _device

    dev = _device.resolve(None, device)
    out: dict = {}
    for path, s in leaves(schema):
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = init_leaf_(torch.empty(s.shape, dtype=s.dtype, device=dev), s, generator)
    return out


# f32-by-design leaves that must NOT be cast to the activation dtype
# (SSM decay constants, gate biases, norm scales, router params)
_KEEP_F32 = {
    "a_log", "d_skip", "w_if", "b_if", "b_gates", "scale",
    "router", "router_proj", "router_thr", "thr", "proj",
}


def cast_for_compute(params: dict, act_dtype: torch.dtype) -> dict:
    """The working copy of the weights in ``act_dtype``.

    ``params`` is nested or flat (dotted keys, as a ``state_dict``); a
    leaf's name is its last key.  Leaves of two or more dims in f32/f64
    whose name is not in ``_KEEP_F32`` are cast; every other leaf is the
    same tensor, shared, not copied.  The JAX package runs this inside
    every call; the port runs it once, when a model's working copy is made
    (``DecoderModel.cast_for_compute``), and the numbers are the same.
    """
    out = {}
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            out[key] = cast_for_compute(leaf, act_dtype)
            continue
        name = key.rsplit(".", 1)[-1]
        if leaf.dim() >= 2 and leaf.dtype in (torch.float32, torch.float64) and name not in _KEEP_F32:
            out[key] = leaf.to(act_dtype)
        else:
            out[key] = leaf
    return out


class SchemaModule(nn.Module):
    """A module whose parameters are declared by a flat schema (name → PSpec).

    Parameters are allocated uninitialized on ``device`` (``"meta"``
    allocates nothing); the model fills them (``DecoderModel.init``) or
    loads them (``models.convert.load_jax_params``).
    """

    def __init__(self, schema: dict, device):
        super().__init__()
        for name, s in schema.items():
            self.register_parameter(name, nn.Parameter(torch.empty(s.shape, dtype=s.dtype, device=device)))

    @property
    def params(self) -> dict:
        """The module's own weights by leaf name, as the functions take them."""
        return dict(self._parameters)
