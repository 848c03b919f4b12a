"""Parameter schema: one declaration → shapes, counts and initializers.

The port's counterpart of the JAX package's ``models/schema.py``.  A model
declares its parameters as a nested dict of :class:`PSpec`; the modules
allocate their ``nn.Parameter``s from it, :func:`param_count` counts it
with no allocation, and :func:`init_params` / :func:`init_leaf_` fill it.
``PSpec`` carries no ``PartitionSpec``: the port's LM runs on one device.
:class:`SchemaModel` is the model protocol the three model classes share
(the JAX package's models share it by convention): how the schema's leaves
map onto the module's parameters, ``init``, the working copy, and
:func:`checkpointed`, their block-by-block rematerialization.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts


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


REMAT_MODES = ("none", "full", "dots", "offload")


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products with no batch dims."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, mode: str):
    """``fn`` (one block) rematerialized as ``mode`` (``ParallelConfig.remat``)
    says, for the three model classes: ``fn`` itself for "none" and while
    grad is disabled; non-reentrant ``torch.utils.checkpoint`` recomputing
    the whole block for "full" and "offload" (as the JAX xLSTM and
    encoder-decoder treat it; the decoder refuses "offload" before this);
    "dots" saves the block's ``aten.mm`` outputs (the products with no batch
    dims, as JAX's ``dots_with_no_batch_dims_saveable``)."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r} is not one of {REMAT_MODES}")
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kw)


class SchemaModel(nn.Module):
    """A model whose parameters are the leaves of its JAX schema.

    ``stacks`` names the schema's stacked subtrees (a scanned layer stack in
    JAX: every leaf carries a leading (L, …) axis) with their number of
    layers; the model holds each as a ``ModuleList`` of that name, so the
    stacked leaf ``layers.attn.wq`` is the parameters ``layers.0.attn.wq``,
    ``layers.1.attn.wq``, ….  Every other leaf is the parameter of its own
    path (an unstacked JAX layer ``layers.layer_003.block.up`` too).

    Subclasses set ``cfg``, ``parallel`` and ``stacks`` and define
    ``schema()``; the methods here are the model protocol that the loader,
    the optimizer, the checkpoints and the serving engine read.
    """

    stacks: dict

    def stacked_names(self, path: str) -> list[str] | None:
        """The per-layer parameter names behind a stacked schema path, or None."""
        head, _, rest = path.partition(".")
        if head not in self.stacks:
            return None
        return [f"{head}.{i}.{rest}" for i in range(self.stacks[head])]

    def schema_path(self, name: str) -> str:
        """The schema path of parameter ``name`` (the layer index dropped in a stack)."""
        head, _, rest = name.partition(".")
        return f"{head}.{rest.partition('.')[2]}" if head in self.stacks else name

    def layer_params(self, path: str) -> list[torch.Tensor]:
        """The parameters behind one schema path: L of them for a stacked path."""
        named = dict(self.named_parameters())
        return [named[n] for n in self.stacked_names(path) or [path]]

    def jax_leaf_dims(self) -> dict[str, int]:
        """Parameter name → the dims of the JAX leaf that holds it (one more
        than its own in a stack)."""
        dims = {path: len(s.shape) for path, s in leaves(self.schema())}
        return {n: dims[self.schema_path(n)] for n, _ in self.named_parameters()}

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every weight from ``generator`` (on the model's device), leaf by
        leaf as the schema declares them, each stacked leaf layer by layer
        at the stack's fan-in; then pack the routers."""
        for path, spec in leaves(self.schema()):
            for p in self.layer_params(path):
                init_leaf_(p, spec, generator)
        self.pack_routers()
        return self

    def tree_routers(self) -> list:
        """The hard tree routers the model serves through (K1); none by default."""
        return []

    def pack_routers(self) -> None:
        """Harden and pack every router tree after a change of weights."""

    def _meta_copy(self, cfg) -> "SchemaModel":
        return type(self)(cfg, device="meta", parallel=self.parallel)

    def cast_for_compute(self, dtype: str | None = None):
        """The working copy: a model whose weights are in the activation dtype.

        ``dtype`` replaces the config's activation dtype.  Leaves kept in f32
        by design (router, norm scales, gate biases, SSM decay) and leaves
        already in the dtype are the master tensors, shared; the packed
        routers are shared too.  With ``dtype="float32"`` every weight is
        shared and nothing is copied.
        """
        cfg = self.cfg if dtype is None else dataclasses.replace(self.cfg, dtype=dtype)
        work = self._meta_copy(cfg)
        work.load_state_dict(cast_for_compute(self.state_dict(), cfg.act_dtype), assign=True)
        work.requires_grad_(False)
        for mine, theirs in zip(work.tree_routers(), self.tree_routers()):
            mine.share_pack(theirs)
        return work

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device
