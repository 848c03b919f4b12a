"""Parameter schema: one declaration → shapes, shardings, counts and initializers.

The port's counterpart of the JAX package's ``models/schema.py``.  A model
declares its parameters as a nested dict of :class:`PSpec`; the modules
allocate their ``nn.Parameter``s from it, :func:`param_count` counts it
with no allocation, and :func:`init_params` / :func:`init_leaf_` fill it.
Each ``PSpec`` carries the JAX leaf's ``PartitionSpec``
(:class:`repro_torch.parallel.sharding.PartitionSpec`), from the model's
mesh axes: ``param_specs()`` is the JAX model's tree, and
:meth:`SchemaModel.distribute` places the parameters by it across cards.
:class:`SchemaModel` is the model protocol the three model classes share
(the JAX package's models share it by convention): how the schema's leaves
map onto the module's parameters, ``init``, the working copy, the
placement across a mesh, and :func:`checkpointed`, their block-by-block
rematerialization.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    spec: shd.PartitionSpec = shd.P()
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
    """``schema`` with a leading axis of ``n`` on every leaf (a scanned layer
    stack), unsharded in every spec."""
    return {
        k: dataclasses.replace(s, shape=(n, *s.shape), spec=shd.P(None, *s.spec)) if is_pspec(s) else stacked(s, n)
        for k, s in schema.items()
    }


def unstacked(s: PSpec) -> PSpec:
    """One layer's leaf of a stacked leaf."""
    return dataclasses.replace(s, shape=s.shape[1:], spec=shd.P(*s.spec[1:]))


def nest(flat: dict) -> dict:
    """A nested dict from dotted paths."""
    out: dict = {}
    for path, v in flat.items():
        *parents, name = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return out


def cache_leaves(cache) -> dict:
    """{dotted field path: leaf} of a decode cache, or of its specs or
    shapes (NamedTuples and tuples; ``pos`` and absent parts left out)."""
    out = {}

    def walk(node, path):
        if node is None or path.endswith("pos"):
            return
        if isinstance(node, tuple):
            names = node._fields if hasattr(node, "_fields") else [str(i) for i in range(len(node))]
            for name, child in zip(names, node):
                walk(child, f"{path}.{name}" if path else name)
        else:
            out[path] = node

    walk(cache, "")
    return out


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
    if isinstance(t, DTensor):     # draw the whole leaf, keep this rank's block
        full = init_leaf_(torch.empty(t.shape, dtype=t.dtype, device=t.device), s, generator)
        t.to_local().copy_(shd.local_shard(full, t.device_mesh, t.placements))
        return t
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
    encoder-decoder treat it; the decoder offloads the saved input around
    this, ``models.lm._offloaded``);
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

    Subclasses set ``cfg``, ``parallel``, ``axes`` (the mesh axes its
    shapes and specs are for) and ``stacks`` and define ``schema()``; the
    methods here are the model protocol that the loader, the optimizer, the
    checkpoints and the serving engine read.

    **Across cards.**  :meth:`distribute` places every parameter on a
    ``DeviceMesh`` as a DTensor by its JAX spec.  Each block
    (:meth:`blocks`) gathers its weights when it is called and releases them
    when it returns (a rematerialized block gathers again in the backward
    pass), and the other weights (embedding, final norm, head) are gathered
    around a step by :meth:`gathered_top`.  The train step, ``prefill`` and
    ``decode_step`` take the global batch and compute on this rank's rows
    (:meth:`on_batch_shards`); where :meth:`model_split` says so the
    step also splits over ``model`` (``shd.model_shards``): the decoders'
    sequence-parallel residual, the SSM's channels, the mLSTM's and the
    encoder's heads, vocab-sharded logits, expert-parallel MoE and a split
    decode cache.  A block names the weights it takes as its rank's
    ``model`` block (``model_local_names``) and the whole ones each rank
    uses a slice of (``model_partial_names``).
    """

    stacks: dict
    axes: shd.MeshAxes
    mesh = None          # the DeviceMesh the parameters are placed on, else None

    @property
    def scanned(self) -> bool:
        """Whether JAX's tree stacks the layers of ``stacks`` (L, …)."""
        return True

    def jax_leaves(self) -> list[tuple[str, PSpec, list[str], bool]]:
        """(JAX leaf path, its PSpec, the parameter names that hold it, stacked)
        of every leaf of the JAX model's tree, in declaration order.  A stacked
        leaf is held by one parameter a layer; where JAX does not scan, its
        tree holds the layers one by one as ``<stack>.layer_000.…``."""
        out = []
        for path, s in leaves(self.schema()):
            names = self.stacked_names(path)
            if names is None:
                out.append((path, s, [path], False))
            elif self.scanned:
                out.append((path, s, names, True))
            else:
                head, _, rest = path.partition(".")
                out += [(f"{head}.layer_{i:03d}.{rest}", unstacked(s), [n], False) for i, n in enumerate(names)]
        return out

    def param_specs(self) -> dict:
        """The JAX model's ``param_specs()``: a nested dict of specs."""
        return nest({path: s.spec for path, s, _, _ in self.jax_leaves()})

    def param_shapes(self) -> dict:
        """The JAX model's leaf shapes, nested as :meth:`param_specs`."""
        return nest({path: tuple(s.shape) for path, s, _, _ in self.jax_leaves()})

    def parameter_specs(self) -> dict[str, shd.PartitionSpec]:
        """Parameter name → its spec (a stacked leaf's without the stack dim)."""
        out = {}
        for _, s, names, stacked in self.jax_leaves():
            for n in names:
                out[n] = shd.P(*s.spec[1:]) if stacked else s.spec
        return out

    def blocks(self) -> list[nn.Module]:
        """The modules that gather their own weights when sharded: every layer
        of the stacks."""
        return [m for head in self.stacks for m in self._modules[head]]

    def _block_heads(self) -> set:
        return set(self.stacks)

    def distribute(self, mesh) -> "SchemaModel":
        """Place every parameter on ``mesh`` as a DTensor by its spec, in place,
        and make the blocks gather their weights when called.

        The mesh's sizes must be the model's ``axes`` (they set the padded
        vocabulary and experts).  A parameter on ``meta`` gets an empty block
        on the mesh's device (fill it with :meth:`init`); any other is
        taken as the whole tensor, the same on every rank, and each rank
        keeps its block.
        """
        if self.mesh is not None:
            raise RuntimeError("the model is already distributed")
        if shd.mesh_sizes(mesh) != dict(self.axes.sizes):
            raise ValueError(f"mesh {shd.mesh_sizes(mesh)} is not the model's axes {self.axes.sizes}")
        specs = self.parameter_specs()
        meta = False
        for name, p in list(self.named_parameters()):
            plc = shd.placements(specs[name], mesh)
            if p.is_meta:
                meta = True
                local = torch.empty(shd.local_shape(p.shape, mesh, plc), dtype=p.dtype, device=shd.mesh_device(mesh))
                dt = DTensor.from_local(local, mesh, plc, run_check=False, shape=p.shape,
                                        stride=torch.empty(p.shape, device="meta").stride())
            else:
                dt = shd.place(p.detach(), mesh, specs[name])
            owner, leaf = shd.owner_of(self, name)
            owner._parameters[leaf] = nn.Parameter(dt, requires_grad=p.requires_grad)
        self.mesh = mesh
        self.placed = dict(self.named_parameters())
        shd.gather_in_blocks(self.blocks())
        if not meta:
            self.pack_routers()
        return self

    def splits(self) -> bool:
        """Placed on a mesh whose ``model`` splits the compute (``tp`` on and
        ``model`` above 1)."""
        return self.mesh is not None and shd.model_dim(self.mesh, self.axes) is not None

    def gathered_logits(self, logits: torch.Tensor, batch: dict) -> torch.Tensor:
        """Every vocabulary column of this rank's rows of ``prefill`` or
        ``decode_step`` logits (all-gathered over ``model`` where the step
        split it); ``batch`` is the step's global batch."""
        with self.on_batch_shards(batch, decode=True):
            return shd.model_gather(logits, dim=-1)

    def model_split(self, batch: dict) -> bool | None:
        """Whether a step on the global ``batch`` splits its compute over
        ``model`` with a sequence-split residual (True), splits it with the
        ranks holding the same tokens (False), or does not split it (None:
        the default, and the model's own choice where ``model`` is 1)."""
        return None

    def top_local_names(self, decode: bool) -> set:
        """The weights outside the blocks that a split step gathers itself,
        left out of :meth:`gathered_top`: the output projection's vocabulary
        slice (:meth:`_out_w`), and at decode the embedding table's too (the
        lookup is vocab-sharded)."""
        names = set() if self.cfg.tie_embeddings else {"lm_head.w"}
        return names | {"embed.table"} if decode else names

    def _out_w(self, dtype: torch.dtype) -> torch.Tensor:
        """(D, V_pad): the output projection (the tied table's transpose);
        under split compute this rank's vocabulary columns."""
        tied = self.cfg.tie_embeddings
        if shd.active_model() is not None:
            w = shd.gather(self.placed["embed.table" if tied else "lm_head.w"], keep_model=True).to(dtype)
        else:
            w = (self._modules["embed"].table if tied else self._modules["lm_head"].w).to(dtype)
        return w.T if tied else w

    def gathered_top(self, decode: bool = False):
        """A context in which the weights outside the blocks (embedding, norms,
        head) are gathered, but for :meth:`top_local_names`; nothing to do
        on one device."""
        if self.mesh is None:
            return contextlib.nullcontext()
        heads = self._block_heads()
        local = self.top_local_names(decode) if shd.active_model() is not None else set()
        return shd.gathered(self, [n for n, p in self.named_parameters()
                                   if n.split(".")[0] not in heads and isinstance(p, DTensor) and n not in local])

    @contextlib.contextmanager
    def on_batch_shards(self, batch: dict, decode: bool = False):
        """This rank's rows of the global ``batch``, with the batch shards
        active (``shd.batch_shards``), the model shards too where
        :meth:`model_split` says so (``shd.model_shards``), and the weights
        outside the blocks gathered; the batch itself on one device.  Every
        rank passes the same global batch; the process-wide shards are
        restored on exit.  The sequence is not cut here: the model's
        embedding takes its positions."""
        if self.mesh is None:
            yield batch
            return
        b = next(iter(batch.values())).shape[0]
        split = self.model_split(batch)
        with contextlib.ExitStack() as stack:
            shards = stack.enter_context(shd.batch_shards(self.mesh, self.axes, b))
            if split is not None:
                stack.enter_context(shd.model_shards(self.mesh, self.axes, seq=split))
            stack.enter_context(self.gathered_top(decode))
            yield shd.local_batch(batch, shards)

    def block_weights(self, block: nn.Module, decode: bool = True):
        """A context in which ``block``'s weights are gathered, for a block
        method other than ``forward`` (decode, or a prefill under no grad):
        ``forward`` gathers them itself.  Under split compute the block's
        ``model_local_names(decode)`` stay this rank's ``model`` blocks."""
        if self.mesh is None:
            return contextlib.nullcontext()
        keep = ()
        if shd.active_model() is not None and hasattr(block, "model_local_names"):
            keep = block.model_local_names(decode=decode)
        return shd.gathered(block, [n for n, p in block.named_parameters() if isinstance(p, DTensor)], keep)

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
        return type(self)(cfg, device="meta", parallel=self.parallel, axes=self.axes)

    def cast_for_compute(self, dtype: str | None = None):
        """The working copy: a model whose weights are in the activation dtype.

        ``dtype`` replaces the config's activation dtype.  Leaves kept in f32
        by design (router, norm scales, gate biases, SSM decay) and leaves
        already in the dtype are the master tensors, shared; the packed
        routers are shared too.  With ``dtype="float32"`` every weight is
        shared and nothing is copied.
        """
        if self.mesh is not None:
            raise NotImplementedError("a sharded model has no working copy: sharded serving is not ported")
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
