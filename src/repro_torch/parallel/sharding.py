"""Device grids of the sharded forest, and the divisibility-aware sharding
policy of the LM across cards.

The port's counterpart of the JAX package's ``parallel/sharding.py``, in
two halves.

**The forest.**  There a plan lowers onto a ``jax.sharding.Mesh`` and
``shard_map``; here one process drives the node's cards directly, so a
mesh is a (records × trees) grid of ``torch.device`` objects that the
executor walks shard by shard (:class:`repro_torch.dist.ShardedForestEvaluator`).
A grid may name one device several times: ``("cpu",) * 8`` on the host, or
``("cuda:0",) * 4`` on one card, lays out four logical shards that run one
after another on the same device.  That is the port's counterpart of
``--xla_force_host_platform_device_count``: it exercises the sharding,
padding and gathering, and measures nothing about several cards.

**The LM.**  One process per card under ``torch.distributed``; a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names
(``("data", "model")`` or ``("pod", "data", "model")``, see
:mod:`repro_torch.launch.mesh`).  :class:`MeshAxes` and the ``*_specs``
helpers are the JAX policy, line for line: every tensor dim asks *shard
over this axis iff divisible*, and the vocabulary and the experts are
padded so that they shard densely.  A spec is the port's
:class:`PartitionSpec`, equal as a tuple to JAX's ``P``;
:func:`placements` turns it into DTensor placements and
:func:`distribute` places a tree of tensors by a tree of specs.

Storage is decoupled from compute, as the JAX docstring of
:func:`attn_specs` says.  Parameters live as DTensors placed by their
specs (FSDP over ``data``, TP or EP over ``model``).  A step computes on
this rank's batch shard (:func:`local_batch`) and, with ``tp`` on and
``model`` > 1, splits its work over the ``model`` dim as the JAX mesh
program's activation constraints do (:class:`ModelShards`):

  * the residual stream is sequence-parallel: each rank of a ``model`` row
    holds ``S/|model|`` positions between blocks (JAX's ``_constrain_resid``,
    ``P(batch, free_model_seq(...), None)``), and attention all-gathers K
    and V along the sequence (:func:`seq_gather`);
  * the logits and the loss are vocab-sharded (``P(batch, None, model)``):
    each rank projects onto its ``V_pad/|model|`` columns and the
    cross-entropy reduces over ``model`` (:func:`model_sum`, :func:`model_max`);
  * the MoE runs each expert only on the rank that stores it
    (``P(batch, model, None, None)`` on ``exp_in``/``out_e``): tokens reach
    their experts and come back by an all-to-all (:func:`model_all_to_all`);
  * decode splits its cache by KV heads where they divide ``model``, else by
    sequence, and multiplies by its column and row slices of the weights,
    with one all-reduce a sum (:func:`model_sum`).

Dense weights are still gathered whole just in time under the sequence
split (:func:`gather`, ZeRO-3 for (batch × sequence)-sharded activations);
the weights whose ``model`` block is the compute's own share (the experts,
the vocabulary slice of the output projection, and at decode the heads'
and ``d_ff``'s slices) are gathered over ``data`` only
(``keep_model=True``).  Gradients come back reduce-scattered into the
storage placement: partial sums over the batch shards, and over ``model``
where its ranks hold distinct tokens.  The collectives over ``model`` are
``torch.autograd.Function``s with their transposed backward.  The loss's
token sums and the MoE load-balance statistics are summed over the shards
inside the step (:func:`batch_sum`, :func:`token_mean`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

AXES = ("records", "trees")


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGrid:
    """A (records × trees) grid of devices.

    Attributes:
      devices: (R, G) object array of ``torch.device``.
      axis_names: ``("records", "trees")``, as the JAX mesh names its axes.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...] = AXES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __getitem__(self, rg: tuple[int, int]) -> torch.device:
        return self.devices[rg]


def pad_to_multiple(dim: int, size: int) -> int:
    """Round ``dim`` up to a multiple of ``size`` (the divisibility policy:
    when a dimension must shard, pad it dense instead of replicating — the
    executor's record and tree padding both go through here)."""
    if size <= 1:
        return dim
    return ((dim + size - 1) // size) * size


def normal_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``"cuda"`` → the
    current card), so that two names of one card compare equal; a CUDA
    device without a card raises."""
    from repro_torch import _device

    device = _device.resolve(None, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def node_devices() -> list[torch.device]:
    """Every card of this node, ``cuda:0 … cuda:D-1``; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices=('cpu',) to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def forest_mesh(record_shards: int, tree_shards: int,
                devices: Sequence | None = None) -> DeviceGrid:
    """(records × trees) grid over the first R·G devices.

    Axis ``"records"`` carries the data decomposition (the §3.6 M/P slicing
    lifted to devices), axis ``"trees"`` carries the forest.  Plans may use
    fewer devices than the node has (a feasibility-clamped plan on a small
    workload).  ``devices`` defaults to every card (:func:`node_devices`).
    """
    devs = [normal_device(d) for d in (node_devices() if devices is None else devices)]
    need = record_shards * tree_shards
    if need > len(devs):
        raise ValueError(f"plan needs {need} devices, the grid has {len(devs)}")
    grid = np.empty((record_shards, tree_shards), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i // tree_shards, i % tree_shards] = d
    return DeviceGrid(grid)


def map_record_shards(records, devices: Sequence, fn) -> torch.Tensor:
    """Shard ``records`` over a 1-D device grid, run ``fn`` on each shard, gather.

    Records are zero-padded to a multiple of the grid's size and split into
    equal runs of rows; ``fn(rows, device)`` evaluates one run on its device
    (the rows already there) and returns its (rows,) result.  The results
    are gathered, padding dropped, into one tensor on the grid's first
    device.  Nothing here waits on a device.
    """
    from repro_torch import _device

    devs = [normal_device(d) for d in devices]
    rec = _device.as_tensor(records, torch.float32, _device.resolve(records, devs[0]))
    m = rec.shape[0]
    m_pad = pad_to_multiple(max(m, len(devs)), len(devs))
    if m_pad != m:
        padded = torch.zeros((m_pad, rec.shape[1]), dtype=torch.float32, device=rec.device)
        padded[:m] = rec
        rec = padded
    step = m_pad // len(devs)
    outs = [fn(rec[i * step:(i + 1) * step].to(d, non_blocking=True), d) for i, d in enumerate(devs)]
    return torch.cat([o.to(devs[0], non_blocking=True) for o in outs])[:m]


# ---------------------------------------------------------------------------
# The LM's mesh axes and specs (JAX ``parallel/sharding.py``)
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """A tensor's sharding: one entry a dim, each ``None``, a mesh axis name,
    or a tuple of axis names (the dim split over them, the first the major).

    A tuple, equal as a tuple to JAX's ``PartitionSpec`` of the same
    entries; dims past its end are replicated.  As JAX's, it stores a
    one-axis tuple as the axis and an empty tuple as ``None``.
    """

    def __new__(cls, *entries):
        def canonical(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e

        return super().__new__(cls, tuple(canonical(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical→physical axis mapping for one mesh."""

    batch: tuple                    # e.g. ("data",) or ("pod", "data")
    model: str                      # "model"
    sizes: dict                     # axis name → size
    fsdp: Optional[str] = "data"    # axis of 2-D (FSDP) parameter sharding; None = off
    tp: bool = True                 # tensor-parallel storage over 'model'; False → the
                                    # model axis joins the batch axes (DP-only)

    @property
    def batch_size(self) -> int:
        out = 1
        for a in self.batch:
            out *= self.sizes[a]
        return out

    @property
    def model_size(self) -> int:
        return self.sizes[self.model]

    @property
    def tp_axis(self) -> Optional[str]:
        return self.model if self.tp else None

    def shard_if(self, dim: int, axis: Optional[str] = None):
        """The model axis name iff ``dim`` divides evenly, else None."""
        if not self.tp and (axis is None or axis == self.model):
            return None
        axis = axis or self.model
        size = self.sizes[axis] if isinstance(axis, str) else 1
        return axis if dim % size == 0 and dim >= size else None

    def fsdp_if(self, dim: int):
        """The FSDP axis iff enabled and ``dim`` divides: parameters gain a
        second shard dim, gathered just in time (the ZeRO-3 pattern)."""
        if self.fsdp is None:
            return None
        size = self.sizes.get(self.fsdp, 1)
        return self.fsdp if dim % size == 0 and dim >= size else None

    def batch_if(self, dim: int):
        """The batch axes iff ``dim`` divides by their whole extent, else None."""
        return self.batch if dim % self.batch_size == 0 and dim >= self.batch_size else None

    def batch_axes_for(self, dim: int):
        """The largest-product subset of the batch axes dividing ``dim``
        (not a greedy prefix: a batch of 256 on the 2×16×16 DP-only mesh takes
        (data, model) and leaves 'pod' idle); None when none divides."""
        best, best_prod = None, 0
        n = len(self.batch)
        for mask in range(1, 1 << n):
            axes = tuple(self.batch[i] for i in range(n) if mask >> i & 1)
            prod = 1
            for a in axes:
                prod *= self.sizes[a]
            if dim % prod == 0 and prod > best_prod:
                best, best_prod = axes, prod
        return best


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def from_mesh(mesh, *, fsdp: bool = True, tp: bool = True) -> MeshAxes:
    """The axes of a ``DeviceMesh`` named as :mod:`repro_torch.launch.mesh` names them."""
    names = tuple(mesh.mesh_dim_names)
    batch = tuple(n for n in names if n in ("pod", "data"))
    if not tp:
        batch = batch + ("model",)   # DP-only: the model axis carries batch
    return MeshAxes(batch=batch, model="model", sizes=mesh_sizes(mesh),
                    fsdp="data" if fsdp else None, tp=tp)


def single_device_axes() -> MeshAxes:
    """Degenerate axes for one device (everything replicated)."""
    return MeshAxes(batch=("data",), model="model", sizes={"data": 1, "model": 1})


def free_model_seq(axes: MeshAxes, batch_dim: int, seq_dim: int):
    """The sequence-parallel axis when 'model' does not already carry batch."""
    ba = axes.batch_axes_for(batch_dim) or ()
    if axes.model in ba:
        return None
    m = axes.model_size
    return axes.model if (seq_dim % m == 0 and seq_dim >= m) else None


VOCAB_LANE = 128


def pad_vocab(vocab: int, axes: MeshAxes | None = None, lane: int = VOCAB_LANE) -> int:
    """The vocabulary padded to shard densely: a multiple of lane·|model|
    (granite's 49,155 → 49,280 on one device, 49,408 on ``model=2``)."""
    axes = axes or single_device_axes()
    return pad_to_multiple(vocab, lane * (axes.model_size if axes.tp else 1))


def attn_specs(axes: MeshAxes, n_heads: int, n_kv_heads: int, d_model: int = 0, head_dim: int = 0) -> dict:
    """QKV/O projection storage specs: (data × model) over the flattened
    weight dims, so that the model axis shards H·hd even where the head
    count does not divide it."""
    d = axes.fsdp_if(d_model) if d_model else None
    hd = head_dim or (d_model // max(n_heads, 1) if d_model else 0)
    q_out = axes.shard_if(n_heads * hd) if hd else axes.shard_if(n_heads)
    kv_out = axes.shard_if(n_kv_heads * hd) if hd else axes.shard_if(n_kv_heads)
    return {"wq": P(d, q_out), "wk": P(d, kv_out), "wv": P(d, kv_out), "wo": P(q_out, d)}


def mlp_specs(axes: MeshAxes, d_ff: int, d_model: int = 0) -> dict:
    f = axes.shard_if(d_ff)
    d = axes.fsdp_if(d_model) if d_model else None
    return {"wi": P(d, f), "wg": P(d, f), "wo": P(f, d)}


def moe_specs(axes: MeshAxes, n_experts: int, d_ff: int, d_model: int = 0) -> dict:
    e = axes.shard_if(n_experts)
    f = axes.shard_if(d_ff) if e is None else None  # EP first; else TP inside experts
    d = axes.fsdp_if(d_model) if d_model else None
    return {"wi": P(e, d, f), "wg": P(e, d, f), "wo": P(e, f, d)}


def embed_specs(axes: MeshAxes, d_model: int = 0) -> dict:
    d = axes.fsdp_if(d_model) if d_model else None
    return {"table": P(axes.model, d)}   # (V_padded, D): vocab-sharded


def norm_specs() -> dict:
    return {"scale": P(None)}


def _map_specs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def prepend(spec_tree, extra=None):
    """Add a leading (layer-stack) dim to every spec in a tree."""
    return _map_specs(lambda s: P(extra, *s), spec_tree)


def batch_spec(axes: MeshAxes, *rest) -> PartitionSpec:
    return P(axes.batch, *rest)


def zero1_spec(spec: PartitionSpec, shape: Sequence[int], axes: MeshAxes) -> PartitionSpec:
    """ZeRO-1: additionally shard the largest unsharded dim over 'data'.

    Optimizer-state tensors follow their parameter spec; any dim not already
    sharded is a candidate for slicing over the data axis.  Falls back to the
    parameter spec when nothing divides.
    """
    data = "data"
    used = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            used.update(entry)
        else:
            used.add(entry)
    if data in used:
        return spec
    n = axes.sizes.get(data, 1)
    best_dim, best_size = -1, 0
    for i, d in enumerate(shape):
        taken = spec[i] if i < len(spec) else None
        if taken is None and d % n == 0 and d > best_size and d >= n:
            best_dim, best_size = i, d
    if best_dim < 0:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[best_dim] = data
    return P(*parts)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim k gets ``Shard(i)``
    if tensor dim i names that axis, else ``Replicate()``.

    A dim naming several axes is sharded on each of them; DTensor splits it
    in mesh-dim order, the first the major, which is JAX's order when the
    spec lists the axes in mesh order (anything else raises).
    """
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of the mesh's {names}")
            k = names.index(a)
            if not isinstance(out[k], Replicate):
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            out[k] = Shard(i)
            idx.append(k)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {i} lists {axes} out of the mesh's order {names}")
    return tuple(out)


def local_shard(full: torch.Tensor, mesh, plc: Sequence) -> torch.Tensor:
    """This rank's block of ``full`` under ``plc`` (a view; no communication).
    Every sharded dim divides by its mesh dims (the policy pads or replicates
    where it would not)."""
    coord = mesh.get_coordinate()
    t = full
    for k, p in enumerate(plc):
        if isinstance(p, Shard):
            n = mesh.size(k)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does not split into {n}")
            t = t.chunk(n, dim=p.dim)[coord[k]]
    return t


def local_shape(shape: Sequence[int], mesh, plc: Sequence) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under ``plc``."""
    out = list(shape)
    for k, p in enumerate(plc):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(k)
    return tuple(out)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its current card, or the host."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(full: torch.Tensor, mesh, spec: PartitionSpec) -> DTensor:
    """``full`` (the same on every rank) as a DTensor placed by ``spec``: each
    rank keeps its own block, on the mesh's device."""
    plc = placements(spec, mesh)
    # a copy: a view would keep the whole of ``full`` alive
    local = local_shard(full, mesh, plc).to(mesh_device(mesh)).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, plc, run_check=False, shape=full.shape, stride=full.stride())


def distribute(tree, mesh, spec_tree):
    """A nested dict of tensors placed by a matching tree of specs (JAX's
    ``device_put(tree, tree_named(mesh, specs))``)."""
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, spec_tree[k]) for k, v in tree.items()}
    return place(tree, mesh, spec_tree)


def constrain(x, spec: PartitionSpec):
    """JAX's ``with_sharding_constraint``: a plain tensor is returned as it
    is.  The port takes each layout explicitly where JAX constrains one (the
    calls of :func:`seq_gather`, :func:`model_all_to_all` and the vocabulary
    slices cite JAX's sites)."""
    return x


# ---------------------------------------------------------------------------
# Compute on batch shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchShards:
    """The mesh dims that carry the batch in one step, and this rank's shard."""

    mesh: object
    dims: tuple[int, ...]

    @property
    def count(self) -> int:
        return math.prod(self.mesh.size(d) for d in self.dims)

    @property
    def index(self) -> int:
        """This rank's shard, the first batch dim the major."""
        coord = self.mesh.get_coordinate()
        i = 0
        for d in self.dims:
            i = i * self.mesh.size(d) + coord[d]
        return i

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the batch shards."""
        for d in self.dims:
            if self.mesh.size(d) > 1:
                dist.all_reduce(t, group=self.mesh.get_group(d))
        return t


# The active step's batch shards: a process-wide value, not a context
# variable, because the backward pass (and the block recomputation in it)
# runs on autograd's device threads.
_BATCH: Optional[BatchShards] = None


def batch_dims(mesh, axes: MeshAxes, batch: int) -> tuple[int, ...]:
    """The mesh dims over which a global batch of ``batch`` rows is split."""
    ba = axes.batch_axes_for(batch) or ()
    names = list(mesh.mesh_dim_names)
    return tuple(sorted(names.index(a) for a in ba))


@contextlib.contextmanager
def batch_shards(mesh, axes: MeshAxes, batch: int) -> Iterator[BatchShards]:
    """Run a step's forward and backward on the shards of a global batch of
    ``batch`` rows (:func:`batch_dims`): :func:`batch_sum` and
    :func:`batch_mean` reduce over them, and :func:`gather` hands gradients
    back as partial sums over them."""
    global _BATCH
    prev, _BATCH = _BATCH, BatchShards(mesh, batch_dims(mesh, axes, batch))
    try:
        yield _BATCH
    finally:
        _BATCH = prev


def active_shards() -> Optional[BatchShards]:
    return _BATCH


def local_batch(batch: dict, shards: BatchShards) -> dict:
    """This rank's rows of a global batch (every rank holds the same one)."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % shards.count:
            raise ValueError(f"batch {k!r} of {b} rows does not split into {shards.count} shards")
        step = b // shards.count
        out[k] = x[shards.index * step:(shards.index + 1) * step]
    return out


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the batch shards, whose gradient reaches this
    rank's own term only: summed over the ranks (the ``Partial`` gradients
    of :func:`gather`), the gradients are those of the global sum.  ``t``
    itself outside :func:`batch_shards`."""
    shards = _BATCH
    if shards is None or shards.count == 1:
        return t
    total = shards.all_reduce(t.detach().clone())
    return total + (t - t.detach())      # exactly the total, the same on every rank


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the batch shards (each holds as many rows), its
    gradient reaching this rank's term as ``1/shards``; ``t`` outside
    :func:`batch_shards`."""
    shards = _BATCH
    if shards is None or shards.count == 1:
        return t
    return batch_sum(t) / torch.full((), float(shards.count), dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# Compute over 'model'
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """The ``model`` mesh dim over which a step splits its compute, and this
    rank's place on it.  ``seq``: the residual stream is sequence-split over
    it in this step (the ranks hold distinct tokens); else its ranks hold
    the same tokens and split the weights' work (decode, or a sequence
    that does not divide)."""

    mesh: object
    dim: int
    seq: bool = False

    @property
    def size(self) -> int:
        return self.mesh.size(self.dim)

    @property
    def index(self) -> int:
        return self.mesh.get_coordinate()[self.dim]

    @property
    def group(self):
        return self.mesh.get_group(self.dim)


# The active step's model shards (process-wide, as ``_BATCH``).
_MODEL: Optional[ModelShards] = None


def model_dim(mesh, axes: MeshAxes) -> Optional[int]:
    """The mesh dim over which compute splits: ``model`` with ``tp`` on and
    a size above 1, else None."""
    if not axes.tp or axes.model_size <= 1:
        return None
    return list(mesh.mesh_dim_names).index(axes.model)


@contextlib.contextmanager
def model_shards(mesh, axes: MeshAxes, *, seq: bool) -> Iterator[Optional[ModelShards]]:
    """Split the step's compute over ``model`` (:class:`ModelShards`); nothing
    is split where :func:`model_dim` is None.  Restored on exit."""
    global _MODEL
    dim = model_dim(mesh, axes)
    prev, _MODEL = _MODEL, (None if dim is None else ModelShards(mesh, dim, seq))
    try:
        yield _MODEL
    finally:
        _MODEL = prev


def active_model() -> Optional[ModelShards]:
    return _MODEL


def _done(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


# the functional collectives' names in this torch (``*_single`` from 2.13 on)
_FUNCOL_GATHER = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_FUNCOL_SCATTER = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _done(_FUNCOL_GATHER(x.contiguous(), dim, group))


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _done(_FUNCOL_SCATTER(x.contiguous(), "sum", dim, group))


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    return _done(funcol.all_reduce(x.contiguous(), op, group))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _done(funcol.all_to_all_single(x.contiguous(), None, None, group))


class _SeqGather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (each rank's
    gradient of the whole is a partial sum over the ranks' consumers)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SumPartial(torch.autograd.Function):
    """All-reduce of a partial sum whose total every rank consumes alike;
    backward: the identity (each rank's term gets the total's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterSplit(torch.autograd.Function):
    """The identity on a tensor every rank holds alike, consumed by a split
    computation; backward: the all-reduce of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _GatherAlike(torch.autograd.Function):
    """All-gather along ``dim`` of blocks whose whole every rank consumes
    alike; backward: this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.index, ctx.size = dim, index, size
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """All-to-all over dim 0 in equal chunks (chunk i to rank i); backward:
    the same exchange of the gradient, its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def seq_gather(x: torch.Tensor, dim: int = 1, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The whole sequence of a sequence-split tensor, all-gathered over
    ``model``; the gradient comes back reduce-scattered."""
    shards = shards or _MODEL
    return _SeqGather.apply(x, dim, shards.group)


def seq_scatter(x: torch.Tensor, dim: int = 1, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The sum over ``model`` of ``x``, each rank keeping its block along
    ``dim``; the gradient comes back all-gathered."""
    shards = shards or _MODEL
    return _ScatterSum.apply(x, dim, shards.group)


def model_sum(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x``, the same on every
    rank; its gradient is the identity."""
    shards = shards or _MODEL
    return _SumPartial.apply(x, shards.group)


@torch.no_grad()
def model_max(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient: a stabilizer)."""
    shards = shards or _MODEL
    return _all_reduce(x.detach(), "max", shards.group)


def enter_split(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """``x`` (the same on every rank of ``model``) for a computation split over
    ``model``: the gradients of the ranks' shares are summed in the backward."""
    shards = shards or _MODEL
    return _EnterSplit.apply(x, shards.group)


def gather_alike(x: torch.Tensor, dim: int, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """Each rank's block along ``dim``, all-gathered for a consumer that every
    rank runs alike; the gradient is sliced back to this rank's block."""
    shards = shards or _MODEL
    return _GatherAlike.apply(x, dim, shards.group, shards.index, shards.size)


def model_all_to_all(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """All-to-all over ``model`` of ``x`` (|model|, …): block i goes to rank i,
    and block j of the result came from rank j."""
    shards = shards or _MODEL
    return _AllToAll.apply(x, shards.group)


@torch.no_grad()
def model_gather(x: torch.Tensor, dim: int = -1, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The whole of ``x`` along ``dim`` (a result's vocabulary columns, say)
    from every rank's block over ``model`` (default: the active shards);
    ``x`` itself where none are active (no gradient)."""
    shards = shards or _MODEL
    if shards is None:
        return x
    return _all_gather(x, dim % x.dim(), shards.group)


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """Rows ``tokens`` of an embedding table split by vocabulary rows over
    ``model``, ``table`` this rank's block: each rank looks up the ids it
    holds (zeros for the others) and the rows are summed over ``model``."""
    shards = shards or _MODEL
    local = tokens - shards.index * table.shape[0]
    own = (local >= 0) & (local < table.shape[0])
    x = torch.where(own[..., None], table[local.clamp(0, table.shape[0] - 1)], 0.0)
    return model_sum(x, shards)


def whole_tokens(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """Every token of this rank's rows, for a computation split over
    ``model`` that every rank runs on all of them (its channels, heads or
    vocabulary columns): all-gathered along dim 1 where the residual is
    sequence-split, else entering the split (the gradient summed over
    ``model`` either way)."""
    shards = shards or _MODEL
    return seq_gather(x, 1, shards) if shards.seq else enter_split(x, shards)


def residual_sum(y: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The ranks' partial outputs over every token (:func:`whole_tokens`)
    summed over ``model`` into the residual's layout: reduce-scattered
    along dim 1 where it is sequence-split, else all-reduced."""
    shards = shards or _MODEL
    return seq_scatter(y, 1, shards) if shards.seq else model_sum(y, shards)


def shared_sum(x: torch.Tensor, shards: Optional[ModelShards] = None) -> torch.Tensor:
    """The sum over ``model`` of partial sums (a contraction over a split
    dim) whose total each rank then consumes in its own way: all-reduced,
    and the gradient all-reduced too (:func:`model_sum` then
    :func:`enter_split`)."""
    shards = shards or _MODEL
    return enter_split(model_sum(x, shards), shards)


def token_sum(t: torch.Tensor) -> torch.Tensor:
    """:func:`batch_sum` over every shard that holds distinct tokens: the
    batch shards, and ``model`` where the residual is sequence-split."""
    shards, model = _BATCH, _MODEL
    over_model = model is not None and model.seq
    if (shards is None or shards.count == 1) and not over_model:
        return t
    total = t.detach().clone()
    if shards is not None:
        shards.all_reduce(total)
    if over_model:
        dist.all_reduce(total, group=model.group)
    return total + (t - t.detach())


def token_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the shards of :func:`token_sum` (each holds as
    many tokens)."""
    shards, model = _BATCH, _MODEL
    n = (1 if shards is None else shards.count) * (model.size if model is not None and model.seq else 1)
    if n == 1:
        return t
    return token_sum(t) / torch.full((), float(n), dtype=t.dtype, device=t.device)


def gather(p, keep_model: bool = False, partial: bool = False, seq: Optional[bool] = None) -> torch.Tensor:
    """Parameter ``p`` as a plain tensor on this rank, for the plain module
    code (``p`` itself if it is not a DTensor): the whole of it, or with
    ``keep_model`` this rank's block over the active ``model`` dim
    (gathered over the other dims; the whole where no model shards are
    active or ``p`` is not sharded over ``model``).

    Under :func:`batch_shards` the gradient that comes back is this rank's
    partial sum (``Partial`` on the batch dims, and on the ``model`` dim of
    a whole weight where the tokens are sequence-split or where ``partial``
    says each rank uses its own slice of it; ``Replicate`` on dims whose
    ranks compute the same thing; the block's own placement on the
    ``model`` dim with ``keep_model``), and the backward pass
    reduce-scatters it into ``p``'s placement.  ``seq`` overrides the
    active shards' ``seq`` for a consumer whose ranks hold the same tokens
    inside a sequence-split step (the encoder of an encoder-decoder).
    """
    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    model = _MODEL
    target = [Replicate()] * mesh.ndim
    keep = keep_model and model is not None and isinstance(p.placements[model.dim], Shard)
    if keep:
        target[model.dim] = p.placements[model.dim]
    full = p.redistribute(mesh, target)
    shards = _BATCH
    if shards is None or not torch.is_grad_enabled():
        return full.to_local()
    grad_plc = [Partial() if d in shards.dims else Replicate() for d in range(mesh.ndim)]
    if model is not None:
        split_tokens = model.seq if seq is None else seq
        grad_plc[model.dim] = target[model.dim] if keep else (Partial() if partial or split_tokens else Replicate())
    return full.to_local(grad_placements=grad_plc)


def owner_of(module: torch.nn.Module, name: str) -> tuple[torch.nn.Module, str]:
    """(the module that holds parameter ``name``, the parameter's own name),
    walking ``_modules`` (a model's method may shadow a child's name)."""
    *path, leaf = name.split(".")
    for part in path:
        module = module._modules[part]
    return module, leaf


@contextlib.contextmanager
def gathered(module: torch.nn.Module, names: Sequence[str], keep: Sequence[str] = (), partial: Sequence[str] = (),
             seq: Optional[bool] = None) -> Iterator[None]:
    """Within the block, ``module``'s parameters ``names`` (dotted) are their
    gathered plain tensors (:func:`gather`; those also in ``keep`` with
    ``keep_model``, those in ``partial`` with ``partial``, all with
    ``seq``); they are put back after it."""
    saved = []
    keep, partial = set(keep), set(partial)
    try:
        for name in names:
            owner, leaf = owner_of(module, name)
            p = owner._parameters[leaf]
            saved.append((owner, leaf, p))
            owner._parameters[leaf] = gather(p, keep_model=name in keep, partial=name in partial, seq=seq)
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


def _gather_hook(block, args):
    """A block's weights for its forward: ``model_local_names(decode=False)``
    as this rank's ``model`` blocks, ``model_partial_names()`` whole with
    partial gradients, and ``tokens_split`` (where the block sets it) in
    place of the step's sequence split for the others' gradients."""
    keep = block.model_local_names(decode=False) if hasattr(block, "model_local_names") else ()
    partial = block.model_partial_names() if hasattr(block, "model_partial_names") else ()
    ctx = gathered(block, [n for n, p in block.named_parameters() if isinstance(p, DTensor)], keep, partial,
                   getattr(block, "tokens_split", None))
    ctx.__enter__()
    block._gather_ctx = ctx


def _release_hook(block, args, out):
    ctx = block.__dict__.pop("_gather_ctx", None)
    if ctx is not None:
        ctx.__exit__(None, None, None)


def gather_in_blocks(blocks: Sequence[torch.nn.Module]) -> list:
    """Make each block gather its weights when it is called and release them
    when it returns: one block's gathered weights are live at a time, and a
    rematerialized block gathers again in the backward pass.  Returns the
    hook handles."""
    handles = []
    for b in blocks:
        handles.append(b.register_forward_pre_hook(_gather_hook))
        handles.append(b.register_forward_hook(_release_hook, always_call=True))
    return handles


def sharded_sumsq(tensors) -> torch.Tensor:
    """The sum of squares, in f32, over the whole of every tensor: a DTensor
    over its global extent, each block counted once."""
    groups: dict = {}
    for t in tensors:
        if isinstance(t, DTensor):
            local = t.to_local()
            key = (t.device_mesh, tuple(isinstance(p, Shard) for p in t.placements))
        else:
            local, key = t, None
        s = torch.sum(local.to(torch.float32) ** 2)
        groups[key] = s if key not in groups else groups[key] + s
    total = None
    for key, s in groups.items():
        if key is not None:
            mesh, sharded = key
            for d, is_sharded in enumerate(sharded):
                if is_sharded and mesh.size(d) > 1:
                    dist.all_reduce(s, group=mesh.get_group(d))
        total = s if total is None else total + s
    return total
