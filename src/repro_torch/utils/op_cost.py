"""Per-card cost of one eager call, counted from the ops it runs.

The port's counterpart of the JAX package's ``utils/hlo.py`` (collective
wire bytes from compiled HLO text) and ``utils/hlo_cost.py`` (trip-count-
aware FLOPs, bytes and collectives of compiled HLO).  No torch path
produces HLO, so :class:`OpCost` reads the same three quantities from the
aten ops a call dispatches, as a ``TorchDispatchMode``; an eager step runs
every loop iteration, so nothing has to recover a trip count.

  * ``flops``  — ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention): 2 × |result| × |contracted| for a product,
    the HLO dot convention.
  * ``bytes``  — Σ (operand + result bytes) over the ops that run.  Views
    are free: the op that reads a view is charged the bytes the view spans,
    so a slice read and copied costs 2 × the slice (``hlo_cost``'s slice
    rule).  Gathers (``index``, ``gather``, ``index_select``,
    ``embedding``) charge 2 × their result, the rows they touch, not the
    table.  An in-place op charges its operands only, so a cache write
    ``cache.narrow(...).copy_(update)`` costs 2 × the update (``hlo_cost``'s
    dynamic-update-slice rule).  A stride-0 dim (``expand``) counts once.
  * ``collectives`` — a count and wire bytes per kind, by ``hlo.py``'s
    convention: an all-gather charges the gathered result; all-reduce,
    reduce-scatter, all-to-all and broadcast their operand.  Both the
    functional collectives that DTensor issues (``_c10d_functional``) and
    the ``c10d`` ops of ``torch.distributed`` (``BatchShards.all_reduce``)
    are read.
  * ``peak_bytes`` — the most bytes of tensor storage alive at once: the
    storages passed to :meth:`OpCost.track` (parameters, optimizer state,
    cache, batch) and every storage an op creates while the mode is on,
    each released when its last tensor dies.
  * K1 (``repro_torch::speculative``) is charged
    ``launch.roofline.tree_eval_cost``'s bytes and counted in ``k1``.

A DTensor op is left to DTensor (the mode returns ``NotImplemented``), so
the counts are of the local ops one card runs.  DTensor's sharding
propagation runs each op it has not seen before once more on fake tensors
of the global shape (in the active fake mode, else a mode of its own);
those runs are not counted, so the counts do not depend on what DTensor
has cached.  The counts are the same on fake tensors (a dry-run) as on
the card's tensors, which is what ``chip_smoke.py [dryrun]`` shows.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.roofline import tree_eval_cost

aten = torch.ops.aten

# allocations that touch no memory, and ops that only wait or alias
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
    aten.lift_fresh.default, aten._local_scalar_dense.default,
}
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default, aten.embedding.default}

# collective → (kind, whether the result (not the operand) crosses the wire)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", True),
    "all_gather_into_tensor_coalesced": ("all-gather", True),
    "all_gather_into_tensor_out": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", False),
    "all_reduce": ("all-reduce", False),
    "all_reduce_": ("all-reduce", False),
    "all_reduce_coalesced": ("all-reduce", False),
    "all_reduce_coalesced_": ("all-reduce", False),
    "all_to_all_single": ("all-to-all", False),
    "broadcast": ("broadcast", False),
    "broadcast_": ("broadcast", False),
    # torch.distributed's c10d ops (in-place, on lists of tensors)
    "allreduce_": ("all-reduce", False),
    "allreduce_coalesced_": ("all-reduce", False),
    "_allgather_base_": ("all-gather", True),
    "allgather_": ("all-gather", True),
    "allgather_into_tensor_coalesced_": ("all-gather", True),
    "_reduce_scatter_base_": ("reduce-scatter", False),
    "reduce_scatter_": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", False),
    "alltoall_base_": ("all-to-all", False),
    "alltoall_": ("all-to-all", False),
}
# the c10d ops whose first argument is the output (the rest the input)
_OUTPUT_FIRST = {"_allgather_base_", "allgather_", "allgather_into_tensor_coalesced_",
                 "_reduce_scatter_base_", "reduce_scatter_", "reduce_scatter_tensor_coalesced_",
                 "alltoall_base_", "alltoall_"}
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "c10d_functional", "c10d"}
K1_OP = "repro_torch::speculative"


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: its elements, a stride-0 (expanded) dim once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


_PROPAGATING = threading.local()     # depth of DTensor's shape propagation on this thread


def _propagation_hook():
    """(DTensor's sharding propagator class, the name of the method that
    runs an op on fake tensors to learn its output's shape): the one
    private DTensor name this module patches, the same in torch 2.11 and
    2.13 (``ShardingPropagator._propagate_tensor_meta_non_cached``)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    return ShardingPropagator, "_propagate_tensor_meta_non_cached"


def _uncounted(fn):
    def run(*args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1
    return run


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class OpCost(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and peak live bytes of what runs
    while it is on (module docstring).  Use as a context manager::

        with OpCost() as cost:
            cost.track(model.parameters(), opt_state, batch)
            step(model, opt_state, batch)
        cost.flops, cost.bytes, cost.coll_count, cost.coll_bytes, cost.peak_bytes
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.k1 = 0
        self.coll_count: dict = defaultdict(int)
        self.coll_bytes: dict = defaultdict(float)
        self.bytes_by_op: dict = defaultdict(float)      # op name → bytes it moved
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}

    def __enter__(self):
        cls, name = _propagation_hook()
        self._propagator = getattr(cls, name)
        setattr(cls, name, _uncounted(self._propagator))
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name = _propagation_hook()
        setattr(cls, name, self._propagator)
        return super().__exit__(*exc)

    # ------------------------------ memory ------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def release(_ref, key=key, n=n, self_ref=weakref.ref(self)):
            me = self_ref()
            if me is not None and me._live.pop(key, None) is not None:
                me.live_bytes -= n

        self._live[key] = weakref.ref(st, release)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (nested dicts, lists,
        tuples, named tuples, modules' parameter iterators) as live from now."""
        for tree in trees:
            if isinstance(tree, torch.nn.Module):
                tree = list(tree.parameters())
            elif not isinstance(tree, (torch.Tensor, dict, list, tuple)):
                tree = list(tree)
            for t in _tensors(tree):
                self._hold(t)

    # ------------------------------ charges ------------------------------

    @property
    def coll_total_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def coll_summary(self) -> str:
        parts = [f"{k}: {self.coll_count[k]} ops, {self.coll_bytes[k] / 2**20:.1f} MiB"
                 for k in sorted(self.coll_count)]
        return "; ".join(parts) if parts else "none"

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "peak_bytes": self.peak_bytes,
                "ops": self.ops, "k1": self.k1, "coll_bytes": self.coll_total_bytes,
                "collectives": {k: {"count": self.coll_count[k], "bytes": self.coll_bytes[k]}
                                for k in sorted(self.coll_count)}}

    def _charge(self, func, args, kwargs, out, ins, outs) -> float:
        """Counts ``func``'s FLOPs and collectives; returns the bytes it moves
        (``ins``, ``outs``: its tensor arguments and results)."""
        name = func._schema.name.split("::", 1)[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return 0.0
            kind, by_result = kind
            if name in _OUTPUT_FIRST:
                result, operand = _tensors(args[0]), _tensors(args[1:])
            else:
                result, operand = outs, _tensors(args[0])
            self.coll_count[kind] += 1
            self.coll_bytes[kind] += sum(tensor_bytes(t) for t in (result if by_result else operand))
            return float(sum(tensor_bytes(t) for t in ins + (outs if not func._schema.is_mutable else [])))
        if str(func._schema.name) == K1_OP:
            records, threshold = args[0], args[3]
            m, a = records.shape
            self.k1 += 1
            return tree_eval_cost(m, a, 1, threshold.shape[-1], 0)["bytes"]
        if func in _FREE or func.is_view:
            return 0.0
        packet = func.overloadpacket
        if packet in flop_counter.flop_registry:
            self.flops += float(flop_counter.flop_registry[packet](*args, **kwargs, out_val=out))
        if func in _GATHERS:
            return 2.0 * sum(tensor_bytes(t) for t in outs)
        if func._schema.is_mutable:
            return float(sum(tensor_bytes(t) for t in ins))
        return float(sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs its local ops, counted one by one
        out = func(*args, **kwargs)
        if func.namespace == "prim" or getattr(_PROPAGATING, "depth", 0):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops += 1
        moved = self._charge(func, args, kwargs, out, ins, outs)
        self.bytes += moved
        self.bytes_by_op[str(func.overloadpacket)] += moved
        if not func._schema.is_mutable:
            # a view or alias of an input shares its storage: nothing new is live
            inputs = {id(_local(t).untyped_storage()) for t in ins}
            for t in outs:
                if id(_local(t).untyped_storage()) not in inputs:
                    self._hold(t)
        return out


__all__ = ["OpCost", "tensor_bytes", "K1_OP"]
