"""Procedures 4 & 5: speculative parallel tree evaluation in PyTorch.

The paper's core contribution.  For each record, *every node of the tree* is
evaluated speculatively in one branch-free step, producing a successor array
``path`` (leaves self-loop).  The root's eventual successor — the record's
terminal leaf — is then found by **pointer jumping**
(``path[i] = path[path[i]]``), needing only ``Θ(log₂ d)`` rounds instead of a
``d``-step descent.

These are the plain tensor formulations; the hand-written CUDA kernels of
``repro_torch.kernels.tree_eval`` compute the same functions tile by tile.
Tables may carry a leading tree axis, ``(T, N)``: the forest is then
evaluated as a batch in place of the JAX package's ``vmap``.

Procedure-5 improvements: several pointer jumps per synchronisation round
(``jumps_per_round``); leaves self-loop by construction of the encoding, so
the static ``leafPaths`` initialisation is implicit.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.tree import BOTTOM, EncodedTree

_F32_MAX = float(np.finfo(np.float32).max)


def sanitize_records(records: torch.Tensor) -> torch.Tensor:
    """Make a record batch safe for one-hot-matmul node evaluation.

    The one-hot formulation ``vals = records @ S`` multiplies every attribute
    by 0 or 1 and sums, so a single non-finite attribute poisons the whole
    row (IEEE ``inf * 0 = NaN``).  Clamping preserves routing against every
    finite threshold: NaN and -FLT_MAX both fail ``v > t`` for all reachable
    thresholds, ±inf route exactly like ±FLT_MAX, and the leaf self-loop's
    +inf threshold still rejects everything.  Gather-based evaluators don't
    need this — they read only the addressed attribute.
    """
    records = records.to(torch.float32)
    return torch.where(
        torch.isnan(records), -_F32_MAX, records.clamp(-_F32_MAX, _F32_MAX)
    )


@contextlib.contextmanager
def exact_f32_matmul():
    """Hold float32 matrix products at full precision (no TF32) on the card.

    The one-hot node evaluation is exact only if every product keeps the
    record's 24-bit mantissa; TF32 keeps 10 bits and would reroute records.
    Not thread-safe: it sets the process-wide ``allow_tf32`` flag for the
    duration, so a matmul on another thread meanwhile also runs without TF32,
    and two overlapping uses on different threads may restore it out of order.
    """
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def speculative_node_eval(
    records: torch.Tensor,
    attr_idx: torch.Tensor,
    threshold: torch.Tensor,
    child: torch.Tensor,
    *,
    use_onehot_matmul: bool = False,
    attr_select: torch.Tensor | None = None,
) -> torch.Tensor:
    """Evaluate every node against every record (the speculative step).

    Returns ``path`` (M, N) int32 — or (T, M, N) for (T, N) tables: the
    successor of node ``n`` for record ``m``, ``child[n] + (r[attr[n]] >
    threshold[n])``.  Leaves self-loop by construction (+inf thresholds).

    ``use_onehot_matmul`` selects ``vals = records @ S`` with
    ``S[a, n] = 1 ⇔ attr[n] == a`` (sanitizing the records first, and with
    TF32 off); otherwise the attribute is gathered.
    """
    if use_onehot_matmul:
        records = sanitize_records(records)
        if attr_select is None:
            n_attrs = records.shape[-1]
            onehot = torch.nn.functional.one_hot(attr_idx.long(), n_attrs)
            attr_select = onehot.to(records.dtype).transpose(-1, -2)
        with exact_f32_matmul():
            vals = records @ attr_select                      # (..., M, N)
    else:
        vals = records[:, attr_idx.long()].movedim(0, -2)     # (..., M, N) gather
    return (child.unsqueeze(-2) + (vals > threshold.unsqueeze(-2))).to(torch.int32)


def pointer_jump(path: torch.Tensor, rounds: int, jumps_per_round: int = 1) -> torch.Tensor:
    """Parallel path reduction: ``path[i] ← path[path[i]]`` (Procedure 4 l.15).

    ``jumps_per_round`` > 1 is Procedure 5's multi-reduction optimisation
    (line 20, ``path[path[path[i]]]``): fewer synchronisation rounds when the
    average traversal depth d_µ exceeds the per-round doubling.
    """
    p = path.long()
    for _ in range(rounds * jumps_per_round):
        p = p.gather(-1, p)
    return p.to(path.dtype)


def rounds_for_depth(max_depth: int, jumps_per_round: int = 1) -> int:
    """Pointer-jump rounds guaranteeing root→leaf convergence.

    After ``j`` jump applications every pointer skips ``2^j`` original steps;
    with ``k`` jumps per round the total is ``rounds·k``, so we need
    ``2^(rounds·k) ≥ max_depth``.
    """
    if max_depth <= 1:
        return 1
    total_jumps = max(1, math.ceil(math.log2(max_depth)))
    return math.ceil(total_jumps / jumps_per_round)


def eval_speculative(
    records,
    attr_idx,
    threshold,
    child,
    class_val,
    *,
    max_depth: int,
    jumps_per_round: int = 2,
    use_onehot_matmul: bool = False,
    early_exit: bool = False,
    device=None,
) -> torch.Tensor:
    """Procedure 4/5: speculative node evaluation + pointer-jump reduction.

    Args:
      records: (M, A) float array or tensor.
      attr_idx/threshold/child/class_val: encoded tree fields, (N,) or (T, N).
      max_depth: tree-depth bound.
      jumps_per_round: Procedure-5 multi-jump factor (paper found 2 optimal).
      use_onehot_matmul: one-hot matmul node evaluation.
      early_exit: loop while any record's ``class[path[:, 0]]`` is ⊥
        (Procedure 4 line 14) instead of the static round bound; each round
        reads one flag back to the host.
      device: where to run; default: where ``records`` lies, else CUDA.

    Returns:
      (M,) or (T, M) int32 class assignments.
    """
    dev = _device.resolve(records, device)
    records = _device.as_tensor(records, torch.float32, dev)
    attr_idx = _device.as_tensor(attr_idx, torch.int64, dev)
    threshold = _device.as_tensor(threshold, torch.float32, dev)
    child = _device.as_tensor(child, torch.int32, dev)
    class_val = _device.as_tensor(class_val, torch.int32, dev)
    path = speculative_node_eval(
        records, attr_idx, threshold, child, use_onehot_matmul=use_onehot_matmul
    ).long()

    if early_exit:
        while bool((class_val.gather(-1, path[..., 0]) == BOTTOM).any()):
            path = pointer_jump(path, 1, jumps_per_round)
    else:
        path = pointer_jump(path, rounds_for_depth(max_depth, jumps_per_round), jumps_per_round)
    return class_val.gather(-1, path[..., 0])


def eval_speculative_tree(
    enc: EncodedTree,
    records,
    *,
    max_depth: int,
    jumps_per_round: int = 2,
    use_onehot_matmul: bool = False,
    early_exit: bool = False,
    device=None,
) -> torch.Tensor:
    """Convenience wrapper taking an :class:`EncodedTree`."""
    return eval_speculative(
        records,
        *enc,
        max_depth=max_depth,
        jumps_per_round=jumps_per_round,
        use_onehot_matmul=use_onehot_matmul,
        early_exit=early_exit,
        device=device,
    )


def shard_eval_speculative(
    enc: EncodedTree,
    records,
    *,
    max_depth: int,
    mesh,
    jumps_per_round: int = 2,
) -> torch.Tensor:
    """Record groups sharded over a 1-D device grid; tree replicated.

    Each device holds 1/D of the record groups — the paper's grid of record
    groups mapped onto the devices; ``path`` never leaves a device, so the
    only traffic is the record scatter / class gather, i.e. the paper's
    t_s(M) term.  Each shard runs K1 in its one-hot form (the JAX package's
    shard body runs the one-hot matmul formulation) on its device; on CPU
    tensors the kernel's plain version.

    Args:
      enc: the encoded tree, replicated on every device.
      records: (M, A) float array or tensor.
      max_depth: tree-depth bound.
      mesh: the devices, a sequence (``("cuda:0", "cuda:1")``, or one
        device repeated) or a :class:`repro_torch.parallel.sharding.DeviceGrid`.
      jumps_per_round: kept for the plain formulation's signature; K1 jumps
        ``⌈log₂ max_depth⌉`` times whatever it is.

    Returns:
      (M,) int32 class assignments on the grid's first device.
    """
    from repro_torch.kernels.tree_eval.ops import PackedTree, tree_eval
    from repro_torch.parallel.sharding import map_record_shards

    del jumps_per_round
    devices = list(mesh.devices.flat) if hasattr(mesh, "devices") else list(mesh)
    n_attrs = int(np.shape(records)[-1])
    packed: dict = {}

    def run(rows, dev):
        if dev not in packed:
            packed[dev] = PackedTree(enc, n_attrs, max_depth=max_depth, device=dev)
        return tree_eval(rows, packed[dev], algorithm="speculative", jump_mode="onehot")

    return map_record_shards(records, devices, run)
