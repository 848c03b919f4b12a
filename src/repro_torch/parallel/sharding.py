"""Device grids and the divisibility policy of the sharded forest path.

The port's counterpart of the forest part of the JAX package's
``parallel/sharding.py``.  There a plan lowers onto a ``jax.sharding.Mesh``
and ``shard_map``; here one process drives the node's cards directly, so a
mesh is a (records × trees) grid of ``torch.device`` objects that the
executor walks shard by shard (:class:`repro_torch.dist.ShardedForestEvaluator`).

A grid may name one device several times: ``("cpu",) * 8`` on the host, or
``("cuda:0",) * 4`` on one card, lays out four logical shards that run one
after another on the same device.  That is the port's counterpart of
``--xla_force_host_platform_device_count``: it exercises the sharding,
padding and gathering, and measures nothing about several cards.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

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
