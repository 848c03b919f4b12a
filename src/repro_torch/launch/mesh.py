"""Meshes of cards: 16×16 single pod, 2×16×16 multi-pod, small test meshes.

The port's counterpart of the JAX package's ``launch/mesh.py``.  A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (one process per card, or per host CPU under gloo),
with the JAX axis names.  Each builder is a function, so importing this
module creates no process group: the caller starts one first (``torchrun``
and ``init_process_group``, or spawned processes with a ``FileStore``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def mesh_device_type() -> str:
    """``"cuda"`` under NCCL, ``"cpu"`` under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str | None = None):
    """A mesh of ``shape`` with axis ``names`` over every rank, in rank order
    (the last axis the minor, as ``jax.make_mesh`` lays devices out)."""
    return init_device_mesh(device_type or mesh_device_type(), tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, n_pod: int = 0, device_type: str | None = None):
    """A small mesh for multi-process tests (world size = its product)."""
    if n_pod:
        return make_mesh((n_pod, n_data, n_model), ("pod", "data", "model"), device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def single_device_mesh(device_type: str | None = None):
    return make_mesh((1, 1), ("data", "model"), device_type)


__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh", "mesh_device_type", "single_device_mesh"]
