"""Fault-tolerant checkpointing: atomic step directories, async save,
manifest-driven restore.

The port's counterpart of the JAX package's ``ckpt/checkpoint.py``, with
its on-disk layout (one directory per step, atomically renamed into place):

    <ckpt_dir>/
      step_000120/
        manifest.json       # leaf paths, shapes, dtypes, step metadata
        leaf_00000.npy ...  # one file per leaf
      LATEST                # text file: "step_000120"

Writes go to ``step_XXXXXX.tmp`` and are renamed only after every leaf and
the manifest are written; ``LATEST`` is replaced through ``LATEST.tmp``.

A state tree is a nested dict whose leaves are tensors or arrays, where a
module stands for its ``state_dict`` and an ``AdamWState`` for its ``m``,
``v`` and ``count``: the leaf paths of ``{"params": model, "opt": state}``
are ``params/<state_dict key>``, ``opt/m/<name>``, ``opt/v/<name>`` and
``opt/count``.  :func:`restore` writes a checkpoint into such a target in
place, on the target's devices, and packs a model's routers again.

**Across cards.**  A leaf may be a DTensor (a sharded model's parameters,
its ZeRO-1 moments).  :func:`save` gathers each one whole on the calling
thread, every rank taking part, and only rank 0 copies it to the host and
writes: the other ranks drop each gathered leaf at once.  The
:class:`AsyncSaver` gathers before it hands rank 0's host copies to its
thread, which never runs a collective.  :func:`agreed_latest_step` is rank
0's :func:`latest_step`, broadcast, so that every rank restores the same
step.  :func:`restore` places what it reads: a
DTensor target keeps its placement, each rank copying its own block, and
``shardings=`` (a tree of ``(mesh, spec)`` beside the target's leaves)
returns the leaves as new DTensors on that mesh, which is how an elastic
restart re-shards the state onto another mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import sharding as shd


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:06d}")


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf of a state tree, in a fixed order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    elif isinstance(tree, AdamWState):
        tree = {"m": tree.m, "v": tree.v, "count": tree.count}
    if isinstance(tree, dict):
        out = []
        for k, sub in tree.items():
            out += _flatten(sub, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host: never a view of a tensor a later step
    writes.  A DTensor is gathered whole (a collective: every rank calls)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _join_gathers(tree: Any) -> None:
    """A rank that does not write takes part in the writer's gathers, leaf by
    leaf, and keeps nothing: no host copy, one gathered leaf live at a time."""
    for _, leaf in _flatten(tree):
        if isinstance(leaf, DTensor):
            leaf.detach().full_tensor()      # synchronous; dropped at once


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final directory path.

    Every rank calls it on a sharded tree (the leaves are gathered here);
    rank 0 writes, and the others return without touching the directory."""
    if not _writer():
        _join_gathers(tree)
        return _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (p, leaf) in enumerate(_flatten(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    return final


class AsyncSaver:
    """Overlap checkpoint writes with training (single in-flight save)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def submit(self, ckpt_dir: str, step: int, tree: Any, *, extra=None):
        self.wait()
        # gathered on the caller's thread, and copied to the host on rank 0's:
        # the next step updates the tensors in place, and the thread runs no
        # collective
        if not _writer():
            _join_gathers(tree)
            self.last_path = _step_dir(ckpt_dir, step)
            return
        host_tree = {p: _host(leaf) for p, leaf in _flatten(tree)}

        def run():
            try:
                self.last_path = save(ckpt_dir, step, host_tree, extra=extra)
            except BaseException as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def agreed_latest_step(ckpt_dir: str) -> Optional[int]:
    """:func:`latest_step` as every rank must see it on a restart: rank 0's,
    broadcast (a collective: every rank calls, rank 0 once its
    :class:`AsyncSaver` has finished writing).  Without a process group,
    the local one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return latest_step(ckpt_dir)
    box = [latest_step(ckpt_dir) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def restore(ckpt_dir: str, step: int, target_tree: Any, *, shardings: Any = None):
    """Load a checkpoint into ``target_tree``; returns (tree, manifest).

    Without ``shardings`` every leaf of the target is a tensor (a module's
    parameters, an ``AdamWState``'s moments and count) and is written in
    place, where it lies: a DTensor leaf gets each rank's own block of the
    array.  A model among the targets has its routers packed again from the
    restored thresholds.

    ``shardings`` is a tree beside the target's leaves (nested dicts, a
    module's keyed by its ``state_dict`` names) of ``(mesh, spec)`` pairs:
    the target then gives only the paths and shapes, and the result is a
    new nested dict of the leaves as DTensors placed on their mesh, every
    rank keeping its block of what it reads (JAX's ``device_put`` with the
    target mesh's shardings).

    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape that differs.
    """
    final = _step_dir(ckpt_dir, step)
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    placed = dict(_flatten(shardings)) if shardings is not None else None
    out: dict = {}
    for p, leaf in _flatten(target_tree):
        e = by_path.get(p)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(final, e["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {p!r} shape {arr.shape} != expected {tuple(leaf.shape)}")
        full = torch.from_numpy(arr)
        if placed is not None:
            mesh, spec = placed[p]
            out[p] = shd.place(full, mesh, spec)
        elif isinstance(leaf, DTensor):
            leaf.to_local().copy_(shd.local_shard(full, leaf.device_mesh, leaf.placements))
        else:
            leaf.copy_(full)
    if placed is not None:
        return _unflatten(out), manifest
    stack = [target_tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack += node.values()
        elif hasattr(node, "pack_routers"):
            node.pack_routers()
    return target_tree, manifest


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return out


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
