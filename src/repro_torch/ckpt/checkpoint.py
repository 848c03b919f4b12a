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
place, on the target's devices, and packs a model's routers again.  The
re-sharding onto another mesh (JAX's ``shardings=``) waits for the
multi-card LM work.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.optim.adamw import AdamWState


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
    """A copy of ``leaf`` on the host: never a view of a tensor a later step writes."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final directory path."""
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
        # copied to the host on the caller's thread: the next step updates
        # the tensors in place
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


@torch.no_grad()
def restore(ckpt_dir: str, step: int, target_tree: Any):
    """Load a checkpoint into ``target_tree`` in place; returns (target_tree, manifest).

    Every leaf of the target is a tensor (a module's parameters, an
    ``AdamWState``'s moments and count) and is written where it lies.
    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape that differs.  A model among the targets has its routers
    packed again from the restored thresholds.
    """
    final = _step_dir(ckpt_dir, step)
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    for p, leaf in _flatten(target_tree):
        e = by_path.get(p)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(final, e["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {p!r} shape {arr.shape} != expected {tuple(leaf.shape)}")
        leaf.copy_(torch.from_numpy(arr))
    stack = [target_tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack += node.values()
        elif hasattr(node, "pack_routers"):
            node.pack_routers()
    return target_tree, manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
