"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

The same numpy inputs, made from fixed seeds, go to the JAX package and to
its port; the port must agree with ``np.array_equal`` (no tolerance).  The
fixture trees and adversarial records are those of ``test_conformance.py``:
deep, shallow, skewed, single-leaf and duplicate-threshold trees, and rows
of exact ties, ±inf and NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from repro.core import Node, breadth_first_encode, random_tree
from repro.core.forest import EncodedForest as JaxForest
from repro_torch.core import EncodedForest, EncodedTree

N_ATTRS = 7
N_CLASSES = 5
M = 96


def _duplicate_threshold_tree() -> Node:
    def leaf(c):
        return Node(class_val=c)

    def split(attr, left, right):
        return Node(attr=attr, threshold=0.5, left=left, right=right)

    return split(
        0,
        split(1, split(2, leaf(0), leaf(1)), split(3, leaf(2), leaf(3))),
        split(2, split(4, leaf(4), leaf(0)), split(1, leaf(1), leaf(2))),
    )


def _fixture_trees() -> dict[str, Node]:
    return {
        "deep": random_tree(
            n_attrs=N_ATTRS, n_classes=N_CLASSES, max_depth=8, min_depth=6, seed=7
        ),
        "shallow": random_tree(
            n_attrs=N_ATTRS, n_classes=N_CLASSES, max_depth=1, min_depth=1, seed=8
        ),
        "skewed": random_tree(
            n_attrs=N_ATTRS, n_classes=N_CLASSES, max_depth=9, min_depth=2,
            seed=9, balance=0.15,
        ),
        "single_leaf": Node(class_val=3),
        "duplicate_threshold": _duplicate_threshold_tree(),
    }


# JAX-package encodings (numpy NamedTuples) and their port counterparts.
TREES = {name: breadth_first_encode(root) for name, root in _fixture_trees().items()}
PORT_TREES = {name: EncodedTree.from_arrays(*enc) for name, enc in TREES.items()}
FOREST = JaxForest(list(TREES.values()))
PORT_FOREST = EncodedForest.from_arrays(
    FOREST.attr_idx, FOREST.threshold, FOREST.child, FOREST.class_val
)


def adversarial_records(m: int = M, n_attrs: int = N_ATTRS, seed: int = 2026) -> np.ndarray:
    """(m, n_attrs) float32 records with adversarial rows up front."""
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(max(m, 8), n_attrs)).astype(np.float32)
    rec[0, :] = 0.5
    rec[1, :] = 0.0
    rec[2, :] = np.inf
    rec[3, :] = -np.inf
    rec[4, ::2] = np.inf
    rec[4, 1::2] = -np.inf
    rec[5, :] = np.nan
    rec[6, ::3] = np.nan
    rec[7, 0] = np.nan
    rec[7, 1] = np.inf
    rec[7, 2] = -np.inf
    rec[7, 3] = 0.5
    return rec[:m]


RECORDS = adversarial_records()


def cpu(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same(got, want, label: str = "") -> None:
    """Exact equality of a port result (tensor or numpy) and a JAX result."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}"
    if not np.array_equal(got, want, equal_nan=got.dtype.kind == "f"):
        bad = np.argwhere(got != want)
        raise AssertionError(f"{label}: {bad.shape[0]} mismatches, first at {bad[0].tolist()}")
