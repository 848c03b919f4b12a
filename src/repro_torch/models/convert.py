"""Carry a JAX parameter tree into a port model.

The two packages draw different bits from one seed, so parity tests (and
anyone moving trained weights) carry the JAX package's parameters across:

    tree = jax.tree.map(np.asarray, params)     # on the JAX side
    load_jax_params(model, tree)                # on the port's

``tree`` is the JAX model's nested dict of numpy arrays with the scanned
layers stacked (L, …); each stacked leaf is split along axis 0 into the
model's ``ModuleList``.  Every leaf's path and shape is checked against the
model's schema, and the routers are packed again from the new thresholds.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import schema as sch


def _leaf(tree: dict, path: str):
    node = tree
    for key in path.split("."):
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _paths(tree: dict, prefix: str = "") -> set[str]:
    out = set()
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        out |= _paths(sub, path + ".") if isinstance(sub, dict) else {path}
    return out


@torch.no_grad()
def load_jax_params(model, tree: dict):
    """Copy ``tree`` (the JAX parameters as numpy) into ``model`` in place.

    Raises ``ValueError`` on a missing or unexpected leaf or a shape that
    differs from the schema's.  Returns ``model``.
    """
    schema = dict(sch.leaves(model.schema()))
    missing = sorted(set(schema) - _paths(tree))
    extra = sorted(_paths(tree) - set(schema))
    if missing or extra:
        raise ValueError(f"JAX tree does not match the model: missing {missing}, unexpected {extra}")
    for path, spec in schema.items():
        arr = np.asarray(_leaf(tree, path))
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: JAX leaf has shape {arr.shape}, the model {spec.shape}")
        src = torch.tensor(arr, dtype=torch.float32)
        params = model.layer_params(path)
        if path.startswith("layers."):
            for i, p in enumerate(params):
                p.copy_(src[i])
        else:
            params[0].copy_(src)
    model.pack_routers()
    return model
