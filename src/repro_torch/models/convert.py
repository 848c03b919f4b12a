"""Carry a JAX parameter tree into a port model.

The two packages draw different bits from one seed, so parity tests (and
anyone moving trained weights) carry the JAX package's parameters across:

    tree = jax.tree.map(np.asarray, params)     # on the JAX side
    load_jax_params(model, tree)                # on the port's

``tree`` is the JAX model's nested dict of numpy arrays.  A stacked leaf
(the decoder's ``layers``, the encoder-decoder's ``enc_layers`` and
``dec_layers``: a leading (L, …) axis) is split along axis 0 into the
model's ``ModuleList`` of that name; every other leaf (``pos_embed``, the
xLSTM's per-layer ``layers.layer_003.…``) is the parameter of its own path.
Every leaf's path and shape is checked against the model's schema, and the
routers are packed again from the new thresholds.

:func:`load_jax_opt_state` carries a JAX ``AdamWState`` across the same
way, so both packages can start training from one optimizer state.
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


def _check_tree(model, tree: dict) -> dict:
    """The schema's leaves by path, after checking ``tree`` has exactly them."""
    schema = dict(sch.leaves(model.schema()))
    missing = sorted(set(schema) - _paths(tree))
    extra = sorted(_paths(tree) - set(schema))
    if missing or extra:
        raise ValueError(f"JAX tree does not match the model: missing {missing}, unexpected {extra}")
    return schema


def _split(model, tree: dict, path: str, spec) -> list[tuple[str, torch.Tensor]]:
    """(parameter name, f32 CPU tensor) of one JAX leaf, split by layer when stacked."""
    arr = np.asarray(_leaf(tree, path))
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"{path}: JAX leaf has shape {arr.shape}, the model {spec.shape}")
    src = torch.tensor(arr, dtype=torch.float32)
    names = model.stacked_names(path)
    if names is None:
        return [(path, src)]
    return [(name, src[i]) for i, name in enumerate(names)]


@torch.no_grad()
def load_jax_params(model, tree: dict):
    """Copy ``tree`` (the JAX parameters as numpy) into ``model`` in place.

    Raises ``ValueError`` on a missing or unexpected leaf or a shape that
    differs from the schema's.  Returns ``model``.
    """
    named = dict(model.named_parameters())
    for path, spec in _check_tree(model, tree).items():
        for name, src in _split(model, tree, path, spec):
            named[name].copy_(src)
    model.pack_routers()
    return model


def load_jax_opt_state(model, state):
    """The port's ``AdamWState`` for ``model`` from a JAX ``AdamWState``
    (``m``, ``v``: parameter trees as numpy, ``count``), on the model's
    device; stacked moments are split by layer as :func:`load_jax_params`
    splits the weights.  Raises ``ValueError`` as that function does."""
    from repro_torch.optim.adamw import AdamWState

    m_tree, v_tree, count = state
    dev = model.device
    moments = []
    for tree in (m_tree, v_tree):
        schema = _check_tree(model, tree)
        moments.append({name: src.to(dev) for path, spec in schema.items()
                        for name, src in _split(model, tree, path, spec)})
    order = [name for name, _ in model.named_parameters()]
    m, v = ({name: mom[name] for name in order} for mom in moments)
    return AdamWState(m=m, v=v, count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev))
