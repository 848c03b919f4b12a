"""How far the port's and the JAX package's f32 gradients of a smoke model
lie from an f64 evaluation of the same function.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_f64_probe.py [arch]

The f64 evaluation is the port itself, copied to a temporary directory with
every ``torch.float32`` and ``.float()`` made f64 (the configs' "float32"
then names f64 too), the JAX weights carried across exactly.  For each
parameter it prints the three distances in the measure of
``tests/test_torch_lm_families_models.py`` (``|a − b| / (|b| + max |b|)``),
the largest port–JAX distance first.  ``test_loss_and_gradients_equal_jax``
sets the xLSTM's bound from these numbers.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def f64_copy(dst: str) -> str:
    """A copy of ``src/repro_torch`` under ``dst`` computing in f64."""
    src = os.path.join(HERE, "..", "src", "repro_torch")
    pkg = os.path.join(dst, "repro_torch")
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                text = open(path).read()
                text = re.sub(r"torch\.float32", "torch.float64", text).replace(".float()", ".double()")
                open(path, "w").write(text)
    return dst


def distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / (np.abs(b) + np.abs(b).max() + 1e-30)))


def main(arch: str = "xlstm") -> None:
    import jax
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, HERE)
    import test_torch_lm_families_models as T
    from repro.configs import registry as jreg
    from repro.configs.base import ShapeConfig as JShape
    from repro.data import pipeline as jpipeline

    jmodel, jparams = T._jax(arch)
    batch = jpipeline.pipeline_for(jreg.get_smoke_config(arch), JShape("s", 16, 2, "train"), seed=0)(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    model = T._port(arch)
    named = dict(model.named_parameters())
    loss, _ = model.loss(T.device_batch(batch, "cpu"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                                 materialize_grads=True)))
    jax_grads = {n: np.asarray(T._jax_leaf(jg, model, n), np.float64) for n in named}

    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, f64_copy(tmp))
        for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
            del sys.modules[k]
        from repro_torch.configs import registry
        from repro_torch.models import build_model
        from repro_torch.models.convert import load_jax_params
        from repro_torch.train import device_batch

        m64 = build_model(registry.get_smoke_config(arch), device="cpu")
        load_jax_params(m64, jax.tree.map(
            lambda a: np.asarray(a).astype(np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a),
            jparams))
        n64 = dict(m64.named_parameters())
        l64, _ = m64.loss(device_batch(batch, "cpu"))
        g64 = dict(zip(n64, torch.autograd.grad(l64, list(n64.values()), allow_unused=True,
                                                 materialize_grads=True)))
    print(f"{arch}: loss port {float(loss.detach()):.9f}  JAX {float(jl):.9f}  f64 {float(l64.detach()):.9f}")
    rows = []
    for n in named:
        ref = g64[n].detach().numpy()
        port = grads[n].detach().double().numpy()
        rows.append((distance(port, jax_grads[n]), n, distance(port, ref), distance(jax_grads[n], ref)))
    print(f"{'parameter':42s} {'port-JAX':>10s} {'port-f64':>10s} {'JAX-f64':>10s}")
    for pj, n, pf, jf in sorted(rows, reverse=True):
        print(f"{n:42s} {pj:10.3e} {pf:10.3e} {jf:10.3e}")
    print(f"max over parameters: port-JAX {max(r[0] for r in rows):.3e}  port-f64 {max(r[2] for r in rows):.3e}  "
          f"JAX-f64 {max(r[3] for r in rows):.3e}")


if __name__ == "__main__":
    main(*sys.argv[1:])
