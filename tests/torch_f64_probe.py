"""How far the port's and the JAX package's f32 gradients of a smoke model
lie from an f64 evaluation of the same function.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_f64_probe.py [arch]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_f64_probe.py axis [arch]

The second form measures the cases of ``tests/test_torch_model_axis.py``
(the arch's smoke model on 1×4 and 2×2, and for the xLSTM the "dh"
layout): JAX's single-device program, the port's, the port's split over
'model' on four spawned gloo ranks, and the f64 evaluation, on the same
weights and inputs; gradients in that test's measure (``max |a − b| /
max |b|``), prefill and decode logits as the largest absolute difference.
That test sets the xLSTM's bounds from these numbers.

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
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def f64_copy(dst: str) -> str:
    """A copy of ``src/repro_torch`` under ``dst`` computing in f64: the
    copy ``chip_smoke.py``'s f64 gradient gate makes (``chip_smoke.f64_copy``)."""
    sys.path.insert(0, os.path.join(HERE, ".."))
    from chip_smoke import f64_copy as copy

    return copy(dst)


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


def _f64_port():
    """The port's modules re-imported from an f64 copy (``f64_copy``); the
    temporary directory is removed at exit."""
    import atexit

    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    sys.path.insert(0, f64_copy(tmp))
    for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[k]


def _split_rank(rank: int, world: int, tmp: str, arch: str, mesh, heads) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import torch_dist_worker as W

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        res = W.axis_case(arch, mesh, torch.device("cpu"), tmp, heads=heads, tag="probe")
        torch.save(res, os.path.join(tmp, f"probe{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def axis(arch: str = "xlstm") -> None:
    import multiprocessing as mp

    import jax
    import torch

    sys.path.insert(0, HERE)
    import test_torch_model_axis as T
    import torch_dist_worker as W
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_jax_params
    from repro_torch.parallel import sharding as shd

    cases = [(mesh, None) for mesh in W.AXIS_MESHES]
    if arch == W.DH_ARCH:
        cases.append((W.DH_MESH, W.DH_HEADS))
    runs = []
    for mesh, heads in cases:
        jm = T._jax_model(arch, mesh, heads=heads)
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
        ref = T._references(arch, mesh, params, heads=heads)
        tmp = tempfile.mkdtemp()
        port = build_model(W.axis_cfg(arch, heads=heads), device="cpu",
                           axes=shd.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]}))
        load_jax_params(port, params)
        torch.save(port.state_dict(), W.axis_weights_path(tmp, arch, mesh, "probe"))
        procs = [mp.get_context("spawn").Process(target=_split_rank, args=(r, 4, tmp, arch, mesh, heads))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        if [p.exitcode for p in procs] != [0] * 4:
            raise RuntimeError(f"the split ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"probe{r}.pt"), weights_only=False) for r in range(4)]
        shutil.rmtree(tmp, True)
        runs.append((mesh, heads, params, ref, ranks))

    _f64_port()
    import torch_dist_worker as W64         # noqa: F811 (its imports now resolve to the f64 copy)
    from repro_torch.models import build_model as build64
    from repro_torch.models.convert import load_jax_params as load64
    from repro_torch.parallel import sharding as shd64
    from repro_torch.train.step import loss_and_grads as lg64

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    for mesh, heads, params, ref, ranks in runs:
        m64 = build64(W64.axis_cfg(arch, heads=heads), device="cpu",
                      axes=shd64.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]}))
        load64(m64, jax.tree.map(
            lambda a: np.asarray(a).astype(np.float64) if np.asarray(a).dtype == np.float32 else np.asarray(a), params))
        inputs = W64.axis_inputs(arch)
        batch = {k: (v.double() if v.is_floating_point() else v) for k, v in inputs["train"].items()}
        _, _, g64 = lg64(m64, batch)
        with torch.no_grad():
            prompt = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v)
                      for k, v in inputs["prompt"].items()}
            lp64, cache = m64.prefill(prompt, max_len=W64.AXIS_SEQ + W64.DECODE_ROOM)
            logits64 = [lp64.numpy()]
            for t in range(W64.AXIS_DECODE):
                lg, cache = m64.decode_step(cache, {"tokens": torch.from_numpy(inputs["decode"][t])})
                logits64.append(lg.numpy())
        split = ranks[0]["grads"]
        g = {"split": {n: t.numpy() for n, t in split.items()}, "port": ref["port"]["grads"], "JAX": ref["jax"]["grads"]}
        tag = f"{arch} {mesh[0]}x{mesh[1]}" + (f" {heads} heads" if heads else "")
        print(f"{tag}: gradients, max over parameters of max|a-b|/max|b|")
        for a, b in (("split", "f64"), ("port", "f64"), ("JAX", "f64"), ("split", "JAX"), ("split", "port")):
            want = {n: t.numpy() for n, t in g64.items()} if b == "f64" else g[b]
            worst = max((rel(g[a][n], want[n]), n) for n in want)
            print(f"  {a:>5s}-{b:<5s} {worst[0]:.3e}  ({worst[1]})")
        # logits: each rank's rows of the split against the same rows of the others
        want = {"JAX": [ref["prefill"], *ref["decode"]], "f64": logits64}
        port_rows = {}
        for name, rows in want.items():
            worst = 0.0
            for r in ranks:
                n = W.AXIS_BATCH // r["shards"]
                sl = slice(r["shard"] * n, (r["shard"] + 1) * n)
                for a, b in zip([r["prefill"], *r["decode"]], rows):
                    worst = max(worst, float(np.abs(a.numpy().astype(np.float64) - b[sl]).max()))
            port_rows[name] = worst
        jf = max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(want["JAX"], logits64))
        print(f"  logits: split-f64 {port_rows['f64']:.3e}  JAX-f64 {jf:.3e}  split-JAX {port_rows['JAX']:.3e}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["axis"]:
        axis(*sys.argv[2:])
    else:
        main(*sys.argv[1:])
