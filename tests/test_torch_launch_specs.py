"""The port's dry-run specs (``repro_torch.launch.specs``) against the JAX
package's ``launch/specs.py``, with no tolerance.

For every architecture at its full config and every shape cell, on the
single-pod 16×16 and the multi-pod 2×16×16 mesh's axes (nothing is
allocated in either package: the port builds on ``meta``, JAX builds its
model object and ``ShapeDtypeStruct``s): the batch's shapes and dtypes and
specs, the size-aware parallelism policy and the serving-FSDP rule, the
cache's shapes and specs, ``plan_cell``'s argument shapes and specs
(parameters, AdamW state, cache, batch), the microbatch choice, and the
useful-FLOPs formula.
"""

from __future__ import annotations

import dataclasses

import pytest
from jax.sharding import PartitionSpec as JP

import repro.train.step as jstep
from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.parallel import sharding as jshd
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline, specs
from repro_torch.parallel import sharding as shd

MESHES = {
    "16x16": (("data",), {"data": 16, "model": 16}),
    "2x16x16": (("pod", "data"), {"pod": 2, "data": 16, "model": 16}),
}
CELLS = [(arch, shape) for arch in jreg.ARCH_IDS for shape in JSHAPES]


def _axes(mesh: str):
    batch, sizes = MESHES[mesh]
    return (jshd.MeshAxes(batch=batch, model="model", sizes=dict(sizes)),
            shd.MeshAxes(batch=batch, model="model", sizes=dict(sizes)))


def _is_spec(x) -> bool:
    return isinstance(x, (JP, shd.PartitionSpec))


def _leaf(x):
    """A comparable form: a spec as its tuple, a tensor or ShapeDtypeStruct as
    (shape, dtype name), a shape tuple as itself."""
    if _is_spec(x):
        return tuple(x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return x


def _flat(tree, prefix: str = "") -> dict:
    """Path → leaf of nested dicts, named tuples and tuples (the cache's ``pos``
    left out: JAX's is a traced int32 scalar, the port's a Python int)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = ((k, v) for k, v in zip(tree._fields, tree) if k != "pos")
    elif isinstance(tree, (tuple, list)) and not _is_spec(tree) and not all(isinstance(v, int) for v in tree):
        items = enumerate(tree)
    else:
        return {prefix: _leaf(tree)}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flat(v, f"{prefix}{k}."))
    return out


def _shapes_only(flat: dict) -> dict:
    """A parameter tree's shapes (the port's ``param_shapes`` holds no dtype)."""
    return {k: v[0] if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], str) else v
            for k, v in flat.items()}


def _axes_fields(axes) -> tuple:
    return tuple(axes.batch), axes.model, dict(axes.sizes), axes.fsdp, axes.tp


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_batch_specs_equal_jax(arch, shape):
    jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
    want = jspecs.input_specs(jcfg, JSHAPES[shape])
    got = specs.input_specs(cfg, SHAPES[shape])
    assert _flat(got) == _flat(want)
    for mesh in MESHES:
        jaxes, paxes = _axes(mesh)
        assert _flat(specs.batch_pspecs(cfg, SHAPES[shape], paxes)) == \
            _flat(jspecs.batch_pspecs(jcfg, JSHAPES[shape], jaxes))


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_parallelism_policy_and_serving_fsdp_equal_jax(arch, mesh):
    jaxes, paxes = _axes(mesh)
    jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
    assert specs.TP_MIN_PARAMS == jspecs.TP_MIN_PARAMS
    got, want = specs.axes_for(cfg, paxes), jspecs.axes_for(jcfg, jaxes)
    assert _axes_fields(got) == _axes_fields(want)
    # JAX's serving-FSDP rule is inline in plan_cell: its serving model's axes
    jplan = jspecs.plan_cell(jcfg, JSHAPES["decode_32k"], jaxes)
    pplan = specs.plan_cell(cfg, SHAPES["decode_32k"], paxes)
    assert _axes_fields(pplan.model.axes) == _axes_fields(_jax_model(jplan).axes)
    assert _axes_fields(specs.serving_axes(cfg, got)) == _axes_fields(pplan.model.axes)


def _jax_model(jplan):
    """JAX's serving model (from the closure of its step)."""
    (model,) = [c.cell_contents for c in jplan.fn.__closure__ if hasattr(c.cell_contents, "cache_specs")]
    return model


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_plan_cell_arguments_equal_jax(arch, shape, mesh, monkeypatch):
    jaxes, paxes = _axes(mesh)
    jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
    seen = {}
    real = jstep.make_train_step

    def capture(model, tcfg):       # JAX's microbatch choice is inline in plan_cell
        seen["microbatch"] = tcfg.microbatch
        return real(model, tcfg)

    monkeypatch.setattr(jstep, "make_train_step", capture)
    want = jspecs.plan_cell(jcfg, JSHAPES[shape], jaxes)
    got = specs.plan_cell(cfg, SHAPES[shape], paxes)
    assert got.step_name == want.step_name
    assert len(got.args) == len(want.args) and got.donate == tuple(want.donate)
    # parameters: shapes; everything else: shapes and dtypes
    assert _shapes_only(_flat(got.args[0])) == _shapes_only(_flat(want.args[0]))
    for g, w in zip(got.args[1:], want.args[1:]):
        assert _flat(g) == _flat(w)
    for g, w in zip(got.in_specs, want.in_specs):
        assert _flat(g) == _flat(w)
    if JSHAPES[shape].kind == "train":
        assert got.tcfg.microbatch == seen["microbatch"] == specs.microbatches_for(cfg)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s in CELLS if JSHAPES[s].kind == "decode"])
def test_cache_shapes_and_specs_equal_jax(arch, shape):
    sh = JSHAPES[shape]
    for mesh in MESHES:
        jaxes, paxes = _axes(mesh)
        jm = jspecs.plan_cell(jreg.get_config(arch), sh, jaxes)
        pm = specs.plan_cell(registry.get_config(arch), SHAPES[shape], paxes)
        jmodel = _jax_model(jm)
        for gb in (0, sh.global_batch):
            assert _flat(pm.model.cache_specs(gb)) == _flat(jmodel.cache_specs(gb))
        assert _flat(pm.model.cache_shapes(sh.global_batch, sh.seq_len)) == \
            _flat(jmodel.cache_shapes(sh.global_batch, sh.seq_len))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    assert roofline.model_flops_for(registry.get_config(arch), SHAPES[shape]) == \
        jroofline.model_flops_for(jreg.get_config(arch), JSHAPES[shape])


def test_dryrun_config_is_the_identity_and_serving_config_is_bf16():
    cfg = registry.get_config("granite-moe-3b-a800m")
    assert specs.dryrun_config(cfg) is cfg
    assert specs.serving_config(cfg) == dataclasses.replace(cfg, param_dtype=cfg.dtype)
