"""The port's mesh axes, parameter specs and ZeRO-1 state specs against the
JAX package's, in pure Python (no process group, no device).

Every architecture is built at its full config on ``meta`` (the port) and as
the JAX model object (no arrays), on the single-pod 16×16, the multi-pod
2×16×16 and a 2×2 mesh's axes, and once with tensor parallelism off; the
spec trees must be equal leaf for leaf, as tuples.  No tolerance: these are
discrete policies.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro.models.layers import moe as jmoe
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro_torch.configs import registry
from repro_torch.models import build_model
from repro_torch.models.layers import moe as moel
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd

MESHES = {
    "16x16": (("data",), {"data": 16, "model": 16}),
    "2x16x16": (("pod", "data"), {"pod": 2, "data": 16, "model": 16}),
    "2x2": (("data",), {"data": 2, "model": 2}),
}
CASES = [(arch, mesh, True) for arch in jreg.ARCH_IDS for mesh in MESHES] + [("granite-moe-3b-a800m", "2x2", False)]


def _axes(mesh: str, tp: bool):
    batch, sizes = MESHES[mesh]
    batch = batch + (() if tp else ("model",))
    return (jshd.MeshAxes(batch=batch, model="model", sizes=dict(sizes), tp=tp),
            shd.MeshAxes(batch=batch, model="model", sizes=dict(sizes), tp=tp))


def _flat(tree, prefix: str = "") -> dict:
    """Dotted path → tuple of a nested dict of specs (JAX's ``P`` or the port's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


def _models(arch: str, mesh: str, tp: bool):
    jaxes, paxes = _axes(mesh, tp)
    jm = jax_build_model(jreg.get_config(arch), jaxes)
    pm = build_model(registry.get_config(arch), device="meta", axes=paxes)
    return jm, pm, jaxes, paxes


@pytest.mark.parametrize("arch,mesh,tp", CASES)
def test_param_specs_equal_jax_leaf_for_leaf(arch, mesh, tp):
    jm, pm, _, _ = _models(arch, mesh, tp)
    want, got = _flat(jm.param_specs()), _flat(pm.param_specs())
    assert got == want


@pytest.mark.parametrize("arch,mesh,tp", CASES)
def test_param_shapes_and_padding_equal_jax(arch, mesh, tp):
    jm, pm, jaxes, _ = _models(arch, mesh, tp)
    want = {k: tuple(s.shape) for k, s in _flat_shapes(jm.param_shapes()).items()}
    assert _flat(pm.param_shapes()) == want
    assert pm.v_pad == jm.v_pad
    cfg = jreg.get_config(arch)
    if cfg.moe is not None:
        assert moel.padded_experts(registry.get_config(arch).moe, pm.axes.model_size) == \
            jmoe.padded_experts(cfg.moe, jaxes)


def _flat_shapes(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,mesh,tp", CASES)
def test_adamw_state_specs_equal_jax(arch, mesh, tp):
    jm, pm, jaxes, paxes = _models(arch, mesh, tp)
    want = jadamw.adamw_state_specs(jm.param_specs(), jm.param_shapes(), jaxes)
    got = adamw.adamw_state_specs(pm.param_specs(), pm.param_shapes(), paxes)
    for a, b in ((got.m, want.m), (got.v, want.v)):
        assert _flat(a) == _flat(b)
    assert tuple(got.count) == tuple(want.count)
    shapes = adamw.adamw_state_shapes(pm.param_shapes())
    assert {k: tuple(t.shape) for k, t in _flat_shapes(shapes.m).items()} == _flat(pm.param_shapes())


@pytest.mark.parametrize("n_experts,model_size", [(5, 2), (40, 2), (40, 4), (16, 16), (3, 4), (1, 16)])
def test_padded_experts_and_vocab_pad_equal_jax(n_experts, model_size):
    cfg = registry.get_config("granite-moe-3b-a800m")
    moe = cfg.moe.__class__(**{**cfg.moe.__dict__, "n_experts": n_experts})
    jcfg = jreg.get_config("granite-moe-3b-a800m")
    jmoe_cfg = jcfg.moe.__class__(**{**jcfg.moe.__dict__, "n_experts": n_experts})
    jaxes = jshd.MeshAxes(batch=("data",), model="model", sizes={"data": 2, "model": model_size})
    paxes = shd.MeshAxes(batch=("data",), model="model", sizes={"data": 2, "model": model_size})
    assert moel.padded_experts(moe, model_size) == jmoe.padded_experts(jmoe_cfg, jaxes)
    for vocab in (512, 49_155, 64_000, 151_936):
        assert shd.pad_vocab(vocab, paxes) == jshd.pad_vocab(vocab, jaxes)


def test_granite_pads_vocab_with_the_model_axis_and_keeps_40_experts():
    cfg = registry.get_config("granite-moe-3b-a800m")
    one = build_model(cfg, device="meta")
    two = build_model(cfg, device="meta", axes=shd.MeshAxes(("data",), "model", {"data": 2, "model": 2}))
    four = build_model(cfg, device="meta", axes=shd.MeshAxes(("data",), "model", {"data": 1, "model": 4}))
    assert (one.v_pad, two.v_pad) == (49_280, 49_408)
    assert [m.layers[0].moe.wi.shape[0] for m in (one, two, four)] == [40, 40, 40]


# the JAX package's own unit tests (tests/test_distributed.py), run against the port


ZERO1_CASES = [
    ((None, None), (64, 4096), (None, "data")),     # a replicated 2-D parameter gains a 'data' slice
    (("data", None), (64, 64), ("data", None)),    # already data-sharded: unchanged
    ((None,), (30,), (None,)),                      # indivisible dims stay replicated
    (("model", None), (64, 4096), ("model", "data")),
    ((None, ("pod", "data")), (64, 64), (None, ("pod", "data"))),
]


@pytest.mark.parametrize("spec,shape,want", ZERO1_CASES)
def test_zero1_spec_shards_unsharded_dim(spec, shape, want):
    jaxes = jshd.MeshAxes(batch=("data",), model="model", sizes={"data": 16, "model": 16})
    paxes = shd.MeshAxes(batch=("data",), model="model", sizes={"data": 16, "model": 16})
    got = shd.zero1_spec(shd.P(*spec), shape, paxes)
    assert tuple(got) == want
    assert tuple(got) == tuple(jshd.zero1_spec(JP(*spec), shape, jaxes))


BATCH_CASES = [(256, ("data", "model")), (512, ("pod", "data", "model")), (32, ("pod", "data")), (1, None),
               (6, ("pod",)), (16, ("data",)), (48, ("data",))]


@pytest.mark.parametrize("dim,want", BATCH_CASES)
def test_batch_axes_for_prefix_logic(dim, want):
    sizes = {"pod": 2, "data": 16, "model": 16}
    paxes = shd.MeshAxes(batch=("pod", "data", "model"), model="model", sizes=sizes)
    jaxes = jshd.MeshAxes(batch=("pod", "data", "model"), model="model", sizes=sizes)
    assert paxes.batch_axes_for(dim) == want == jaxes.batch_axes_for(dim)


@pytest.mark.parametrize("tp", [True, False])
def test_mesh_axes_methods_equal_jax(tp):
    sizes = {"pod": 2, "data": 4, "model": 8}
    batch = ("pod", "data") + (() if tp else ("model",))
    paxes = shd.MeshAxes(batch=batch, model="model", sizes=sizes, tp=tp)
    jaxes = jshd.MeshAxes(batch=batch, model="model", sizes=sizes, tp=tp)
    assert (paxes.batch_size, paxes.model_size, paxes.tp_axis) == (jaxes.batch_size, jaxes.model_size, jaxes.tp_axis)
    for dim in (1, 2, 3, 4, 8, 12, 16, 24, 64, 100):
        assert paxes.shard_if(dim) == jaxes.shard_if(dim)
        assert paxes.fsdp_if(dim) == jaxes.fsdp_if(dim)
        assert paxes.batch_if(dim) == jaxes.batch_if(dim)
        assert shd.free_model_seq(paxes, dim, 64) == jshd.free_model_seq(jaxes, dim, 64)
    assert tuple(shd.batch_spec(paxes, None)) == tuple(jshd.batch_spec(jaxes, None))
    assert _flat(shd.prepend({"a": shd.attn_specs(paxes, 8, 2, 64)})) == \
        _flat(jshd.prepend({"a": jshd.attn_specs(jaxes, 8, 2, 64)}))
    assert _flat(shd.embed_specs(paxes, 64)) == _flat(jshd.embed_specs(jaxes, 64))
    assert _flat(shd.norm_specs()) == _flat(jshd.norm_specs())


def _fake_mesh(*names):
    return SimpleNamespace(mesh_dim_names=names)


def test_placements_follow_the_spec():
    mesh = _fake_mesh("pod", "data", "model")
    assert shd.placements(shd.P("data", "model"), mesh) == (Replicate(), Shard(0), Shard(1))
    assert shd.placements(shd.P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert shd.placements(shd.P(), mesh) == (Replicate(),) * 3
    assert shd.placements(shd.P(None, None, "model"), mesh) == (Replicate(), Replicate(), Shard(2))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not one of"):
        shd.placements(shd.P("expert"), mesh)
