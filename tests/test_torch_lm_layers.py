"""The LM layers of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from fixed seeds, go through each JAX function
and its port.  Float layers agree within a tolerance stated at each
comparison (f32 throughout; the two packages sum in different orders).  The
hardened router tables and the hard routes agree with ``np.array_equal``:
the router tests use dyadic inputs (small integers ÷ 8), so that every
``z = x @ router_proj`` is exact in any summation order, and thresholds
taken from ``z`` itself, so that some tokens sit exactly on a threshold.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.core import soft_tree as jst
from repro.models import schema as jsch
from repro.models.layers import attention as jattn
from repro.models.layers import mlp as jmlp
from repro.models.layers import moe as jmoe
from repro.models.layers import rope as jrope
from repro.parallel.sharding import single_device_axes
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import soft_tree as st
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mlp as mlpl
from repro_torch.models.layers import moe as moel
from repro_torch.models.layers import rope

AXES = single_device_axes()
# f32 everywhere; XLA's CPU dots and torch's sum in different orders, and
# their exp/log/sin/cos may differ in the last ulp: results of magnitude ≲ 10
# move by a few ulps, well inside 1e-5.
RTOL = ATOL = 1e-5


def _cfgs(**kw) -> tuple[ModelConfig, JaxModelConfig]:
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
    base.update(kw)
    moe = base.pop("moe", None)
    port = ModelConfig(**base, moe=MoEConfig(**moe) if moe else None)
    ref = JaxModelConfig(**base, moe=JaxMoEConfig(**moe) if moe else None)
    return port, ref


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# rope, rmsnorm, mlp
# ---------------------------------------------------------------------------


def test_rope_and_mrope_equal_jax():
    x = _normal(0, 2, 9, 4, 16)
    pos = np.random.default_rng(1).integers(0, 4096, size=(2, 9)).astype(np.int32)
    _close(rope.apply_rope(_t(x), _t(pos), theta=1e4), jrope.apply_rope(x, pos, theta=1e4))
    streams = np.random.default_rng(2).integers(0, 512, size=(2, 3, 9)).astype(np.int32)
    _close(rope.apply_mrope(_t(x), _t(streams), theta=1e6, sections=(4, 2, 2)),
           jrope.apply_mrope(x, streams, theta=1e6, sections=(4, 2, 2)))
    for style in ("rope", "mrope"):
        got = rope.positions_for(2, 7, style=style, offset=3)
        assert np.array_equal(got.numpy(), np.asarray(jrope.positions_for(2, 7, style=style, offset=3)))
        assert got.dtype == torch.int32


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_rmsnorm_and_mlp_equal_jax(act):
    cfg, jcfg = _cfgs(act=act)
    x = _normal(3, 2, 5, 64)
    params = {k: _normal(i + 4, *s.shape) * 0.1 for i, (k, s) in enumerate(sch.leaves(mlpl.mlp_schema(cfg)))}
    assert set(params) == set(jmlp.mlp_schema(jcfg, AXES))
    _close(mlpl.mlp({k: _t(v) for k, v in params.items()}, _t(x), cfg=cfg), jmlp.mlp(params, x, cfg=jcfg))
    scale = _normal(9, 64)
    _close(mlpl.rmsnorm({"scale": _t(scale)}, _t(x), eps=1e-5),
           jmlp.rmsnorm({"scale": scale}, x, eps=1e-5))


def test_rmsnorm_computes_in_f32_and_casts_back():
    x = torch.from_numpy(_normal(10, 3, 64)).to(torch.bfloat16)
    out = mlpl.rmsnorm({"scale": torch.ones(64)}, x, eps=1e-5)
    assert out.dtype == torch.bfloat16
    want = (x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-5)).to(torch.bfloat16)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(cfg, sq=64, sk=64, seed=0):
    hd = cfg.head_dim_
    return (_normal(seed, 2, sq, cfg.n_heads, hd), _normal(seed + 1, 2, sk, cfg.n_kv_heads, hd),
            _normal(seed + 2, 2, sk, cfg.n_kv_heads, hd))


def test_direct_attention_equals_jax():
    cfg, jcfg = _cfgs()
    q, k, v = _qkv(cfg)
    mask = np.asarray(jattn.causal_mask(64, 64))
    assert np.array_equal(attn.causal_mask(64, 64).numpy(), mask)
    _close(attn._grouped_attention(_t(q), _t(k), _t(v), _t(mask), cfg),
           jattn._grouped_attention(q, k, v, mask[None, None, None], jcfg))


@pytest.mark.parametrize("kv_block", [8, 16, 64])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_blockwise_attention_equals_jax(kv_block, q_offset):
    """A KV block smaller than S: the online-softmax loop against JAX's scan."""
    cfg, jcfg = _cfgs()
    q, k, v = _qkv(cfg, sq=48, sk=64, seed=4)
    _close(attn.blockwise_attention(_t(q), _t(k), _t(v), cfg=cfg, kv_block=kv_block, q_offset=q_offset),
           jattn.blockwise_attention(q, k, v, cfg=jcfg, kv_block=kv_block, q_offset=q_offset))


@pytest.mark.parametrize("is_global", [None, False, True])
def test_sliding_window_and_is_global_equal_jax(is_global):
    cfg, jcfg = _cfgs(sliding_window=16)
    q, k, v = _qkv(cfg, seed=7)
    jg = None if is_global is None else jnp.asarray(is_global)
    _close(attn.blockwise_attention(_t(q), _t(k), _t(v), cfg=cfg, window=16, is_global=is_global, kv_block=8),
           jattn.blockwise_attention(q, k, v, cfg=jcfg, window=16, is_global=jg, kv_block=8))
    # grouped_attention dispatches to blockwise past one KV block, direct below
    for kv_block in (16, 1024):
        _close(attn.grouped_attention(_t(q), _t(k), _t(v), cfg=cfg, window=16, is_global=is_global,
                                      kv_block=kv_block),
               jattn.grouped_attention(q, k, v, cfg=jcfg, window=16, is_global=jg, kv_block=kv_block))


@pytest.mark.parametrize("rope_style,window", [("rope", 0), ("mrope", 0), ("rope", 4)])
def test_decode_against_cache_equals_jax(rope_style, window):
    """One decode step writes the cache at ``pos`` (in place in the port) and
    attends over it; output and cache equal JAX's."""
    cfg, jcfg = _cfgs(rope_style=rope_style, mrope_sections=(4, 2, 2), sliding_window=window)
    params = {k: _normal(i, *s.shape) * 0.125 for i, (k, s) in enumerate(sch.leaves(attn.attn_schema(cfg)))}
    x = _normal(11, 2, 1, 64)
    shape, dtype = attn.cache_shape(cfg, 2, 12)
    assert dtype == torch.float32
    k0, v0 = _normal(12, *shape), _normal(13, *shape)
    pos = 5
    positions = np.full((2, 3, 1) if rope_style == "mrope" else (2, 1), pos, np.int32)
    cache = attn.KVCache(k=_t(k0), v=_t(v0))
    out, new = attn.attention_decode({k: _t(p) for k, p in params.items()}, _t(x), cache, pos, cfg=cfg,
                                     positions=_t(positions), window=window)
    want, jnew = jattn.attention_decode(params, x, jattn.KVCache(k=k0, v=v0), jnp.asarray(pos, jnp.int32),
                                        cfg=jcfg, positions=positions, window=window)
    _close(out, want)
    _close(new.k, jnew.k)
    _close(new.v, jnew.v)
    assert new.k is cache.k    # written in place
    with pytest.raises(IndexError, match="outside a cache"):
        attn.attention_decode({k: _t(p) for k, p in params.items()}, _t(x), cache, 12, cfg=cfg,
                              positions=_t(positions))


def test_attention_module_equals_jax_attention():
    """The module's full-sequence forward (projections, rope, causal
    attention, output projection) against the JAX ``attention``; its k/v
    are the rotated keys and the values the cache stores."""
    cfg, jcfg = _cfgs()
    params = {k: _normal(i + 20, *s.shape) * 0.125 for i, (k, s) in enumerate(sch.leaves(attn.attn_schema(cfg)))}
    x = _normal(30, 2, 10, 64)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    module = attn.Attention(cfg, "cpu")
    with torch.no_grad():
        for name, p in params.items():
            getattr(module, name).copy_(_t(p))
        out, k, v = module(_t(x), _t(pos))
    _close(out, jattn.attention(params, x, cfg=jcfg, positions=pos))
    _, jk, jv = jattn._project_qkv(params, x, None, jcfg, pos)
    _close(k, jk)
    _close(v, jv)


# ---------------------------------------------------------------------------
# soft tree
# ---------------------------------------------------------------------------


def _soft_tree(depth: int, n_out: int, seed: int):
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(32, 2**depth - 1)).astype(np.float32) * 0.3
    thr = rng.normal(size=(2**depth - 1,)).astype(np.float32) * 0.2
    lmap = (np.arange(2**depth) % n_out).astype(np.int32)
    jcfg = jst.SoftTreeConfig(depth=depth, in_features=32, n_outputs=n_out)
    cfg = st.SoftTreeConfig(depth=depth, in_features=32, n_outputs=n_out)
    return (cfg, st.SoftTreeParams(_t(proj), _t(thr), _t(lmap)),
            jcfg, jst.SoftTreeParams(jnp.asarray(proj), jnp.asarray(thr), jnp.asarray(lmap)))


@pytest.mark.parametrize("depth,n_out", [(1, 2), (3, 5), (6, 40)])
def test_soft_tree_probs_equal_jax(depth, n_out):
    """exp of summed log-sigmoids: rtol 1e-5 (f32 transcendentals differ by ulps)."""
    cfg, params, jcfg, jparams = _soft_tree(depth, n_out, seed=depth)
    x = _normal(40, 3, 7, 32)
    _close(st.leaf_probs(cfg, params, _t(x)), jst.leaf_probs(jcfg, jparams, x), atol=1e-7)
    _close(st.output_probs(cfg, params, _t(x)), jst.output_probs(jcfg, jparams, x), atol=1e-7)
    lp = st.leaf_probs(cfg, params, _t(x))
    _close(st.load_balance_loss(lp), jst.load_balance_loss(np.asarray(lp)))
    node_idx, branch = st._paths(depth)
    jnode, jbranch = jst._paths(depth)
    assert np.array_equal(node_idx, jnode) and np.array_equal(branch, jbranch)


@pytest.mark.parametrize("depth,n_out", [(1, 2), (3, 5), (6, 40)])
def test_harden_tables_equal_jax(depth, n_out):
    cfg, params, jcfg, jparams = _soft_tree(depth, n_out, seed=10 + depth)
    got, want = st.harden(cfg, params), jst.harden(jcfg, jparams)
    for name in ("attr_idx", "threshold", "child", "class_val"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
        assert getattr(got, name).dtype == getattr(want, name).dtype, name


def test_init_soft_tree_shapes():
    cfg = st.SoftTreeConfig(depth=3, in_features=16, n_outputs=5)
    p = st.init_soft_tree(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p.proj.shape == (16, 7) and torch.equal(p.threshold, torch.zeros(7))
    assert p.leaf_map.tolist() == [0, 1, 2, 3, 4, 0, 1, 2]


# ---------------------------------------------------------------------------
# MoE: router, hard route, dispatch
# ---------------------------------------------------------------------------


def _dyadic(seed: int, *shape) -> np.ndarray:
    """Small integers ÷ 8: products and their sums stay exact in f32."""
    return (np.random.default_rng(seed).integers(-4, 5, size=shape) / 8).astype(np.float32)


def _moe_setup(router="tree", e=5, k=3, depth=3, cf=8.0, d_ff=16, seed=0):
    cfg, jcfg = _cfgs(family="moe", d_model=48, d_ff=0,
                      moe=dict(n_experts=e, top_k=k, d_ff=d_ff, router=router,
                               router_tree_depth=depth, capacity_factor=cf))
    jparams = jsch.init_params(jmoe.moe_schema(jcfg, AXES), jax.random.key(seed))
    params = {name: np.asarray(a) for name, a in jparams.items()}
    assert set(params) == {name for name, _ in sch.leaves(moel.moe_schema(cfg))}
    for name, s in sch.leaves(moel.moe_schema(cfg)):
        assert params[name].shape == s.shape, name
    if router == "tree":
        params["router_proj"] = _dyadic(seed + 1, *params["router_proj"].shape)
    return cfg, jcfg, params


def _tie_thresholds(params, x, seed: int) -> np.ndarray:
    """Thresholds equal to some tokens' own z, so those tokens tie exactly."""
    z = x.reshape(-1, x.shape[-1]) @ params["router_proj"]        # exact: dyadic
    rows = np.random.default_rng(seed).integers(0, z.shape[0], size=z.shape[1])
    return z[rows, np.arange(z.shape[1])].astype(np.float32)


@pytest.mark.parametrize("depth,e", [(3, 5), (6, 40)])
def test_hard_tree_route_equals_jax_on_dyadic_inputs(depth, e):
    cfg, jcfg, params = _moe_setup(e=e, depth=depth, k=2)
    x = _dyadic(5, 2, 32, 48)
    params["router_thr"] = _tie_thresholds(params, x, seed=6)
    z = x.reshape(-1, 48) @ params["router_proj"]
    assert (z == params["router_thr"]).any(), "no token sits on a threshold"
    tparams = {k: _t(v) for k, v in params.items()}
    got = moel.hard_tree_route(tparams, _t(x), cfg=cfg, e_pad=e)
    want = np.asarray(jmoe.hard_tree_route(params, x, cfg=jcfg, e_pad=e))
    assert got.dtype == torch.int32 and got.shape == (2, 32)
    assert np.array_equal(got.numpy(), want)
    # the packed router (built once) routes as the per-call build does
    packed = moel.pack_router(cfg, tparams["router_thr"])
    assert packed.n_nodes == 2 ** (depth + 1) - 1 and packed.n_attrs == 2**depth - 1
    assert torch.equal(moel.hard_tree_route(tparams, _t(x), cfg=cfg, e_pad=e, packed=packed), got)
    enc = moel.router_tree(cfg, tparams["router_thr"])
    jenc = jst.harden(jmoe._tree_cfg(jcfg, e), jst.SoftTreeParams(
        params["router_proj"], params["router_thr"], np.arange(2**depth, dtype=np.int32) % e))
    for name in ("attr_idx", "threshold", "child", "class_val"):
        assert np.array_equal(getattr(enc, name), getattr(jenc, name)), name


def test_tree_router_module_refuses_without_packed_tables():
    cfg, _, params = _moe_setup()
    router = moel.TreeRouter(cfg)
    with pytest.raises(RuntimeError, match="not packed"):
        router(_t(_dyadic(1, 1, 4, 48)), _t(params["router_proj"]))
    router.pack(_t(params["router_thr"]))
    assert router(_t(_dyadic(1, 1, 4, 48)), _t(params["router_proj"])).shape == (1, 4)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("group_size", [64, 16])
def test_hard_moe_apply_equals_jax(cf, group_size):
    """Hard routing (tree expert + k−1 neighbours, gates 1/k) through the
    capacity dispatch; at cf 0.5 tokens are dropped, in the reference's
    priority order.  Routes are exact (dyadic); y within RTOL/ATOL."""
    cfg, jcfg, params = _moe_setup(cf=cf, k=3)
    x = _dyadic(7, 2, 32, 48)
    params["router_thr"] = _tie_thresholds(params, x, seed=8)
    tparams = {k: _t(v) for k, v in params.items()}
    y, aux = moel.moe_apply(tparams, _t(x), cfg=cfg, group_size=group_size, serve_hard_tree=True)
    jy, jaux = jmoe.moe_apply(params, x, cfg=jcfg, axes=AXES, group_size=group_size, serve_hard_tree=True)
    _close(y, jy)
    assert float(aux) == float(jaux) == 0.0
    cap = moel._capacity(min(group_size, 64), cfg.moe, 5)
    assert cap == jmoe._capacity(min(group_size, 64), jcfg.moe, 5)
    # the tokens that lost a choice to the capacity: the same in both packages,
    # none at cf 8.0, some at cf 0.5
    roomy, jroomy = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)), \
        dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
    y_all, _ = moel.moe_apply(tparams, _t(x), cfg=roomy, group_size=group_size, serve_hard_tree=True)
    jy_all, _ = jmoe.moe_apply(params, x, cfg=jroomy, axes=AXES, group_size=group_size, serve_hard_tree=True)
    hit = (y != y_all).any(-1).numpy()
    assert np.array_equal(hit, np.asarray(jy != jy_all).any(-1))
    assert hit.any() == (cf < 1.0)


@pytest.mark.parametrize("router", ["softmax", "tree"])
def test_soft_moe_apply_equals_jax(router):
    """Soft routing (top-k of the router's probabilities) and the aux loss."""
    cfg, jcfg, params = _moe_setup(router=router, e=4, k=2, depth=0)
    x = _normal(9, 2, 16, 48)
    y, aux = moel.moe_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg=cfg, group_size=16)
    jy, jaux = jmoe.moe_apply(params, x, cfg=jcfg, axes=AXES, group_size=16)
    _close(y, jy)
    _close(aux, jaux)
    _close(moel.router_probs({k: _t(v) for k, v in params.items()}, _t(x), cfg=cfg, e_pad=4),
           jmoe.router_probs(params, x, cfg=jcfg, e_pad=4))


def test_moe_apply_refuses_a_ragged_group():
    cfg, _, params = _moe_setup()
    with pytest.raises(ValueError, match="not divisible"):
        moel.moe_apply({k: _t(v) for k, v in params.items()}, _t(_dyadic(1, 1, 24, 48)), cfg=cfg,
                       group_size=16, serve_hard_tree=True)


@pytest.mark.parametrize("n_experts,model_size", [(40, 1), (40, 16), (16, 4), (3, 8)])
def test_padded_experts_and_capacity_equal_jax(n_experts, model_size):
    moe = MoEConfig(n_experts=n_experts, top_k=8, d_ff=8)
    jmoe_cfg = JaxMoEConfig(n_experts=n_experts, top_k=8, d_ff=8)

    class Axes:       # the JAX function reads only the model axis's size
        pass

    axes = Axes()
    axes.model_size = model_size
    e_pad = moel.padded_experts(moe, model_size)
    assert e_pad == jmoe.padded_experts(jmoe_cfg, axes)
    for g in (4, 34, 512):
        assert moel._capacity(g, moe, e_pad) == jmoe._capacity(g, jmoe_cfg, e_pad)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def test_schema_counts_and_cast_for_compute():
    cfg, jcfg = _cfgs(family="moe", moe=dict(n_experts=4, top_k=2, d_ff=32, router="tree"))
    schema = {"attn": attn.attn_schema(cfg), "moe": moel.moe_schema(cfg)}
    jschema = {"attn": jattn.attn_schema(jcfg, AXES), "moe": jmoe.moe_schema(jcfg, AXES)}
    assert sch.param_count(schema) == jsch.param_count(jschema)
    assert sch.param_count(sch.stacked(schema, 3)) == 3 * sch.param_count(schema)
    params = {"w": torch.ones(4, 4), "a_log": torch.ones(4, 4), "scale": torch.ones(4),
              "layers.0.moe.router_proj": torch.ones(4, 4), "nested": {"wi": torch.ones(2, 2)}}
    out = sch.cast_for_compute(params, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["nested"]["wi"].dtype == torch.bfloat16
    for kept in ("a_log", "scale", "layers.0.moe.router_proj"):
        assert out[kept] is params[kept]
    assert sch.cast_for_compute(params, torch.float32)["w"] is params["w"]


def test_init_params_draws_the_jax_distribution():
    """Fan-in normal (std 1/√fan-in, of the stacked shape for a stack), zeros,
    ones and log(1..N) as the JAX ``_init_leaf`` draws them; the bits differ."""
    schema = {"w": sch.PSpec((256, 64)), "stack": sch.PSpec((4, 256, 64)), "z": sch.PSpec((8,), init="zeros"),
              "o": sch.PSpec((8,), init="ones"), "a": sch.PSpec((3, 5), init="ssm_log_a"),
              "u": sch.PSpec((1000,), init="uniform")}
    out = sch.init_params(schema, torch.Generator().manual_seed(0), device="cpu")
    assert abs(out["w"].std().item() - 1 / 16) < 0.003
    assert abs(out["stack"].std().item() - 1 / 32) < 0.0015
    assert torch.equal(out["z"], torch.zeros(8)) and torch.equal(out["o"], torch.ones(8))
    assert torch.allclose(out["a"], torch.log(torch.arange(1, 6.0)).expand(3, 5))
    assert -0.5 <= out["u"].min() and out["u"].max() <= 0.5
    jout = jsch.init_params({"a": jsch.PSpec((3, 5), init="ssm_log_a")}, jax.random.key(0))
    _close(out["a"], jout["a"])
    spec = sch.PSpec((4, 256, 64))
    assert sch.init_scale(spec) == 1.0 / np.sqrt(4 * 256)
    assert sch.init_scale(dataclasses.replace(spec, scale=0.5)) == 0.5
