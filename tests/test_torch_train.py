"""The port's LM training path against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages; JAX parameters and optimizer
states are carried across with ``load_jax_params`` / ``load_jax_opt_state``.
Smoke configs in f32 of the three ported families: ``yi`` (dense),
``granite-moe`` (moe, tree router: the soft tree's gradients) and
``qwen2-vl`` (vlm: embeddings in, M-RoPE).  Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import pipeline as jpipeline
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jax_make_train_step
from repro.utils import losses as jlosses
from repro_torch.configs import ParallelConfig, ShapeConfig, TrainConfig, registry
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.models import build_model, load_jax_opt_state, load_jax_params
from repro_torch.models.layers import moe as moel
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine
from repro_torch.train import device_batch, make_train_step
from repro_torch.utils import losses

ARCHS = ["yi", "granite-moe", "qwen2-vl"]
SHAPE = (16, 2)                   # seq, batch
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# Loss values and gradients of the losses alone: f32 on both sides, sums in
# another order; measured max 4.8e-7 relative.
LOSS_TOL = 1e-6
# Model losses, gradients and train steps: two layers of products summed in
# another order; measured max relative (to each leaf's largest magnitude)
# 1.3e-6 on the gradients.
MODEL_TOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _close(got, want, tol: float) -> None:
    """|got − want| ≤ tol · (|want| + max |want|): relative, floored at the
    leaf's scale (a gradient entry near zero is compared at that scale)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * (float(np.abs(want).max()) + 1e-30))


def _jax_leaf(tree, name: str):
    """The JAX leaf (stacked layers indexed) of port parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


@functools.lru_cache(maxsize=None)
def _jax(arch: str, seed: int = 2):
    cfg = jreg.get_smoke_config(arch)
    model = jax_build_model(cfg)
    return model, model.init(jax.random.key(seed))


def _port(arch: str, params=None, **parallel):
    jmodel, jparams = _jax(arch)
    model = build_model(registry.get_smoke_config(arch), device="cpu",
                        parallel=ParallelConfig(**parallel) if parallel else None)
    return load_jax_params(model, jax.tree.map(np.asarray, jparams if params is None else params))


def _batch(arch: str, step: int = 0) -> dict:
    cfg = jreg.get_smoke_config(arch)
    return jpipeline.pipeline_for(cfg, JShape("s", *SHAPE, "train"), seed=0)(step)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _logits_and_labels(seed: int, v_pad: int, masked: bool):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 8, v_pad)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 8)).astype(np.int32)
    if masked:
        labels[0, -3:] = -1
        labels[1, 0] = -1
    return logits, labels


@pytest.mark.parametrize("v_pad", [10, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_and_its_gradient_equal_jax(v_pad, masked):
    logits, labels = _logits_and_labels(3, v_pad, masked)
    want, want_n = jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), vocab_size=10)
    want_g = jax.grad(lambda lg: jlosses.softmax_xent(lg, jnp.asarray(labels), vocab_size=10)[0])(
        jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got, got_n = losses.softmax_xent(lg, torch.from_numpy(labels), vocab_size=10)
    (got_g,) = torch.autograd.grad(got, lg)
    _close(got, want, LOSS_TOL)
    assert float(got_n) == float(want_n)
    _close(got_g, want_g, LOSS_TOL)
    if v_pad > 10:
        assert not got_g[..., 10:].any()            # the padded tail takes no gradient


@pytest.mark.parametrize("chunk", [4, 6, 16, 512])
def test_chunked_softmax_xent_and_its_gradients_equal_jax(chunk):
    """chunk 6 halves to 3, then 1 (S = 16); 512 clips to S."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    w = rng.normal(size=(8, 32)).astype(np.float32)
    labels = rng.integers(0, 30, size=(2, 16)).astype(np.int32)
    labels[:, -1] = -1

    def jloss(x_, w_):
        return jlosses.chunked_softmax_xent(x_, w_, jnp.asarray(labels), vocab_size=30, chunk=chunk)[0]

    want = jloss(jnp.asarray(x), jnp.asarray(w))
    want_gx, want_gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got, n_valid = losses.chunked_softmax_xent(tx, tw, torch.from_numpy(labels), vocab_size=30, chunk=chunk)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    assert float(n_valid) == 30.0
    _close(got, want, LOSS_TOL)
    _close(gx, want_gx, LOSS_TOL)
    _close(gw, want_gw, LOSS_TOL)


def test_chunked_loss_holds_one_chunk_of_logits_for_backward():
    """The chunks' logits are recomputed, not saved: the saved tensors of the
    graph hold no (B, c, V) block."""
    x = torch.randn(2, 16, 4, requires_grad=True)     # D < B·c: w is smaller than a chunk's logits
    w = torch.randn(4, 64, requires_grad=True)
    labels = torch.randint(0, 64, (2, 16))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = losses.chunked_softmax_xent(x, w, labels, vocab_size=64, chunk=4)
    assert max(sizes) < 2 * 4 * 64
    loss.backward()
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_lr_at_within_one_ulp_of_jax():
    for cfg in (dict(lr=3e-4, warmup_steps=100, total_steps=1000), dict(lr=1e-3, warmup_steps=0, total_steps=7),
                dict(lr=2.5e-2, warmup_steps=3, total_steps=3)):
        jcfg, tcfg = JTrain(**cfg), TrainConfig(**cfg)
        for step in list(range(0, 12)) + [99, 100, 101, 500, 999, 1000, 1001, 5000]:
            want = np.float32(jadamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
            got = adamw.lr_at(tcfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= np.spacing(np.abs(want)), (cfg, step, float(got), want)


def _small_tree(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
            "b": (rng.normal(size=(3,)) * scale).astype(np.float32),
            "s": (rng.normal(size=(2, 2, 2)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])    # below and above the clip
def test_global_norm_clip_and_adamw_apply_equal_jax(grad_scale):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, tcfg = JTrain(**cfg), TrainConfig(**cfg)
    params = _small_tree(0, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.adamw_init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = adamw.adamw_init(tp)
    for i in range(3):
        grads = _small_tree(10 + i, grad_scale)
        jg = jax.tree.map(jnp.asarray, grads)
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        _close(adamw.global_norm(tg), jadamw.global_norm(jg), LOSS_TOL)
        jclip, jn = jadamw.clip_by_global_norm(jg, 1.0)
        tclip, tn = adamw.clip_by_global_norm(tg, 1.0)
        _close(tn, jn, LOSS_TOL)
        for k in params:
            _close(tclip[k], jclip[k], LOSS_TOL)
        jp, jstate, jstats = jadamw.adamw_apply(jp, jg, jstate, jcfg)
        tp, tstate, tstats = adamw.adamw_apply(tp, tg, tstate, tcfg)
        for k in params:
            _close(tp[k], jp[k], LOSS_TOL)
            _close(tstate.m[k], jstate.m[k], LOSS_TOL)
            _close(tstate.v[k], jstate.v[k], LOSS_TOL)
        assert int(tstate.count) == int(jstate.count) == i + 1 and tstate.count.dtype == torch.int32
        _close(tstats["grad_norm"], jstats["grad_norm"], LOSS_TOL)
        _close(tstats["lr"], jstats["lr"], LOSS_TOL)
    assert float(jnp.abs(jp["b"] - params["b"]).max()) > 0        # 1-D: moved by the step only


def test_adamw_is_not_torch_optim_adamw():
    """The reference's update is not ``torch.optim.AdamW``'s: a step from a
    non-zero state with decay moves the weights elsewhere."""
    cfg = TrainConfig(lr=1e-1, warmup_steps=0, total_steps=10, weight_decay=0.5, b2=0.5)
    p = {"w": torch.full((2, 2), 2.0)}
    state = adamw.adamw_init(p)
    ref = torch.nn.Parameter(torch.full((2, 2), 2.0))
    opt = torch.optim.AdamW([ref], lr=1e-1, betas=(cfg.b1, cfg.b2), eps=1e-8, weight_decay=0.5)
    for g in (1e-3, 1e-9):
        adamw.adamw_apply(p, {"w": torch.full((2, 2), g)}, state, cfg)
        ref.grad = torch.full((2, 2), g)
        opt.step()
    assert not torch.allclose(p["w"], ref.detach(), rtol=1e-4, atol=0)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_decay_mask_equals_jax_leaf_for_leaf(arch, scan_layers):
    """With ``scan_layers`` the JAX tree stacks the layers, so every layer's
    norm scales (and router thresholds) are decayed; without, they are not."""
    jcfg = jreg.get_smoke_config(arch)
    jmodel = jax_build_model(jcfg, parallel=JParallel(scan_layers=scan_layers))
    shapes_ = jmodel.param_shapes()
    want = jax.tree.map(lambda s: len(s.shape) >= 2, shapes_)
    model = build_model(registry.get_smoke_config(arch), device="meta",
                        parallel=ParallelConfig(scan_layers=scan_layers))
    got = adamw.default_decay_mask(model)
    n_layers = jcfg.n_layers
    for name in got:
        parts = name.split(".")
        if parts[0] == "layers" and not scan_layers:
            node = want["layers"][f"layer_{int(parts[1]):03d}"]
            keys = parts[2:]
        elif parts[0] == "layers":
            node, keys = want["layers"], parts[2:]
        else:
            node, keys = want, parts
        for k in keys:
            node = node[k]
        assert got[name] == node, name
    per_layer = len(jax.tree.leaves(want["layers"])) // (1 if scan_layers else n_layers)
    assert len(got) == len(jax.tree.leaves(want)) - len(jax.tree.leaves(want["layers"])) + n_layers * per_layer
    assert got["final_norm.scale"] is False
    assert got["layers.0.ln1.scale"] is scan_layers


# ---------------------------------------------------------------------------
# DecoderModel.loss, remat and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_gradients_equal_jax(arch):
    jmodel, jparams = _jax(arch)
    batch = _batch(arch)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    model = _port(arch)
    named = dict(model.named_parameters())
    loss, aux = model.loss(device_batch(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
    _close(loss, jl, MODEL_TOL)
    _close(aux["nll"], jaux["nll"], MODEL_TOL)
    _close(aux["aux"], jaux["aux"], MODEL_TOL)
    if model.cfg.moe is not None:
        assert float(aux["aux"].detach()) > 0
        assert any(".moe.router_thr" in n for n in named)
    for (name, _), g in zip(named.items(), grads):
        _close(g, _jax_leaf(jg, name), MODEL_TOL)


@pytest.mark.parametrize("arch", ["yi", "granite-moe"])
def test_remat_modes_give_equal_gradients(arch):
    """none / full / dots / offload: the same loss and gradients bit for bit,
    and the same no-grad forward (the serving path never checkpoints)."""
    batch = device_batch(_batch(arch), "cpu")
    outs = {}
    for mode in ("none", "full", "dots", "offload"):
        model = _port(arch, remat=mode)
        named = dict(model.named_parameters())
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            logits, _ = model(batch)
        outs[mode] = (loss, grads, logits)
    for mode in ("full", "dots", "offload"):
        assert torch.equal(outs[mode][0], outs["none"][0])
        assert torch.equal(outs[mode][2], outs["none"][2])
        for a, b in zip(outs[mode][1], outs["none"][1]):
            assert torch.equal(a, b)


def test_remat_checkpoints_blocks_only_while_grad_is_enabled(monkeypatch):
    import repro_torch.models.schema as sch

    calls = []
    real = sch.checkpoint
    monkeypatch.setattr(sch, "checkpoint", lambda fn, *a, **kw: calls.append(kw) or real(fn, *a, **kw))
    model = _port("yi")
    batch = device_batch(_batch("yi"), "cpu")
    with torch.no_grad():
        model.loss(batch)
    assert calls == []
    model.loss(batch)
    assert len(calls) == model.cfg.n_layers and all(not kw["use_reentrant"] for kw in calls)
    unscanned = _port("yi", scan_layers=False)
    calls.clear()
    unscanned.loss(batch)
    assert calls == []                  # as in JAX: only the scanned stack is rematerialized
    # "offload": the same checkpoint per block, and its saved input, the one
    # tensor packed a block, goes to host memory and comes back for the
    # recompute; loss and gradients equal "full" bit for bit
    import repro_torch.models.lm as lm_model

    packed = []
    real_pack = lm_model._to_host
    monkeypatch.setattr(lm_model, "_to_host", lambda t: packed.append(t) or real_pack(t))
    calls.clear()
    offload = _port("yi", remat="offload")
    with torch.no_grad():
        offload.loss(batch)
    assert calls == [] and packed == []
    loss, _ = offload.loss(batch)
    assert len(calls) == len(packed) == model.cfg.n_layers and all(not kw["use_reentrant"] for kw in calls)
    assert all(t.shape == (*batch["tokens"].shape, model.cfg.d_model) for t in packed)
    got = torch.autograd.grad(loss, list(offload.parameters()))
    want_loss, _ = model.loss(batch)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, torch.autograd.grad(want_loss, list(model.parameters()))))
    with pytest.raises(ValueError):
        _port("yi", remat="everything").loss(batch)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(arch: str, microbatch: int = 0, n: int = 3):
    """JAX's (params, opt_state) as numpy after each of 1 + n steps, and the
    metrics of the last n: the first step, from adamw_init, gives the
    non-zero state the port starts from."""
    jmodel, jparams = _jax(arch)
    step = jax.jit(jax_make_train_step(jmodel, JTrain(**TCFG, microbatch=microbatch)))
    p, s = jparams, jadamw.adamw_init(jparams)
    states, metrics = [], []
    for i in range(n + 1):
        p, s, m = step(p, s, jax.tree.map(jnp.asarray, _batch(arch, i)))
        states.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)))
        metrics.append(jax.tree.map(np.asarray, m))
    return states, metrics[1:]


def _check_state(model, state, jparams, jstate) -> None:
    for name, p in model.named_parameters():
        _close(p, _jax_leaf(jparams, name), MODEL_TOL)
        _close(state.m[name], _jax_leaf(jstate.m, name), MODEL_TOL)
        _close(state.v[name], _jax_leaf(jstate.v, name), MODEL_TOL)
    assert int(state.count) == int(jstate.count)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_jax(arch, n):
    states, jmetrics = _jax_trajectory(arch)
    (p0, s0), (p1, s1) = states[0], states[n]
    model = _port(arch, params=p0)
    state = load_jax_opt_state(model, s0)
    assert int(state.count) == 1 and float(sum(v.abs().sum() for v in state.v.values())) > 0
    step = make_train_step(model, TrainConfig(**TCFG))
    for i in range(1, n + 1):
        model, state, metrics = step(model, state, device_batch(_batch(arch, i), "cpu"))
        want = jmetrics[i - 1]
        assert set(metrics) == set(want) == {"loss", "grad_norm", "lr", "nll", "aux"}
        for k in want:
            assert metrics[k].dim() == 0 and not metrics[k].requires_grad
            _close(metrics[k], want[k], MODEL_TOL)
    _check_state(model, state, p1, s1)


def test_microbatched_train_step_equals_jax():
    arch = "granite-moe"
    states, jmetrics = _jax_trajectory(arch, microbatch=2, n=1)
    (p0, s0), (p1, s1) = states
    model = _port(arch, params=p0)
    state = load_jax_opt_state(model, s0)
    step = make_train_step(model, TrainConfig(**TCFG, microbatch=2))
    model, state, metrics = step(model, state, device_batch(_batch(arch, 1), "cpu"))
    assert set(metrics) == set(jmetrics[0]) == {"loss", "grad_norm", "lr"}
    for k in metrics:
        _close(metrics[k], jmetrics[0][k], MODEL_TOL)
    _check_state(model, state, p1, s1)


def test_load_jax_opt_state_checks_the_tree():
    jmodel, jparams = _jax("yi")
    state = jax.tree.map(np.asarray, jadamw.adamw_init(jparams))
    model = _port("yi")
    got = load_jax_opt_state(model, state)
    assert list(got.m) == [n for n, _ in model.named_parameters()]
    bad_m = dict(state.m)
    del bad_m["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_opt_state(model, state._replace(m=bad_m))
    bad_v = jax.tree.map(lambda x: x, state.v)
    bad_v["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_opt_state(model, state._replace(v=bad_v))


# ---------------------------------------------------------------------------
# the trained router must not route on stale tables
# ---------------------------------------------------------------------------


def test_trained_router_refuses_stale_tables_until_packed_again():
    arch = "granite-moe"
    model = _port(arch)
    batch = device_batch(_batch(arch), "cpu")
    before = [r.packed.threshold.clone() for r in model.tree_routers()]
    step = make_train_step(model, TrainConfig(**TCFG))
    model, _, _ = step(model, adamw.adamw_init(model), batch)
    thr = [layer.moe.router_thr.detach().clone() for layer in model.layers]
    assert all(not torch.equal(t, b[: t.numel()]) for t, b in zip(thr, before))   # training moved them
    assert all(r.stale for r in model.tree_routers())
    with torch.no_grad(), pytest.raises(RuntimeError, match="pack_routers"):
        model(batch, serve_hard_tree=True)
    with pytest.raises(RuntimeError, match="stale"):
        ServeEngine(model, max_batch=2, max_len=24)
    model.pack_routers()
    routes = []
    hooks = [r.register_forward_hook(lambda mod, args, out: routes.append((args, out)))
             for r in model.tree_routers()]
    with torch.no_grad():
        model(batch, serve_hard_tree=True)
    for h in hooks:
        h.remove()
    assert len(routes) == model.cfg.n_layers
    for layer, (args, out) in zip(model.layers, routes):
        fresh = moel.pack_router(model.cfg, layer.moe.router_thr.detach().clone())
        want = moel.hard_tree_route({"router_proj": args[1]}, args[0], cfg=model.cfg,
                                    e_pad=moel.padded_experts(model.cfg.moe), packed=fresh)
        assert torch.equal(out, want)
    ServeEngine(model, max_batch=2, max_len=24)              # packed again: accepted


def test_working_copy_shares_the_pack_and_sees_a_later_step():
    """A working copy made before a step routes on the master's tables: a
    later step makes it stale too, and one pack of the master serves both."""
    arch = "granite-moe"
    model = _port(arch)
    work = model.cast_for_compute()
    assert not any(r.stale for r in work.tree_routers())
    step = make_train_step(model, TrainConfig(**TCFG))
    step(model, adamw.adamw_init(model), device_batch(_batch(arch), "cpu"))
    assert all(r.stale for r in work.tree_routers())
    model.pack_routers()
    assert not any(r.stale for r in model.tree_routers())


# ---------------------------------------------------------------------------
# the data pipeline and the shape cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe", "qwen2-vl", "whisper"])     # LM, VLM, enc-dec
@pytest.mark.parametrize("markov", [True, False])
def test_pipeline_bit_identical_to_jax(arch, markov):
    jpipe = jpipeline.pipeline_for(jreg.get_smoke_config(arch), JShape("s", 24, 4, "train"), seed=5,
                                   markov=markov)
    pipe = pipeline.pipeline_for(registry.get_smoke_config(arch), ShapeConfig("s", 24, 4, "train"), seed=5,
                                 markov=markov)
    assert type(pipe).__name__ == type(jpipe).__name__
    for step in (0, 1, 17):
        want, got = jpipe(step), pipe(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (k, step)
        for k, v in jpipe.shard(step, rank=1, world=2).items():
            assert np.array_equal(pipe.shard(step, rank=1, world=2)[k], v)


def test_shapes_equal_jax():
    assert shapes.SHAPE_ORDER == jshapes.SHAPE_ORDER
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for arch in registry.ARCH_IDS:
        got = [(dataclasses.astuple(s), ok, why) for s, ok, why in shapes.cells_for(registry.get_config(arch))]
        want = [(dataclasses.astuple(s), ok, why) for s, ok, why in jshapes.cells_for(jreg.get_config(arch))]
        assert got == want, arch


def test_loss_of_the_padded_vocabulary_is_log_vocab():
    """A hot padded tail changes nothing: uniform logits over the real
    vocabulary give log(V), as in the JAX test."""
    logits = torch.zeros(2, 4, 16)
    logits[..., 12:] = 100.0
    nll, _ = losses.softmax_xent(logits, torch.zeros(2, 4, dtype=torch.int32), vocab_size=12)
    assert abs(float(nll) - math.log(12)) < 1e-6
