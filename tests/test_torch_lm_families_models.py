"""The port's hymba (hybrid), xLSTM and whisper (encoder-decoder) models
against the JAX package's, on the CPU.

Smoke configs in f32: the JAX model's parameters are carried across with
``load_jax_params``, and ``forward``, ``loss`` with its gradients,
``prefill`` and ``decode_step`` agree within the tolerances below; the
served tokens of the two engines are equal.  The full configs build on
``meta`` with the JAX schema's parameter count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipeline
from repro.models.api import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import models
from repro_torch.configs import ParallelConfig, registry
from repro_torch.models import build_model, load_jax_opt_state, load_jax_params
from repro_torch.optim import adamw
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import device_batch

ARCHS = ["hymba", "xlstm", "whisper"]
CLASSES = {"hymba": models.DecoderModel, "xlstm": models.XLSTMModel, "whisper": models.EncDecModel}
# Logits (magnitude ≤ 4.3) of two to four f32 layers summed in another order:
# measured max 1.3e-5 (xlstm), 2.3e-6 (hymba), 5.4e-7 (whisper) on the CPU.
RTOL = ATOL = 1e-4
# Losses and gradients, relative to each leaf's largest magnitude (the
# training tests' measure): measured max 4.8e-6 (xlstm), 2.2e-6 (whisper),
# 1.7e-6 (hymba).
GRAD_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax(arch: str, seed: int = 2):
    jmodel = jax_build_model(jreg.get_smoke_config(arch))
    return jmodel, jmodel.init(jax.random.key(seed))


def _port(arch: str, **parallel):
    _, jparams = _jax(arch)
    model = build_model(registry.get_smoke_config(arch), device="cpu",
                        parallel=ParallelConfig(**parallel) if parallel else None)
    return load_jax_params(model, jax.tree.map(np.asarray, jparams))


def _close(got, want, rtol=RTOL, atol=ATOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _rel_close(got, want, tol: float) -> None:
    """|got − want| ≤ tol · (|want| + max |want|) (the training tests' measure)."""
    got, want = np.asarray(got.detach(), np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * (float(np.abs(want).max()) + 1e-30))


def _jax_leaf(tree, model, name: str):
    """The JAX leaf behind port parameter ``name`` (a stacked one indexed)."""
    node = tree
    for key in model.schema_path(name).split("."):
        node = node[key]
    node = np.asarray(node)
    head, _, rest = name.partition(".")
    return node[int(rest.split(".")[0])] if head in model.stacks else node


def _inputs(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)}
    if cfg.family == "audio":
        out["embeds"] = (rng.normal(size=(2, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_jax(arch):
    jmodel, jparams = _jax(arch)
    model = _port(arch)
    assert type(model) is CLASSES[arch] and model.tree_routers() == []
    cfg = model.cfg
    inp = _inputs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    jbatch = {k: jnp.asarray(v) for k, v in inp.items()}
    with torch.no_grad():
        logits, aux = model(batch)
    jlogits, jaux = jmodel.forward(jparams, jbatch)
    assert logits.shape == (2, 17, model.v_pad) == jlogits.shape
    _close(logits, jlogits)
    _close(aux, jaux)

    prompt = {k: (v[:, :16] if k == "tokens" else v) for k, v in batch.items()}
    jprompt = {k: (v[:, :16] if k == "tokens" else v) for k, v in jbatch.items()}
    lp, cache = model.prefill(prompt, max_len=24)
    jlp, jcache = jmodel.prefill(jparams, jprompt, max_len=24)
    assert lp.shape == (2, 1, model.v_pad)
    _close(lp, jlp)
    assert cache.pos == int(jcache.pos) == 16
    nxt = {"tokens": batch["tokens"][:, 16:17]}
    ld, cache = model.decode_step(cache, nxt)
    jld, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jbatch["tokens"][:, 16:17]})
    _close(ld, jld)
    assert cache.pos == int(jcache.pos) == 17
    # the caches after the step
    if arch == "hymba":
        for mine, theirs in ((cache.kv.k, jcache.kv.k), (cache.ssm.conv, jcache.ssm.conv),
                             (cache.ssm.h, jcache.ssm.h)):
            _close(mine, theirs)
    elif arch == "xlstm":
        assert len(cache.states) == cfg.n_layers
        for mine, theirs in zip(cache.states, jcache.states):
            assert type(mine).__name__ == type(theirs).__name__
            for a, b in zip(mine, theirs):
                _close(a, b)
    else:
        for mine, theirs in ((cache.self_kv.k, jcache.self_kv.k), (cache.cross_kv.v, jcache.cross_kv.v)):
            assert mine.shape == theirs.shape
            _close(mine, theirs)
    # prefill → decode equals the teacher-forced forward (the JAX smoke test's
    # check), except hymba's decode, whose prefill restarts the SSM (ROADMAP §3 item 13)
    _close(lp[:, 0], logits[:, 15])
    if arch != "hymba":
        _close(ld[:, 0], logits[:, 16])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jmodel, jparams = _jax(arch)
    cfg = jreg.get_smoke_config(arch)
    batch = jpipeline.pipeline_for(cfg, JShape("s", 16, 2, "train"), seed=0)(0)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    model = _port(arch)
    named = dict(model.named_parameters())
    loss, aux = model.loss(device_batch(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
    _rel_close(loss, jl, GRAD_TOL)
    _rel_close(aux["nll"], jaux["nll"], GRAD_TOL)
    assert float(aux["aux"].detach()) == float(jaux["aux"]) == 0.0
    for (name, _), g in zip(named.items(), grads):
        _rel_close(g, _jax_leaf(jg, model, name), GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    """none / full / dots: the same loss and gradients bit for bit.  The
    xLSTM and encoder-decoder checkpoint ``"offload"`` as a whole layer, as
    their JAX models do; the hybrid decoder refuses it, as every decoder
    family does (not ported)."""
    batch = device_batch(jpipeline.pipeline_for(jreg.get_smoke_config(arch), JShape("s", 16, 2, "train"),
                                                seed=0)(0), "cpu")
    modes = ("none", "full", "dots") + (() if arch == "hymba" else ("offload",))
    outs = {}
    for mode in modes:
        model = _port(arch, remat=mode)
        loss, _ = model.loss(batch)
        outs[mode] = (loss, torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                                materialize_grads=True))
    if arch == "hymba":
        with pytest.raises(NotImplementedError, match="offload"):
            _port(arch, remat="offload").loss(batch)
    for mode in modes[1:]:
        assert torch.equal(outs[mode][0], outs["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(outs[mode][1], outs["none"][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_decay_mask_and_opt_state_follow_the_jax_tree(arch):
    """The AdamW decay mask is JAX's ``ndim >= 2`` on its own tree: the
    encoder-decoder's stacked norm scales are decayed, the xLSTM's
    unstacked ones are not; a JAX ``AdamWState`` loads leaf for leaf."""
    from repro.optim import adamw as jadamw

    jmodel, jparams = _jax(arch)
    model = _port(arch)
    want = jax.tree.map(lambda a: np.asarray(a).ndim >= 2, jparams)
    got = adamw.default_decay_mask(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, decayed in got.items():
        node = want
        for key in model.schema_path(name).split("."):
            node = node[key]
        assert decayed == node, name
    assert got["final_norm.scale"] is False
    if arch == "whisper":
        assert got["enc_layers.0.ln1.scale"] is True and got["pos_embed"] is True
    if arch == "xlstm":
        assert got["layers.layer_000.ln.scale"] is False and got["layers.layer_003.block.b_gates"] is False
    jstate = jadamw.adamw_init(jparams)
    jstate = jstate._replace(m=jax.tree.map(lambda a: a + 1.0, jstate.m))
    state = load_jax_opt_state(model, jax.tree.map(np.asarray, jstate))
    assert list(state.m) == [n for n, _ in model.named_parameters()]
    assert all(float(t.min()) == 1.0 for t in state.m.values())


@pytest.mark.parametrize("arch", ["hymba", "xlstm"])
@pytest.mark.parametrize("pad_to", [8, None])
def test_greedy_engine_equals_jax(arch, pad_to):
    """Five requests in waves of two, as the decoder families' engine test:
    the same tokens and counters in both packages (hymba's decode includes
    the prefill's SSM restart in both)."""
    jmodel, jparams = _jax(arch)
    model = _port(arch)
    jeng = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=16)
    eng = ServeEngine(model, max_batch=2, max_len=16)
    rng = np.random.default_rng(1)
    lens, new = (8, 8, 6, 8, 5), (5, 3, 6, 1, 4)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(zip(prompts, new))]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=k) for i, (p, k) in enumerate(zip(prompts, new))]
    jeng.run(jreqs, pad_to=pad_to)
    eng.run(reqs, pad_to=pad_to)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    for stat in ("waves", "decode_steps", "idle_token_slots"):
        assert getattr(eng.stats, stat) == getattr(jeng.stats, stat), stat


def test_working_copy_and_cache_shapes():
    """The bf16 working copy shares the f32-by-design leaves (SSM decay,
    xLSTM gate weights and biases, norm scales) and casts the rest once;
    ``cache_shapes`` allocates nothing."""
    for arch, keep, cast in (("hymba", "layers.0.ssm.a_log", "layers.0.ssm.in_proj"),
                             ("xlstm", "layers.layer_000.block.w_if", "layers.layer_000.block.up"),
                             ("whisper", "dec_layers.1.ln_x.scale", "pos_embed")):
        model = _port(arch)
        work = model.cast_for_compute("bfloat16")
        mine, master = dict(work.named_parameters()), dict(model.named_parameters())
        assert mine[keep].data_ptr() == master[keep].data_ptr(), (arch, keep)
        assert mine[cast].dtype == torch.bfloat16 and master[cast].dtype == torch.float32, (arch, cast)
        assert type(work) is type(model) and not any(p.requires_grad for p in work.parameters())
        shapes = model.cache_shapes(3, 10)
        leaves = jax.tree.leaves(jax.tree.map(lambda t: t, tuple(shapes)[:-1]))
        assert leaves and all(t.device.type == "meta" for t in leaves), arch
    assert tuple(_port("whisper").cache_shapes(3, 10).cross_kv.k.shape) == (2, 3, 24, 4, 16)
    assert tuple(_port("hymba").cache_shapes(3, 10).ssm.h.shape) == (3, 3, 128, 4)
