"""The port's SSM, xLSTM, cross-attention and tree-head layers against the
JAX package's, on the CPU, and the behaviours both packages share.

The same numpy inputs, made from fixed seeds, go through each JAX function
and its port, with the JAX parameters as numpy.  Float layers agree within
the tolerance stated at each comparison (f32 throughout; the two packages
sum in different orders).  The tree head's classes agree with
``np.array_equal``: its test uses dyadic inputs (small integers ÷ 8), so
that every ``z = x @ proj`` is exact in any summation order, and thresholds
taken from ``z`` itself, so that some tokens sit exactly on a threshold.

The inherited behaviours (ROADMAP.md §3 items 13–16) are pinned here: the
port equals the JAX package in each, and does not repair it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import schema as jsch
from repro.models.api import build_model as jax_build_model
from repro.models.encdec import EncDecModel as JaxEncDecModel
from repro.models.layers import attention as jattn
from repro.models.layers import ssm as jssm
from repro.models.layers import tree_head as jth
from repro.models.layers import xlstm as jxl
from repro.parallel.sharding import single_device_axes
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import registry
from repro_torch.launch import serve as cli
from repro_torch.models import EncDecModel, build_model, load_jax_params
from repro_torch.models import schema as sch
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import ssm
from repro_torch.models.layers import tree_head as th
from repro_torch.models.layers import xlstm as xl
from repro_torch.serve import Request, ServeEngine

AXES = single_device_axes()
# f32 layers of magnitude ≲ 10: XLA's CPU dots and torch's sum in other
# orders, and their exp/log may differ in the last ulp; measured max
# absolute differences 2.2e-6 (mLSTM), 1.9e-6 (SSM), 4.8e-7 (sLSTM),
# 3.6e-7 (cross-attention), 1.2e-7 (tree-head probabilities).
RTOL = ATOL = 1e-5


def _cfgs(arch: str, **kw):
    cfg, jcfg = registry.get_smoke_config(arch), jreg.get_smoke_config(arch)
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


def _params(schema, seed: int, port_schema) -> tuple[dict, dict]:
    """(JAX params as numpy, the same as torch tensors) for a flat schema."""
    jp = {k: np.asarray(v) for k, v in jsch.init_params(schema, jax.random.key(seed)).items()}
    assert {n: tuple(s.shape) for n, s in sch.leaves(port_schema)} == {k: v.shape for k, v in jp.items()}
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _x(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the SSM (hymba's parallel head)
# ---------------------------------------------------------------------------


def _ssm_params(seed: int = 0):
    cfg, jcfg = _cfgs("hymba")
    jp, tp = _params(jssm.ssm_schema(jcfg, AXES), seed, ssm.ssm_schema(cfg))
    # a nonzero conv bias and dt bias (the schema inits them to zero)
    jp["conv_b"] = _x(seed + 1, *jp["conv_b"].shape, scale=0.1)
    jp["dt_bias"] = _x(seed + 2, *jp["dt_bias"].shape, scale=0.5)
    return cfg, jcfg, jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


@pytest.mark.parametrize("s,chunk", [(24, 256), (32, 8)])     # one chunk; four with the carry
def test_ssm_apply_and_decode_equal_jax(s, chunk):
    cfg, jcfg, jp, tp = _ssm_params()
    x = _x(3, 2, s, cfg.d_model)
    got, state = ssm.ssm_apply(tp, torch.from_numpy(x), cfg=cfg, chunk=chunk, return_state=True)
    _close(got, jssm.ssm_apply(jp, jnp.asarray(x), cfg=jcfg, axes=AXES, chunk=chunk))
    # the returned state is the recurrence's: JAX's decode run token by token
    w, d_in, ns = cfg.ssm.conv_width, 2 * cfg.d_model, cfg.ssm.state_dim
    jstate = jssm.SSMState(conv=jnp.zeros((2, w - 1, d_in)), h=jnp.zeros((2, d_in, ns)))
    for t in range(s):
        jout, jstate = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jstate, cfg=jcfg)
        _close(got[:, t:t + 1], jout)
    _close(state.conv, jstate.conv)
    _close(state.h, jstate.h)
    # and one decode step from it
    x1 = _x(4, 2, 1, cfg.d_model)
    out, new = ssm.ssm_decode(tp, torch.from_numpy(x1), state, cfg=cfg)
    jout, jnew = jssm.ssm_decode(jp, jnp.asarray(x1), jstate, cfg=jcfg)
    _close(out, jout)
    _close(new.conv, jnew.conv)
    _close(new.h, jnew.h)


def test_ssm_scan_chunk_must_divide_the_sequence_in_both_packages():
    """Inherited (ROADMAP.md §3 item 14): a sequence of 300 is not a multiple
    of the 256-step chunk: JAX fails its assert, the port raises; 256 and
    512 run."""
    cfg, jcfg, jp, tp = _ssm_params()
    x = _x(5, 1, 300, cfg.d_model)
    with pytest.raises(AssertionError):
        jssm.ssm_apply(jp, jnp.asarray(x), cfg=jcfg, axes=AXES)
    with pytest.raises(ValueError, match="multiple of the scan's chunk 256"):
        ssm.ssm_apply(tp, torch.from_numpy(x), cfg=cfg)
    for s in (256, 512):
        assert ssm.ssm_apply(tp, torch.from_numpy(x[:, :256].repeat(s // 256, 1)), cfg=cfg).shape == (1, s, 64)
    # and through the whole model: a 300-token hymba forward fails in both
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = load_jax_params(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    toks = np.zeros((1, 300), np.int32)
    with pytest.raises(AssertionError):
        jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError):
        model({"tokens": torch.from_numpy(toks)})


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def _state_close(got, want) -> None:
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s,chunk", [(16, 1024), (24, 16)])    # one chunk; 16 halves to 8, three chunks
def test_mlstm_apply_with_state_and_decode_equal_jax(s, chunk):
    cfg, jcfg = _cfgs("xlstm")
    jp, tp = _params(jxl.mlstm_schema(jcfg, AXES), 0, xl.mlstm_schema(cfg))
    jp["b_if"] = _x(1, *jp["b_if"].shape)        # gates off their zero init
    tp["b_if"] = torch.from_numpy(jp["b_if"])
    x = _x(2, 2, s, cfg.d_model)
    got, state = xl.mlstm_apply(tp, torch.from_numpy(x), cfg=cfg, chunk=chunk, return_state=True)
    want, jstate = jxl.mlstm_apply(jp, jnp.asarray(x), cfg=jcfg, axes=AXES, chunk=chunk, return_state=True)
    _close(got, want)
    _state_close(state, jstate)
    x1 = _x(3, 2, 1, cfg.d_model)
    out, new = xl.mlstm_decode(tp, torch.from_numpy(x1), state, cfg=cfg)
    jout, jnew = jxl.mlstm_decode(jp, jnp.asarray(x1), jstate, cfg=jcfg)
    _close(out, jout)
    _state_close(new, jnew)
    # the init state's stabilizer starts at -1e30, as JAX's init_cache sets it
    st0 = xl.mlstm_init_state(cfg, 2, "cpu")
    assert float(st0.m.max()) == np.float32(-1e30) and float(st0.c.abs().sum()) == 0.0


def test_slstm_apply_with_state_and_decode_equal_jax():
    cfg, jcfg = _cfgs("xlstm")
    jp, tp = _params(jxl.slstm_schema(jcfg, AXES), 0, xl.slstm_schema(cfg))
    jp["b_gates"] = _x(1, *jp["b_gates"].shape)
    tp["b_gates"] = torch.from_numpy(jp["b_gates"])
    x = _x(2, 2, 12, cfg.d_model)
    got, state = xl.slstm_apply(tp, torch.from_numpy(x), cfg=cfg, return_state=True)
    want, jstate = jxl.slstm_apply(jp, jnp.asarray(x), cfg=jcfg, axes=AXES, return_state=True)
    _close(got, want)
    _state_close(state, jstate)
    x1 = _x(3, 2, 1, cfg.d_model)
    out, new = xl.slstm_decode(tp, torch.from_numpy(x1), state, cfg=cfg)
    jout, jnew = jxl.slstm_decode(jp, jnp.asarray(x1), jstate, cfg=jcfg)
    _close(out, jout)
    _state_close(new, jnew)
    st0 = xl.slstm_init_state(cfg, 2, "cpu")
    assert float(st0.m.max()) == np.float32(-1e30)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [24, 1280])     # the direct path; blockwise over 5 KV blocks of 256
def test_cross_attention_equals_jax(frames):
    cfg, jcfg = _cfgs("whisper")
    jp, tp = _params(jattn.attn_schema(jcfg, AXES, cross=True), 0, attn.attn_schema(cfg))
    x, enc = _x(1, 2, 5, cfg.d_model), _x(2, 2, frames, cfg.d_model)
    got = attn.attention(tp, torch.from_numpy(x), cfg=cfg, positions=None, kv_x=torch.from_numpy(enc))
    want = jattn.attention(jp, jnp.asarray(x), cfg=jcfg, positions=None, kv_x=jnp.asarray(enc))
    _close(got, want)
    cross = attn.cross_cache_from_encoder(tp, torch.from_numpy(enc), cfg)
    jcross = jattn.cross_cache_from_encoder(jp, jnp.asarray(enc), jcfg)
    assert cross.k.shape == jcross.k.shape == (2, frames, cfg.n_kv_heads, cfg.head_dim_)
    _close(cross.k, jcross.k)
    _close(cross.v, jcross.v)
    cached = attn.cross_attention_cached(tp, torch.from_numpy(x), cross, cfg=cfg)
    _close(cached, jattn.cross_attention_cached(jp, jnp.asarray(x), jcross, cfg=jcfg))
    _close(cached, got)
    # bidirectional self-attention (the encoder's) on the same path
    enc_self = attn.attention(tp, torch.from_numpy(enc), cfg=cfg, positions=None, causal=False)
    _close(enc_self, jattn.attention(jp, jnp.asarray(enc), cfg=jcfg, positions=None, causal=False))


# ---------------------------------------------------------------------------
# the tree token head
# ---------------------------------------------------------------------------


def _dyadic(seed: int, *shape) -> np.ndarray:
    """Small integers ÷ 8: products and their sums stay exact in f32."""
    return (np.random.default_rng(seed).integers(-4, 5, size=shape) / 8).astype(np.float32)


@pytest.mark.parametrize("classes", [7, 5, 16])    # depth 3 (the paper's 7 classes), 3 (leaves cycle), 4
def test_tree_head_classify_equals_jax_on_dyadic_inputs(classes):
    cfg, jcfg = _cfgs("whisper", tree_head_classes=classes)
    depth = th.tree_head_depth(classes)
    assert depth == jth.tree_head_depth(classes)
    jp, _ = _params(jth.tree_head_schema(jcfg), 0, th.tree_head_schema(cfg))
    x = _dyadic(1, 3, 40, cfg.d_model)
    jp["proj"] = _dyadic(2, *jp["proj"].shape)
    z = x.reshape(-1, cfg.d_model) @ jp["proj"]                    # exact: dyadic
    rows = np.random.default_rng(3).integers(0, z.shape[0], size=z.shape[1])
    jp["thr"] = z[rows, np.arange(z.shape[1])].astype(np.float32)  # some tokens tie
    assert (z == jp["thr"]).any()
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    got = th.tree_head_classify(tp, torch.from_numpy(x), cfg=cfg)
    want = np.asarray(jth.tree_head_classify(jp, jnp.asarray(x), cfg=jcfg))
    assert got.dtype == torch.int32 and got.shape == (3, 40)
    assert np.array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= set(range(classes)) and len(np.unique(want)) > 1
    packed = th.pack_tree_head(cfg, tp["thr"])
    assert (packed.n_nodes, packed.n_attrs, packed.max_depth) == (2 ** (depth + 1) - 1, 2**depth - 1, depth)


def test_tree_head_probs_and_loss_equal_jax():
    cfg, jcfg = _cfgs("whisper", tree_head_classes=7)
    jp, _ = _params(jth.tree_head_schema(jcfg), 0, th.tree_head_schema(cfg))
    jp["thr"] = _x(1, *jp["thr"].shape, scale=0.3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    x = _x(2, 2, 9, cfg.d_model)
    labels = np.random.default_rng(3).integers(0, 7, size=(2, 9)).astype(np.int32)
    labels[0, :3] = -1
    probs = th.tree_head_probs(tp, torch.from_numpy(x), cfg=cfg)
    assert probs.shape == (2, 9, 7)
    _close(probs, jth.tree_head_probs(jp, jnp.asarray(x), cfg=jcfg))
    _close(probs.sum(-1), np.ones((2, 9)))
    loss = th.tree_head_loss(tp, torch.from_numpy(x), torch.from_numpy(labels), cfg=cfg)
    _close(loss, jth.tree_head_loss(jp, jnp.asarray(x), jnp.asarray(labels), cfg=jcfg))


# ---------------------------------------------------------------------------
# inherited behaviours, pinned in both packages
# ---------------------------------------------------------------------------


def _pair(arch: str, seed: int = 2, edit=None, **model_kw):
    jcfg = jreg.get_smoke_config(arch)
    jmodel = (JaxEncDecModel(jcfg, AXES, **model_kw) if model_kw else jax_build_model(jcfg))
    jparams = jmodel.init(jax.random.key(seed))
    if edit is not None:
        jparams = edit(jparams)
    cfg = registry.get_smoke_config(arch)
    model = EncDecModel(cfg, device="cpu", **model_kw) if model_kw else build_model(cfg, device="cpu")
    return jmodel, jparams, load_jax_params(model, jax.tree.map(np.asarray, jparams))


def test_hybrid_prefill_restarts_the_ssm_state_in_both_packages():
    """Inherited (ROADMAP.md §3 item 13): hybrid prefill keeps the SSM's conv
    tail but sets ``h`` to zero, so the first decode step does not continue
    the prompt's scan.  Both packages give the same decode logits (1e-4,
    the model tests' bound), the port's cache holds h = 0, and on weights
    where the SSM carries (almost no decay, a large SSM output) the
    decode logits are far from the teacher-forced forward's: 0.57 with
    logits of magnitude 4.2, against the 2e-2 the JAX smoke test allows."""
    def carry(p):                  # a ≈ -0.0067: almost no decay; dt ≈ 2.1; a 10× SSM output
        ssm_p = dict(p["layers"]["ssm"])
        ssm_p["a_log"] = jnp.full_like(ssm_p["a_log"], -5.0)
        ssm_p["dt_bias"] = jnp.full_like(ssm_p["dt_bias"], 2.0)
        ssm_p["out_proj"] = ssm_p["out_proj"] * 10.0
        return {**p, "layers": {**p["layers"], "ssm": ssm_p}}

    jmodel, jparams, model = _pair("hymba", edit=carry)
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 17)).astype(np.int32)
    jfull, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :16])}, max_len=24)
    assert float(jnp.abs(jcache.ssm.h).max()) == 0.0
    jld, _ = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(toks[:, 16:17])})
    _, cache = model.prefill({"tokens": torch.from_numpy(toks[:, :16])}, max_len=24)
    assert float(cache.ssm.h.abs().max()) == 0.0 and float(cache.ssm.conv.abs().max()) > 0
    ld, _ = model.decode_step(cache, {"tokens": torch.from_numpy(toks[:, 16:17])})
    _close(ld, jld, rtol=1e-4, atol=1e-4)
    gap = float(np.abs(np.asarray(jld[:, 0]) - np.asarray(jfull[:, 16])).max())
    assert gap > 0.2, gap
    # the port's scan does hold the prompt's terminal h: the gap is the reset
    with torch.no_grad():
        h = model.layers[0].ln1(model.embed_table[torch.from_numpy(toks[:, :16]).long()])
        _, st = model.layers[0].ssm(h, return_state=True)
    assert float(st.h.abs().max()) > 0


def test_decoder_positions_clamp_past_the_table_in_both_packages():
    """Inherited (ROADMAP.md §3 item 15): ``_embed_tokens`` takes the learned
    positions with ``lax.dynamic_slice_in_dim``, which clamps a start past
    the table's end; the port clamps alike.  A table of 8 rows and a
    decode at positions 8–11 read row 7, in both packages."""
    jmodel, jparams, model = _pair("whisper", max_positions=8)
    jp = jax.tree.map(jnp.asarray, jparams)
    tok = np.array([[3], [5]], np.int32)
    for pos in (0, 7, 8, 11):
        got = model._embed_tokens(torch.from_numpy(tok), pos)
        _close(got, jmodel._embed_tokens(jp, jnp.asarray(tok), pos))
        if pos >= 7:
            assert torch.equal(got, model._embed_tokens(torch.from_numpy(tok), 7))
    prompt = np.random.default_rng(1).integers(0, 512, size=(2, 6)).astype(np.int32)
    emb = _x(2, 2, model.cfg.encoder.n_frames, model.cfg.d_model, scale=0.02)
    _, cache = model.prefill({"embeds": torch.from_numpy(emb), "tokens": torch.from_numpy(prompt)}, max_len=12)
    _, jcache = jmodel.prefill(jparams, {"embeds": jnp.asarray(emb), "tokens": jnp.asarray(prompt)}, max_len=12)
    for step in range(5):                 # positions 6..10: 8, 9 and 10 clamp
        t = np.full((2, 1), 7 + step, np.int32)
        ld, cache = model.decode_step(cache, {"tokens": torch.from_numpy(t)})
        jld, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(t)})
        _close(ld, jld, rtol=1e-4, atol=1e-4)
    assert cache.pos == int(jcache.pos) == 11


def test_neither_engine_serves_the_encoder_decoder():
    """Inherited (ROADMAP.md §3 item 16): the engines pass only ``tokens``
    to prefill, and the encoder-decoder's reads ``embeds``: both raise
    ``KeyError('embeds')``; the port's launcher refuses ``--arch whisper``."""
    jmodel, jparams, model = _pair("whisper")
    reqs = [Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)]
    jreqs = [JaxRequest(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)]
    with pytest.raises(KeyError, match="embeds"):
        JaxServeEngine(jmodel, jparams, max_batch=1, max_len=8).run(jreqs)
    with pytest.raises(KeyError, match="embeds"):
        ServeEngine(model, max_batch=1, max_len=8).run(reqs)
    with pytest.raises(SystemExit, match="encoder-decoder"):
        cli.main(["--arch", "whisper", "--smoke", "--device", "cpu"])
