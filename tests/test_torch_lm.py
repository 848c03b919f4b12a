"""The port's decoder LM against the JAX package's, on the CPU.

Smoke configs of granite-moe (tree router, 5 experts top-3), phi3.5-moe
(tree router, 4 experts top-2) and yi (dense): the JAX model's parameters
are carried across with ``load_jax_params``, and ``forward``, ``prefill``
(logits and cache) and ``decode_step`` agree within the tolerance below.
The full configs of all ten architectures are checked by arithmetic only
(nothing allocated); the hybrid, xLSTM and encoder-decoder families are
held against JAX in ``test_torch_lm_families*.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro.models.schema import param_count as jax_param_count
from repro_torch.configs import registry
from repro_torch.models import build_model, load_jax_params
from repro_torch.models import schema as sch
from repro_torch.models.layers import moe as moel

ARCHS = ["granite-moe", "phi3.5-moe", "yi"]
# f32 on both sides; two layers of dots summed in different orders move the
# logits (magnitude up to ~4) by a few ulps: measured max 3.7e-6 (yi), 1.5e-6
# (granite-moe, phi3.5-moe) on the CPU.
RTOL = ATOL = 1e-4
# A router input closer than this to its threshold could route differently
# in the two packages (z is summed in another order): the tests report the
# smallest margin and fail with it rather than pass on luck (measured: 7.2e-4
# for granite-moe, 4.2e-3 for phi3.5-moe).
Z_TIE = 1e-5


def _models(arch: str, seed: int = 2):
    jcfg = jreg.get_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    model = build_model(registry.get_smoke_config(arch), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return model, jmodel, jparams


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _router_margin(model, batch) -> float:
    """Smallest |z − threshold| over every router input of a hard forward."""
    margins = []

    def hook(mod, args, out):
        z = moel.router_features(args[0], args[1]).reshape(-1, args[1].shape[1])
        thr = mod.packed.threshold[: z.shape[1]]
        margins.append(float((z - thr).abs().min()))

    handles = [r.register_forward_hook(hook) for r in model.tree_routers()]
    try:
        with torch.no_grad():
            model(batch, serve_hard_tree=True)
    finally:
        for h in handles:
            h.remove()
    return min(margins) if margins else float("inf")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_jax(arch):
    model, jmodel, jparams = _models(arch)
    cfg = model.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    hard = cfg.moe is not None and cfg.moe.router == "tree"
    if hard:
        margin = _router_margin(model, batch)
        assert margin > Z_TIE, f"a router input lies {margin:.3g} from its threshold: a near tie"

    with torch.no_grad():
        logits, aux = model(batch, serve_hard_tree=hard)
    jlogits, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, serve_hard_tree=hard)
    assert logits.shape == (2, 17, model.v_pad) == jlogits.shape
    _close(logits, jlogits)
    _close(aux, jaux)
    if cfg.moe is not None:      # the soft (training) routing of the same layers
        with torch.no_grad():
            soft, soft_aux = model(batch)
        jsoft, jsoft_aux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
        _close(soft, jsoft)
        _close(soft_aux, jsoft_aux)

    lp, cache = model.prefill({"tokens": batch["tokens"][:, :16]}, max_len=24)
    jlp, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :16])}, max_len=24)
    _close(lp, jlp)
    assert cache.pos == int(jcache.pos) == 16
    assert cache.kv.k.shape == jcache.kv.k.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim_)
    _close(cache.kv.k, jcache.kv.k)
    _close(cache.kv.v, jcache.kv.v)

    ld, cache = model.decode_step(cache, {"tokens": batch["tokens"][:, 16:17]})
    jld, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(toks[:, 16:17])})
    _close(ld, jld)
    assert cache.pos == int(jcache.pos) == 17
    _close(cache.kv.k, jcache.kv.k)
    # prefill → decode equals the teacher-forced forward (the JAX smoke test's check)
    _close(ld[:, 0], logits[:, 16])


def test_vlm_forward_with_mrope_streams_equals_jax():
    model, jmodel, jparams = _models("qwen2-vl")
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(2, 9, model.cfg.d_model)).astype(np.float32) * 0.02
    streams = rng.integers(0, 64, size=(2, 3, 9)).astype(np.int32)
    with torch.no_grad():
        logits, _ = model({"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(streams)})
    jlogits, _ = jmodel.forward(jparams, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(streams)})
    _close(logits, jlogits)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_full_config_counts_equal_jax(arch):
    """n_params / active_params for all ten, and the schema's param_count
    (and the meta-built module's) for every family; no allocation."""
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.active_params() == jcfg.active_params()
    model = build_model(cfg, device="meta")
    count = sch.param_count(model.schema())
    assert count == jax_param_count(jax_build_model(jcfg).schema())
    assert count == sum(p.numel() for p in model.parameters())
    # the schema pads the vocabulary (to a multiple of 128); n_params does not.
    # For the hybrid, xLSTM and encoder-decoder families n_params is the
    # reference's own approximation (it leaves out the SSM's conv and dt
    # biases, counts an sLSTM layer as an mLSTM one, and has no decoder
    # positions or cross-attention), so only the schema counts are equal.
    pad = (model.v_pad - cfg.vocab_size) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "moe", "vlm"):
        assert count - pad == cfg.n_params()


def test_granite_full_width_numbers():
    cfg = registry.get_config("granite-moe-3b-a800m")
    model = build_model(cfg, device="meta")
    assert cfg.n_params() == 3_375_428_064
    assert model.v_pad == 49_280
    assert (cfg.moe.tree_depth(), moel.padded_experts(cfg.moe)) == (6, 40)
    assert moel._capacity(512, cfg.moe, 40) == 128 and moel._capacity(4, cfg.moe, 40) == 4


@pytest.mark.parametrize("arch,cls", [("hymba", "DecoderModel"), ("whisper", "EncDecModel"),
                                      ("xlstm", "XLSTMModel")])
def test_build_model_builds_the_new_families_on_meta(arch, cls):
    """The families the port now builds: the JAX factory's class, on
    ``meta`` (nothing allocated), with the JAX schema's parameter count."""
    cfg = registry.get_config(arch)
    model = build_model(cfg, device="meta")
    assert type(model).__name__ == type(jax_build_model(jreg.get_config(arch))).__name__ == cls
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sch.param_count(model.schema()) == jax_param_count(jax_build_model(jreg.get_config(arch)).schema())


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("granite-moe", "hymba", "whisper", "xlstm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(registry.get_smoke_config(arch))
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-moe", "--smoke"])


def test_load_jax_params_checks_every_leaf():
    model, jmodel, jparams = _models("granite-moe")
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_jax_params(model, bad)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, {k: v for k, v in tree.items() if k != "lm_head"})
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_params(model, dict(tree, extra={"w": np.ones(2, np.float32)}))
    # a stacked leaf goes layer by layer into the ModuleList
    proj = tree["layers"]["moe"]["router_proj"]
    for i, layer in enumerate(model.layers):
        assert np.array_equal(layer.moe.router_proj.detach().numpy(), proj[i])
        assert np.array_equal(model.state_dict()[f"layers.{i}.moe.router_proj"].numpy(), proj[i])


def test_working_copy_casts_once_and_computes_the_same():
    """bf16 activations: the master (cast where each weight is used, as JAX
    casts inside every call) and the working copy (cast once) give identical
    logits; f32-by-design leaves and the packed routers are shared."""
    _, _, jparams = _models("granite-moe")
    cfg = dataclasses.replace(registry.get_smoke_config("granite-moe"), dtype="bfloat16")
    model = load_jax_params(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    work = model.cast_for_compute()
    assert work.layers[0].attn.wq.dtype == torch.bfloat16 and model.layers[0].attn.wq.dtype == torch.float32
    assert work.layers[0].moe.router_proj.data_ptr() == model.layers[0].moe.router_proj.data_ptr()
    assert work.layers[1].ln2.scale.data_ptr() == model.layers[1].ln2.scale.data_ptr()
    assert work.tree_routers()[0].packed is model.tree_routers()[0].packed
    f32 = model.cast_for_compute("float32")
    assert f32.cfg.dtype == "float32"
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(f32.parameters(), model.parameters()))

    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(2, 8)).astype(np.int32))
    with torch.no_grad():
        want, _ = model({"tokens": toks}, serve_hard_tree=True)
        got, _ = work({"tokens": toks}, serve_hard_tree=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_init_draws_every_leaf_and_packs_the_routers():
    model = build_model(registry.get_smoke_config("granite-moe"), device="cpu")
    assert all(r.packed is None for r in model.tree_routers())
    model.init(torch.Generator().manual_seed(0))
    assert len(model.tree_routers()) == 2 and all(r.packed is not None for r in model.tree_routers())
    assert torch.equal(model.layers[0].moe.router_thr, torch.zeros(7))     # init "zeros"
    assert torch.equal(model.final_norm.scale, torch.ones(48))              # init "ones"
    again = build_model(registry.get_smoke_config("granite-moe"), device="cpu")
    again.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
    shapes = model.cache_shapes(3, 10)
    assert shapes.kv.k.device.type == "meta" and shapes.kv.k.shape == (2, 3, 10, 2, 12)
