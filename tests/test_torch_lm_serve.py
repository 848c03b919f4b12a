"""The port's LM ``ServeEngine`` against the JAX package's, on the CPU.

At temperature 0 both engines serve the same requests with the same
weights (carried across with ``load_jax_params``): the same tokens for
every request and the same wave, step and idle-slot counts.  One test pins
an inherited quirk in both packages: sampling reads the padded vocabulary,
so an engine can emit an id ≥ ``vocab_size``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models.api import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve as cli
from repro_torch.models import build_model, load_jax_params
from repro_torch.serve import Request, ServeEngine


def _pair(jcfg, cfg, seed: int = 0):
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    model = load_jax_params(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model


def _requests(cls, vocab: int, lens=(8, 8, 6, 8, 5), new=(5, 3, 6, 1, 4), seed: int = 1):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=k)
            for i, (n, k) in enumerate(zip(lens, new))]


@pytest.mark.parametrize("arch", ["granite-moe", "yi"])
@pytest.mark.parametrize("pad_to", [8, None])
def test_greedy_engine_equals_jax(arch, pad_to):
    """Five requests in waves of two (the last wave one request short of a
    full batch); prompts left-padded to the wave's width, budgets of 1–6
    tokens so that finished requests ride their wave."""
    jmodel, jparams, model = _pair(jreg.get_smoke_config(arch), registry.get_smoke_config(arch))
    jeng = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=16)
    eng = ServeEngine(model, max_batch=2, max_len=16)
    vocab = model.cfg.vocab_size
    jreqs, reqs = _requests(JaxRequest, vocab), _requests(Request, vocab)
    jeng.run(jreqs, pad_to=pad_to)
    eng.run(reqs, pad_to=pad_to)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in reqs)
    for stat in ("waves", "decode_steps", "idle_token_slots"):
        assert getattr(eng.stats, stat) == getattr(jeng.stats, stat), stat
    assert (eng.stats.waves, eng.stats.decode_steps) == (3, 4 + 5 + 3)
    assert eng.stats.idle_token_slots > 0
    snap = eng.obs.snapshot()
    assert {"serve.lm.waves", "serve.lm.prefill_s", "serve.lm.decode_s", "serve.lm.decode_steps",
            "serve.lm.idle_token_slots"} <= set(snap["counters"])


def test_sampling_reads_the_padded_vocabulary_in_both_packages():
    """Inherited, not a port fault: ``_sample`` takes argmax over all v_pad
    logit columns.  With a vocabulary of 500 (padded to 512) and the output
    column of id 505 made dominant, both engines emit 505 ≥ vocab_size."""
    fields = dict(name="pad", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=64, vocab_size=500, dtype="float32")
    jmodel = jax_build_model(JaxModelConfig(**fields))
    jparams = jmodel.init(jax.random.key(0))
    assert jmodel.v_pad == 512
    jparams["lm_head"]["w"] = jparams["lm_head"]["w"].at[:, 505].set(10.0)
    model = load_jax_params(build_model(ModelConfig(**fields), device="cpu"), jax.tree.map(np.asarray, jparams))
    assert model.v_pad == 512
    jreqs, reqs = _requests(JaxRequest, 500, new=(3,) * 5), _requests(Request, 500, new=(3,) * 5)
    JaxServeEngine(jmodel, jparams, max_batch=2, max_len=16).run(jreqs, pad_to=8)
    ServeEngine(model, max_batch=2, max_len=16).run(reqs, pad_to=8)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert any(t >= 500 for r in reqs for t in r.out_tokens)


def test_temperature_sampling_is_seeded():
    model = build_model(registry.get_smoke_config("granite-moe"), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        reqs = _requests(Request, 512)
        ServeEngine(model, max_batch=2, max_len=16, temperature=1.0, seed=7).run(reqs, pad_to=8)
        runs.append([r.out_tokens for r in reqs])
    assert runs[0] == runs[1]
    assert all(0 <= t < model.v_pad for toks in runs[0] for t in toks)


def test_engine_refuses_a_model_whose_router_is_not_packed():
    model = build_model(registry.get_smoke_config("granite-moe"), device="cpu")
    with pytest.raises(RuntimeError, match="not packed"):
        ServeEngine(model, max_batch=2, max_len=16)
    model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, max_batch=2, max_len=16)
    assert eng.model.layers[0].attn.wq.dtype == torch.float32      # smoke configs compute in f32
    assert eng.model.tree_routers()[0].packed is model.tree_routers()[0].packed


def test_serve_cli_runs_in_process(capsys):
    reqs = cli.main(["--arch", "granite-moe", "--smoke", "--device", "cpu", "--requests", "3",
                     "--new-tokens", "4", "--prompt-len", "8", "--max-batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("serving granite-moe-smoke:") and "tree-routed MoE" in out[0]
    assert out[1].startswith("3 requests, 12 tokens in") and "(2 waves;" in out[1]
    assert len(out) == 2 + 3
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    cli.main(["--arch", "yi", "--smoke", "--device", "cpu", "--requests", "1", "--new-tokens", "2"])
    assert "tree-routed" not in capsys.readouterr().out
    with pytest.raises(SystemExit, match="embeddings"):
        cli.main(["--arch", "qwen2-vl", "--smoke", "--device", "cpu"])
