"""The port's ``ForestServeEngine`` and ``AnytimePolicy`` against the JAX package's.

Mirrors the forest half of ``tests/test_serve_retune.py`` and the serve part
of ``tests/test_dist.py``.  The same seeded request stream goes to both
engines on the CPU: every request's classes (majority vote, or per-tree
classes without ``n_classes``), and the engines' ``waves`` / ``records`` /
``chunks``, must be equal (``np.array_equal`` / ``==``), before and after a
background re-tune promotes a forest-bucket winner.  The anytime path
without truncation must give the JAX engine's classes and confidences; with
a deadline that stops every wave after its first stage, the two engines cut
the cascade at the same stage.  Inputs are normal draws: no subnormals.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro import core as jcore
from repro import serve as jserve
from repro.tune import TuneCache as JaxTuneCache
from repro_torch import obs
from repro_torch.core import EncodedForest, eval_serial, majority_vote
from repro_torch.kernels.tree_eval import FOREST_VARIANTS, PER_TREE_FAMILY
from repro_torch.serve import AnytimePolicy, ForestServeEngine, RetunePolicy, TreeRequest
from repro_torch.tune import TuneCache

ENGINES = ("cuda", "torch")   # the kernels' plain versions on CPU tensors, and the torch evaluators


def _forests(n_trees=8, n_attrs=9, depth=lambda i: 2 + (i % 5)):
    trees = [jcore.breadth_first_encode(jcore.random_tree(n_attrs=n_attrs, n_classes=6,
                                                          max_depth=depth(i), seed=i))
             for i in range(n_trees)]
    jf = jcore.EncodedForest(trees)
    return jf, EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def _stream(n, a, seed, lo=1, hi=200):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(lo, hi)), a)).astype(np.float32) for _ in range(n)]


def _host_vote(forest, rec, n_classes=6):
    per = np.stack([eval_serial(forest.tree(i), rec) for i in range(forest.n_trees)])
    return majority_vote(per, n_classes, device="cpu").numpy()


def _run_both(eng, jeng, stream):
    reqs = [TreeRequest(uid=i, records=r) for i, r in enumerate(stream)]
    jreqs = [jserve.TreeRequest(uid=i, records=r) for i, r in enumerate(stream)]
    eng.run(reqs)
    jeng.run(jreqs)
    return reqs, jreqs


@pytest.mark.parametrize("n_classes", [6, None])
@pytest.mark.parametrize("devices,decomposition", [(("cpu",), None), (("cpu",) * 4, "hybrid"),
                                                   (("cpu",) * 4, "records")])
def test_forest_engine_requests_equal_jax(tmp_path, n_classes, devices, decomposition):
    jf, pf = _forests()
    kw = dict(max_batch=512, chunk_records=128, n_classes=n_classes, retune=None)
    eng = ForestServeEngine(pf, cache=TuneCache(tmp_path / "c.json"), devices=devices,
                            decomposition=decomposition, **kw)
    jeng = jserve.ForestServeEngine(jf, cache=JaxTuneCache(tmp_path / "j.json"), **kw)
    for round_ in range(2):
        reqs, jreqs = _run_both(eng, jeng, _stream(7, 9, seed=5 + round_))
        for r, jr in zip(reqs, jreqs):
            assert r.done and np.array_equal(r.out, np.asarray(jr.out)), (round_, r.uid)
            if n_classes is not None:
                assert np.array_equal(r.out, _host_vote(pf, r.records)), (round_, r.uid)
    eng.profiler.drain()
    jeng.profiler.drain()
    assert eng.stats.waves == jeng.stats.waves >= 2
    assert eng.stats.records == jeng.stats.records
    assert eng.stats.chunks == jeng.stats.chunks == len(eng.stats.chunk_ms) >= eng.stats.waves
    assert eng.plan.n_devices == len(devices) or decomposition is None
    if decomposition is not None:
        assert eng.plan.decomposition == decomposition


def test_forest_engine_retune_promotes_forest_bucket(tmp_path):
    """The JAX test, on the port: a hot bucket is re-measured in the
    background (all three families on one device) and the winner lands
    under the forest bucket key; traffic before and after is exact and equal
    to the JAX engine's."""
    jf, pf = _forests(3, 9, depth=lambda i: (3, 5, 7)[i])
    cache = TuneCache(tmp_path / "c.json")
    eng = ForestServeEngine(pf, max_batch=128, chunk_records=128, cache=cache, engines=ENGINES, devices=("cpu",),
                            retune=RetunePolicy(hot_waves=2, warmup=1, iters=2))
    jeng = jserve.ForestServeEngine(jf, max_batch=128, chunk_records=128, cache=JaxTuneCache(tmp_path / "j.json"),
                                    retune=None)
    for round_ in range(5):
        stream = [np.random.default_rng(round_).normal(size=(100, 9)).astype(np.float32)]
        reqs, jreqs = _run_both(eng, jeng, stream)
        per = np.stack([eval_serial(pf.tree(i), reqs[0].records) for i in range(pf.n_trees)])
        assert np.array_equal(reqs[0].out, per) and np.array_equal(reqs[0].out, np.asarray(jreqs[0].out)), round_
    eng.retuner.drain(timeout=240)
    assert eng.retuner.errors == [] and eng.stats.retunes >= 1
    key = next(iter(eng.stats.bucket_waves))
    entry = cache.lookup(key)
    assert entry is not None and (entry.variant in FOREST_VARIANTS or entry.variant == PER_TREE_FAMILY)
    assert list(eng.sweeps) == [key] and len(eng.sweeps[key]) > 3
    reqs, jreqs = _run_both(eng, jeng, [np.random.default_rng(77).normal(size=(100, 9)).astype(np.float32)])
    assert np.array_equal(reqs[0].out, np.asarray(jreqs[0].out))
    eng.profiler.drain()
    jeng.profiler.drain()


def test_grid_engine_retune_promotes_the_shard_key(tmp_path):
    """On a grid the engine's re-tune lands under the shard-shape key and the
    next wave's shards resolve it from the cache."""
    jf, pf = _forests(8, 9, depth=lambda i: 5)
    cache = TuneCache(tmp_path / "c.json")
    eng = ForestServeEngine(pf, max_batch=256, chunk_records=256, n_classes=6, cache=cache, engines=ENGINES,
                            devices=("cpu",) * 4, decomposition="hybrid",
                            retune=RetunePolicy(hot_waves=2, warmup=1, iters=2), profile=None)
    for round_ in range(3):
        rec = np.random.default_rng(round_).normal(size=(256, 9)).astype(np.float32)
        eng.run([TreeRequest(uid=0, records=rec)])
        eng.retuner.drain(timeout=240)
    assert eng.retuner.errors == [] and eng.stats.retunes >= 1
    rec = np.random.default_rng(9).normal(size=(256, 9)).astype(np.float32)
    reqs = eng.run([TreeRequest(uid=0, records=rec)])
    assert np.array_equal(reqs[0].out, _host_vote(pf, rec))
    cand, source = eng._eval.resolved
    assert source == "cache" and FOREST_VARIANTS[cand.variant].family == "fused"


@pytest.mark.parametrize("algorithm,jump_mode", [("speculative", "gather"), ("speculative", "onehot"),
                                                 ("data_parallel", "gather")])
def test_anytime_without_truncation_equals_jax(tmp_path, algorithm, jump_mode):
    jf, pf = _forests(9, 9, depth=lambda i: 2 + (i % 6))
    eng = ForestServeEngine(pf, max_batch=512, n_classes=6, cache=TuneCache(tmp_path / "c.json"), devices=("cpu",),
                            anytime=AnytimePolicy(slo_ms=1e9, algorithm=algorithm, jump_mode=jump_mode),
                            retune=None, profile=None)
    jeng = jserve.ForestServeEngine(jf, max_batch=512, n_classes=6, cache=JaxTuneCache(tmp_path / "j.json"),
                                    anytime=jserve.AnytimePolicy(slo_ms=1e9), retune=None, profile=None)
    reqs, jreqs = _run_both(eng, jeng, _stream(9, 9, seed=11, hi=300))
    for r, jr in zip(reqs, jreqs):
        assert np.array_equal(r.out, np.asarray(jr.out)) and np.array_equal(r.out, _host_vote(pf, r.records))
        assert np.array_equal(r.confidence, np.asarray(jr.confidence)), r.uid
        assert r.exit_stage is not None and r.exit_stage.shape == r.out.shape
    assert eng.stats.anytime_waves == jeng.stats.anytime_waves >= 2
    assert eng.stats.anytime_truncations == jeng.stats.anytime_truncations == 0
    assert eng.stats.anytime_stages == jeng.stats.anytime_stages
    assert eng.stats.m_anytime_confidence.count == sum(len(r.out) for r in reqs)


def test_anytime_deadline_cuts_the_cascade_as_jax(tmp_path):
    """``slo_ms=0`` stops every wave after stage 0 in both engines: equal
    classes and confidences, a truncation a wave, and every record that
    cleared the exit bound carries the full majority vote."""
    jf, pf = _forests(9, 9, depth=lambda i: 2 + (i % 6))
    eng = ForestServeEngine(pf, max_batch=512, n_classes=6, cache=TuneCache(tmp_path / "c.json"), devices=("cpu",),
                            anytime=AnytimePolicy(slo_ms=0.0), retune=None, profile=None)
    jeng = jserve.ForestServeEngine(jf, max_batch=512, n_classes=6, cache=JaxTuneCache(tmp_path / "j.json"),
                                    anytime=jserve.AnytimePolicy(slo_ms=0.0), retune=None, profile=None)
    reqs, jreqs = _run_both(eng, jeng, _stream(9, 9, seed=12, hi=300))
    for r, jr in zip(reqs, jreqs):
        assert np.array_equal(r.out, np.asarray(jr.out))
        assert np.array_equal(r.confidence, np.asarray(jr.confidence))
        exited = r.exit_stage >= 0
        assert np.array_equal(r.out[exited], _host_vote(pf, r.records)[exited])
    assert eng.stats.anytime_truncations == jeng.stats.anytime_truncations == eng.stats.waves
    assert set(eng.stats.anytime_stages) == {1}


def test_anytime_needs_classes():
    _, pf = _forests(3)
    with pytest.raises(ValueError, match="n_classes"):
        ForestServeEngine(pf, anytime=AnytimePolicy(slo_ms=1.0), devices=("cpu",))


def test_forest_engine_flight_bundle_and_profiler(tmp_path):
    jf, pf = _forests()
    eng = ForestServeEngine(pf, max_batch=256, chunk_records=64, n_classes=6, cache=TuneCache(tmp_path / "c.json"),
                            devices=("cpu",), retune=None,
                            profile=obs.ProfilePolicy(sample_every=1, sample_records=64, synchronous=True),
                            flight=obs.FlightPolicy(out_dir=str(tmp_path / "flight")), tracer=obs.Tracer())
    eng.run([TreeRequest(uid=i, records=r) for i, r in enumerate(_stream(6, 9, seed=13))])
    bundle = eng.dump_flight("test")
    loaded = json.loads((bundle / "flight.json").read_text())
    assert loaded["engine"] == "forest" and len(loaded["waves"]) == eng.stats.waves
    assert all(w["mode"] == "stream" for w in loaded["waves"])
    counters = obs.snapshot(eng.obs)["counters"]
    assert counters["prof.sampled"] >= 1 and not counters.get("prof.errors")
    spans = {e.name for e in eng.tracer.events()}
    assert {"serve.wave", "stream.eval", "stream.drain", "serve.vote"} <= spans
