"""The port's ``TreeServeEngine`` against the JAX package's.

Mirrors the tree-engine tests of ``tests/test_serve_retune.py`` and the
flight-recorder tests of ``tests/test_obs_perf.py``.  The same seeded
request stream goes to both engines on the CPU: every request's classes,
and the engines' ``waves`` / ``records`` / ``padded_record_slots``, must be
equal (``np.array_equal`` / ``==``), before and after a background re-tune
swaps the winner.  The load-bearing property is the JAX package's: a
re-tune can never change results, even while evaluations run concurrently
with the measurement and the swap.  Inputs are normal draws: no subnormals.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest

from repro import obs as jobs
from repro import serve as jserve
from repro import tune as jtune
from repro.core import breadth_first_encode as jax_encode
from repro.core import paper_tree as jax_paper_tree
from repro.core import random_tree as jax_random_tree
from repro_torch import obs
from repro_torch.core import EncodedTree, eval_serial
from repro_torch.serve import BackgroundRetuner, RetunePolicy, TreeRequest, TreeServeEngine
from repro_torch.tune import Candidate, TuneCache, TunedEvaluator, WorkloadShape

CPU = "cpu:cpu:x1"


def _paper():
    enc = jax_encode(jax_paper_tree())
    return enc, EncodedTree.from_arrays(*enc)


def _records(m, a, seed=0):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32)


def _stream(n, a, seed, lo=1, hi=100):
    """The record batches of a seeded request stream."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(lo, hi)), a)).astype(np.float32) for _ in range(n)]


def _port_requests(stream):
    return [TreeRequest(uid=i, records=r) for i, r in enumerate(stream)]


def _jax_requests(stream):
    return [jserve.TreeRequest(uid=i, records=r) for i, r in enumerate(stream)]


# ---------------------------------------------------------------------------
# One request stream through both engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_batch,seed", [(256, 12), (128, 13), (64, 14)])
def test_engine_outputs_and_stats_equal_jax(tmp_path, max_batch, seed):
    jenc, enc = _paper()
    stream = _stream(12, 19, seed)
    jeng = jserve.TreeServeEngine(jenc, max_batch=max_batch, cache=jtune.TuneCache(tmp_path / "j.json"),
                                  retune=None, profile=None)
    eng = TreeServeEngine(enc, max_batch=max_batch, cache=TuneCache(tmp_path / "p.json"), retune=None,
                          profile=None, device="cpu")
    assert eng.device.type == "cpu"
    jreqs, reqs = jeng.run(_jax_requests(stream)), eng.run(_port_requests(stream))
    for j, r in zip(jreqs, reqs):
        assert r.done and r.out.dtype == np.int32
        assert np.array_equal(r.out, j.out)
        assert np.array_equal(r.out, eval_serial(enc, r.records))
    for stat in ("waves", "records", "padded_record_slots"):
        assert getattr(eng.stats, stat) == getattr(jeng.stats, stat), stat
    assert eng.stats.bucket_waves == jeng.stats.bucket_waves   # one backend tag on both sides
    assert eng.stats.waves >= 2


def test_engines_with_retune_and_profiler_equal_jax(tmp_path):
    jenc, enc = _paper()
    policy = dict(hot_waves=2, warmup=1, iters=2)
    jeng = jserve.TreeServeEngine(jenc, max_batch=128, cache=jtune.TuneCache(tmp_path / "j.json"),
                                  retune=jserve.RetunePolicy(**policy),
                                  profile=jobs.ProfilePolicy(sample_every=1, synchronous=True))
    eng = TreeServeEngine(enc, max_batch=128, cache=TuneCache(tmp_path / "p.json"),
                          retune=RetunePolicy(**policy), profile=obs.ProfilePolicy(sample_every=1, synchronous=True),
                          engines=("cuda", "torch"), device="cpu")
    for round_ in range(4):
        stream = _stream(4, 19, seed=round_, lo=90, hi=101)
        jreqs, reqs = jeng.run(_jax_requests(stream)), eng.run(_port_requests(stream))
        for j, r in zip(jreqs, reqs):
            assert np.array_equal(r.out, j.out), round_
        jeng.retuner.drain(timeout=120)
        eng.retuner.drain(timeout=120)
    assert eng.retuner.errors == [] and eng.stats.retunes >= 1
    for stat in ("waves", "records", "padded_record_slots"):
        assert getattr(eng.stats, stat) == getattr(jeng.stats, stat), stat
    for key in eng.profiler.keys():
        assert eng.profiler.d_mu(key) == jeng.profiler.d_mu(key)
    assert eng.profiler.keys() == jeng.profiler.keys()


# ---------------------------------------------------------------------------
# Hot-bucket promotion
# ---------------------------------------------------------------------------


def test_cold_buckets_never_measure(tmp_path):
    _, enc = _paper()
    eng = TreeServeEngine(enc, max_batch=64, cache=TuneCache(tmp_path / "c.json"),
                          retune=RetunePolicy(hot_waves=100), device="cpu")
    eng.run([TreeRequest(uid=i, records=_records(50, 19, seed=i)) for i in range(5)])
    eng.retuner.drain(timeout=60)
    assert eng.stats.retunes == 0 and len(eng.retuner.started) == 0
    assert len(eng.stats.bucket_waves) == 1


def test_hot_bucket_measured_once_and_promoted(tmp_path):
    _, enc = _paper()
    cache = TuneCache(tmp_path / "c.json")
    eng = TreeServeEngine(enc, max_batch=64, cache=cache, engines=("cuda", "torch"),
                          retune=RetunePolicy(hot_waves=3, warmup=1, iters=2), device="cpu")
    reqs = [TreeRequest(uid=i, records=_records(50, 19, seed=100 + i)) for i in range(10)]
    eng.run(reqs)
    eng.retuner.drain(timeout=120)
    assert eng.retuner.errors == []
    assert eng.stats.retunes == 1 and len(eng.retuner.started) == 1
    key = next(iter(eng.stats.bucket_waves))
    entry = cache.lookup(key)
    cand, src = eng._eval._resolved[key]
    assert src == "retune" and cand == Candidate.make(entry.variant, **entry.params)
    assert {m.candidate.variant for m in eng.sweeps[key]} >= {"cuda_data_parallel", "torch_data_parallel"}
    for r in reqs:
        assert np.array_equal(r.out, eval_serial(enc, r.records))


def test_request_path_not_blocked_by_measurement():
    started, release = threading.Event(), threading.Event()

    def slow_measure(batch):
        started.set()
        assert release.wait(timeout=60)
        return None

    promoted = []
    ret = BackgroundRetuner(slow_measure, lambda k, e: promoted.append(k), RetunePolicy(hot_waves=1))
    batch = _records(8, 4)
    ret.note("bucket", batch)
    assert started.wait(timeout=60)
    t0 = time.perf_counter()
    for _ in range(50):
        ret.note("bucket", batch)
    assert time.perf_counter() - t0 < 1.0
    release.set()
    ret.drain(timeout=60)
    assert promoted == ["bucket"]


def test_failed_measurement_is_counted_and_never_takes_serving_down():
    def broken(batch):
        raise RuntimeError("measurement exploded")

    r = obs.Registry()
    ret = BackgroundRetuner(broken, lambda k, e: None, RetunePolicy(hot_waves=1), registry=r)
    ret.note("bucket", _records(8, 4))
    ret.drain(timeout=60)
    assert ret.retunes == 0
    assert len(ret.errors) == 1 and "exploded" in str(ret.errors[0][1])
    assert obs.snapshot(r)["counters"]["serve.retune.failed"] == 1


def test_drift_forces_a_retune_and_rides_the_flight_ring(tmp_path):
    jenc = jax_encode(jax_random_tree(n_attrs=9, n_classes=5, max_depth=7, seed=6, balance=0.6))
    enc = EncodedTree.from_arrays(*jenc)
    policy = obs.ProfilePolicy(sample_every=1, synchronous=True, drift_window=4, drift_min_samples=2,
                               drift_threshold=0.05)
    eng = TreeServeEngine(enc, max_batch=256, cache=TuneCache(tmp_path / "c.json"),
                          retune=RetunePolicy(hot_waves=1000, warmup=1, iters=1), profile=policy,
                          flight=obs.FlightPolicy(out_dir=str(tmp_path / "fl")), device="cpu")
    for i in range(4):
        eng.run([TreeRequest(uid=i, records=_records(256, 9, seed=i))])
    eng.run([TreeRequest(uid=9, records=_records(256, 9, seed=20) + np.float32(5.0))])
    eng.retuner.drain(timeout=60)
    counters = obs.snapshot(eng.obs)["counters"]
    assert counters["serve.retune.forced"] == 1 and eng.stats.retunes == 1
    assert any(w.get("drift") for w in eng.flight.waves())


# ---------------------------------------------------------------------------
# Atomic winner swap
# ---------------------------------------------------------------------------


def test_promote_swaps_resolution(tmp_path):
    _, enc = _paper()
    ev = TunedEvaluator(enc, cache=TuneCache(tmp_path / "c.json"), device="cpu")
    rec = _records(64, 19, seed=2)
    before, _ = ev.resolve(rec)
    forced = Candidate.make("torch_speculative_gather", jumps_per_round=3)
    assert before != forced
    ev.promote(WorkloadShape.of(rec, enc, ev.depth).key(CPU), forced)
    assert ev.resolve(rec)[0] == forced
    assert np.array_equal(ev(rec).numpy(), eval_serial(enc, rec))


def test_swap_under_concurrent_evaluation_is_bit_identical(tmp_path):
    jenc = jax_encode(jax_random_tree(n_attrs=7, n_classes=5, max_depth=6, seed=9))
    enc = EncodedTree.from_arrays(*jenc)
    ev = TunedEvaluator(enc, cache=TuneCache(tmp_path / "c.json"), device="cpu")
    rec = _records(96, 7, seed=3)
    want = eval_serial(enc, rec)
    key = WorkloadShape.of(rec, enc, ev.depth).key(CPU)
    candidates = [Candidate.make("torch_data_parallel"), Candidate.make("cuda_data_parallel", block_m=32),
                  Candidate.make("torch_speculative_gather", jumps_per_round=2),
                  Candidate.make("cuda_speculative_onehot", block_m=16)]
    stop, failures = threading.Event(), []

    def reader():
        while not stop.is_set():
            out = ev(rec).numpy()
            if not np.array_equal(out, want):
                failures.append(out)
                return

    threads = [threading.Thread(target=reader) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(30):
            ev.promote(key, candidates[i % len(candidates)])
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert failures == []


def test_engine_concurrent_retune_bit_identity(tmp_path):
    _, enc = _paper()
    eng = TreeServeEngine(enc, max_batch=128, cache=TuneCache(tmp_path / "c.json"), engines=("cuda", "torch"),
                          retune=RetunePolicy(hot_waves=2, warmup=1, iters=2), device="cpu")
    for round_ in range(6):
        reqs = [TreeRequest(uid=i, records=_records(100, 19, seed=10 * round_ + i)) for i in range(4)]
        eng.run(reqs)
        for r in reqs:
            assert np.array_equal(r.out, eval_serial(enc, r.records)), round_
    eng.retuner.drain(timeout=120)
    assert eng.retuner.errors == [] and eng.stats.retunes >= 1
    reqs = [TreeRequest(uid=i, records=_records(100, 19, seed=99 + i)) for i in range(3)]
    eng.run(reqs)
    for r in reqs:
        assert np.array_equal(r.out, eval_serial(enc, r.records))


def test_engine_without_a_card_needs_device_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, enc = _paper()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TreeServeEngine(enc, retune=None, profile=None)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def test_flight_ring_breach_and_manual_dump_equal_jax(tmp_path):
    bundles = {}
    for name, mod in (("port", obs), ("jax", jobs)):
        r = mod.Registry()
        pol = mod.FlightPolicy(slo_ms=5.0, capacity=4, out_dir=str(tmp_path / name), min_dump_interval_s=0.0,
                               dump_on_breach=False)
        fr = mod.FlightRecorder(pol, registry=r, engine="unit")
        assert fr.note_wave(latency_ms=1.0, bucket="b") is False
        assert [fr.note_wave(latency_ms=10.0 + i, records=8) for i in range(6)] == [True] * 6
        assert len(fr.waves()) == 4 and all(w["breach"] for w in fr.waves())
        out = fr.dump("manual")
        bundles[name] = json.loads((out / "flight.json").read_text())
        assert json.loads((out / "trace.json").read_text())["traceEvents"] is not None
    port, jax = bundles["port"], bundles["jax"]
    assert port["reason"] == jax["reason"] == "manual"
    assert [{k: v for k, v in w.items() if k != "t"} for w in port["waves"]] == \
        [{k: v for k, v in w.items() if k != "t"} for w in jax["waves"]]
    assert port["metrics"]["counters"] == jax["metrics"]["counters"]
    assert {k: v for k, v in port["policy"].items() if k != "out_dir"} == \
        {k: v for k, v in jax["policy"].items() if k != "out_dir"}


def test_flight_exception_rate_limit_and_drift(tmp_path):
    fr = obs.FlightRecorder(obs.FlightPolicy(out_dir=str(tmp_path / "a"), min_dump_interval_s=0.0), engine="unit")
    fr.note_exception(ValueError("boom"))
    (bundle,) = list((tmp_path / "a").glob("flight-unit-*-exception"))
    assert json.loads((bundle / "flight.json").read_text())["waves"][-1]["message"] == "boom"
    limited = obs.FlightRecorder(obs.FlightPolicy(slo_ms=0.001, out_dir=str(tmp_path / "b"),
                                                  min_dump_interval_s=3600.0), engine="unit")
    for _ in range(5):
        limited.note_wave(latency_ms=100.0)
    assert len(list((tmp_path / "b").glob("flight-unit-*"))) == 1
    quiet = obs.FlightRecorder(obs.FlightPolicy(out_dir=str(tmp_path / "c")), engine="unit")
    quiet.note_drift(bucket="b", distance=0.42, engine="tree")
    assert not (tmp_path / "c").exists() and quiet.waves()[-1]["distance"] == 0.42
    assert obs.FlightPolicy().out_dir.endswith("repro_torch_flight")


def test_serve_engine_slo_breach_produces_loadable_bundle(tmp_path):
    _, enc = _paper()
    r, t = obs.Registry(), obs.Tracer()
    pol = obs.FlightPolicy(slo_ms=1e-6, out_dir=str(tmp_path / "fl"), min_dump_interval_s=0.0)
    eng = TreeServeEngine(enc, max_batch=64, cache=TuneCache(tmp_path / "c.json"), retune=None,
                          registry=r, tracer=t, flight=pol, device="cpu")
    eng.run([TreeRequest(uid=i, records=_records(50, 19, seed=i)) for i in range(3)])
    assert obs.snapshot(r)["counters"]['flight.slo_breaches{engine="tree"}'] > 0
    bundles = sorted((tmp_path / "fl").glob("flight-tree-*-slo_breach"))
    flight = json.loads((bundles[-1] / "flight.json").read_text())
    assert flight["engine"] == "tree" and flight["waves"][-1]["breach"] is True
    events = json.loads((bundles[-1] / "trace.json").read_text())["traceEvents"]
    assert any(ev.get("name") == "serve.wave" for ev in events)
    assert (eng.dump_flight("debug") / "flight.json").exists()
    with pytest.raises(RuntimeError):
        TreeServeEngine(enc, cache=TuneCache(tmp_path / "d.json"), retune=None, device="cpu").dump_flight()
