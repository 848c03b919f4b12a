"""The port's ``obs`` copies against the JAX package's ``repro.obs``.

The same calls go to both packages' registries and tracers; the snapshot
JSON, the Prometheus text and the Chrome-trace events (timestamps, durations
and thread ids aside) must be equal.  Mirrors the registry, exporter and
tracer parts of ``tests/test_obs.py``.  The trajectory store and regression
detector (``obs/perf.py``) get the same payloads and histories in both
packages and must give equal series, records, pools and regressions.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.obs import perf as jax_perf
from repro_torch import obs
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import perf as torch_perf
from repro_torch.obs import trace as trace_mod

HOSTILE = 'cpu:cpu:x1|M64 "quoted" back\\slash\nnewline'


def _populate(pkg):
    """One fixed sequence of calls, as a cascade or a serve engine makes them."""
    r = pkg.Registry()
    r.counter("x.count", "c", ("k",)).labels(k="a").inc(3)
    r.counter("x.count", "c", ("k",)).labels(k="b").inc()
    r.counter("x.esc", "c", ("bucket", "mode")).labels(bucket=HOSTILE, mode="a b").inc(2)
    r.gauge("x.gauge").set(1.5)
    r.gauge("x.gauge").add(0.25)
    h = r.histogram("x.hist", "h", boundaries=(1.0, 10.0))
    h.observe_many([0.5, 5.0, 50.0])
    h.observe(10.0)
    lh = r.histogram("x.lhist", "h", ("stage",), boundaries=pkg.DEFAULT_RATIO_BOUNDARIES)
    lh.labels(stage=0).observe_many(np.linspace(0.0, 1.0, 23))
    lh.labels(stage=1).observe(0.125)
    r.histogram("x.empty")
    r.histogram("x.ms").observe_many(np.array([0.01, 0.3, 7.0, 20000.0]))
    return r


def _trace(pkg):
    tr = pkg.Tracer()
    with tr.span("cascade.eval", cat="cascade", records=5, deadline_ms=None) as sp:
        with tr.span("cascade.stage", cat="cascade", stage=0, survivors=5):
            pass
        tr.instant("marker", b=2, obj=object.__name__)
        tr.counter("prof.d_mu/k", 3.5, series="d_mu")
        sp.set(stages_run=1)
    try:
        with tr.span("failing"):
            raise KeyError("x")
    except KeyError:
        pass
    return tr


def _events(tracer) -> list[dict]:
    doc = json.loads(json.dumps(tracer.chrome_trace()))
    for e in doc["traceEvents"]:
        for key in ("ts", "dur", "pid", "tid"):
            e.pop(key, None)
    return doc["traceEvents"]


# ---------------------------------------------------------------------------
# same calls, same output
# ---------------------------------------------------------------------------


def test_snapshot_json_equals_jax():
    got, want = obs.snapshot(_populate(obs)), jax_obs.snapshot(_populate(jax_obs))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_prometheus_text_equals_jax():
    assert obs.prometheus_text(_populate(obs)) == jax_obs.prometheus_text(_populate(jax_obs))


def test_json_snapshot_file_equals_jax(tmp_path):
    obs.write_json_snapshot(_populate(obs), tmp_path / "port.json")
    jax_obs.write_json_snapshot(_populate(jax_obs), tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_chrome_trace_events_equal_jax(tmp_path):
    got, want = _trace(obs), _trace(jax_obs)
    assert _events(got) == _events(want)
    assert [e._replace(ts_us=0, dur_us=0) for e in got.events()] == \
        [e._replace(ts_us=0, dur_us=0) for e in want.events()]
    got.write_chrome_trace(tmp_path / "trace.json")
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["displayTimeUnit"] == "ms" and len(doc["traceEvents"]) == len(_events(want))


@pytest.mark.parametrize("quantile", [0.0, 0.1, 0.5, 0.95, 0.99, 1.0])
def test_quantiles_equal_jax(quantile):
    def hist(pkg):
        h = pkg.Registry().histogram("q", boundaries=(1.0, 2.0, 4.0, 8.0))
        h.observe_many([0.5, 1.5, 1.5, 3.0, 7.0, 9.0, 100.0])
        return h

    assert hist(obs).quantile(quantile) == hist(jax_obs).quantile(quantile)


def test_port_exports_what_it_copied():
    assert set(obs.__all__) <= set(jax_obs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name


# ---------------------------------------------------------------------------
# the registry (mirrors tests/test_obs.py::TestRegistry)
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    r = obs.Registry()
    c = r.counter("t.count", "a counter")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("t.gauge")
    g.set(3.5)
    assert g.value == 3.5
    h = r.histogram("t.hist", boundaries=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    s = h.state()
    assert s["count"] == 4 and s["bucket_counts"] == [1, 1, 1, 1]
    assert s["min"] == 0.5 and s["max"] == 500.0
    p = h.percentiles()
    assert p["p50"] is not None and p["p50"] <= p["p95"] <= p["p99"]
    with pytest.raises(ValueError, match="ascending"):
        r.histogram("t.bad", boundaries=(2.0, 1.0))
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)


def test_labels_memoise_children():
    r = obs.Registry()
    c = r.counter("t.labelled", "", ("k",))
    assert c.labels(k="a") is c.labels(k="a")
    c.labels(k="a").inc(2)
    c.labels(k="b").inc()
    assert {lv: s.value for lv, s in c.series()} == {("a",): 2, ("b",): 1}
    with pytest.raises(ValueError, match="takes labels"):
        c.labels(j="a")


def test_observe_many_matches_repeated_observe():
    bs = (1.0, 4.0, 16.0)
    vals = [0.1, 1.0, 2.0, 4.5, 16.0, 99.0, 0.0]
    r = obs.Registry()
    one, many = (r.histogram(n, boundaries=bs) for n in ("t.one", "t.many"))
    for v in vals:
        one.observe(v)
    many.observe_many(vals)
    assert one.state() == many.state()
    nonp = r.histogram("t.nonp", boundaries=bs)
    saved = metrics_mod._np
    metrics_mod._np = None
    try:
        nonp.observe_many(vals)
    finally:
        metrics_mod._np = saved
    assert nonp.state() == many.state()
    margins = r.histogram("t.margins", boundaries=bs)      # as the cascade hands them over
    margins.observe_many(torch.tensor([0, 1, 5, 17], dtype=torch.int32).numpy())
    assert margins.state()["bucket_counts"] == [2, 0, 1, 1] and margins.state()["sum"] == 23.0


def test_observe_many_empty_is_noop():
    h = obs.Registry().histogram("t.empty")
    h.observe_many([])
    h.observe_many(np.array([]))
    assert h.state()["count"] == 0


def test_disabled_registry_mutations_are_noops():
    r = obs.Registry(enabled=False)
    c, g, h = r.counter("t.c"), r.gauge("t.g"), r.histogram("t.h")
    c.inc(10)
    g.set(7)
    h.observe(1.0)
    h.observe_many([1.0, 2.0])
    assert c.value == 0 and g.value == 0 and h.state()["count"] == 0
    r.enable()
    c.inc()
    assert c.value == 1


def test_duplicate_registration():
    r = obs.Registry()
    c = r.counter("t.dup", "help", ("k",))
    assert r.counter("t.dup", "help", ("k",)) is c
    with pytest.raises(obs.DuplicateMetricError):
        r.gauge("t.dup")
    with pytest.raises(obs.DuplicateMetricError):
        r.counter("t.dup", "help", ("other",))
    assert r.get("t.dup") is c and r.get("missing") is None


def test_counter_inc_is_thread_safe():
    c = obs.Registry().counter("t.race")
    n_threads, per_thread = 4, 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=lambda: [c.inc() for _ in range(per_thread)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert c.value == n_threads * per_thread


def test_default_registry_swap():
    mine = obs.Registry()
    prev = obs.set_default_registry(mine)
    try:
        assert obs.default_registry() is mine
    finally:
        obs.set_default_registry(prev)
    assert obs.default_registry() is prev


# ---------------------------------------------------------------------------
# the tracer (mirrors tests/test_obs.py::TestTracer)
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_export():
    tr = obs.Tracer()
    with tr.span("outer", a=1):
        with tr.span("inner"):
            pass
    tr.instant("marker", b=2)
    assert [e.name for e in tr.events()] == ["inner", "outer", "marker"]
    evs = {e["name"]: e for e in tr.chrome_trace()["traceEvents"]}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert evs["marker"]["ph"] == "X" and evs["marker"]["dur"] == 0


def test_set_after_exit_and_error_args():
    tr = obs.Tracer()
    with tr.span("late") as sp:
        pass
    sp.set(result=42)
    with pytest.raises(RuntimeError):
        with tr.span("bad"):
            raise RuntimeError
    late, bad = tr.events()
    assert late.args["result"] == 42 and bad.args["error"] == "RuntimeError"


def test_disabled_tracer_records_nothing():
    tr = obs.Tracer(enabled=False)
    with tr.span("x") as sp:
        sp.set(k=1)
    tr.instant("y")
    tr.counter("c", 1.0)
    assert tr.events() == [] and obs.NULL_TRACER.events() == []


def test_ring_buffer_keeps_newest():
    tr = obs.Tracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert [e.name for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.dropped == 6
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        obs.Tracer(capacity=0)


def test_counter_samples_export_as_counter_tracks():
    tr = obs.Tracer()
    tr.counter("prof.d_mu/k", 3.5, series="d_mu")
    tr.counter("prof.d_mu/k", 4.25, series="d_mu")
    with tr.span("x"):
        pass
    doc = tr.chrome_trace()
    cs = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    assert [e["args"]["d_mu"] for e in cs] == [3.5, 4.25]
    assert all("dur" not in e for e in cs)


def test_torch_annotations_reach_the_profiler():
    """The bridge: while a profiler records, every span is also a
    ``record_function`` of the same name."""
    from torch.profiler import ProfilerActivity, profile

    tr = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("cascade.stage", cat="cascade", stage=0):
            torch.ones(4).sum()
    assert "cascade.stage" in {e.key for e in prof.key_averages()}
    assert [e.name for e in tr.events()] == ["cascade.stage"]
    with tr.span("cascade.stage", cat="cascade", stage=1):
        pass
    assert [e.args["stage"] for e in tr.events()] == [0, 1]


def test_disabled_span_is_the_shared_no_op_without_a_profiler():
    off = obs.Tracer(enabled=False)
    for tr in (obs.NULL_TRACER, off):
        assert tr.span("tune.call", cat="tune") is trace_mod._NULL_SPAN
        assert tr.span("cascade.sync", cat="cascade", stage=0, phase="stage") is trace_mod._NULL_SPAN


def test_disabled_span_is_a_profiler_range_alone_while_one_records():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = obs.NULL_TRACER.span("cascade.eval", cat="cascade", records=3)
        assert sp is not trace_mod._NULL_SPAN
        with sp:
            with obs.NULL_TRACER.span("kernel.op", cat="kernel"):
                torch.ones(4).sum()
            sp.set(stages_run=1)
    names = [e.name for e in prof.events() if e.name in ("cascade.eval", "kernel.op")]
    assert sorted(names) == ["cascade.eval", "kernel.op"]
    assert obs.NULL_TRACER.events() == []
    assert obs.NULL_TRACER.span("kernel.op", cat="kernel") is trace_mod._NULL_SPAN


# ---------------------------------------------------------------------------
# the hot path's spans under a profiler session (CPU)
# ---------------------------------------------------------------------------


def _program_spans(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of the program's spans in a profiler session."""
    prefixes = ("tune.", "kernel.", "forest.", "cascade.")
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(prefixes)),
                  key=lambda s: (s[1], -s[2]))


def _parents(spans) -> list[tuple[str, str | None]]:
    """(span, innermost span around it) for each span, in start order."""
    out = []
    for i, (name, a, b) in enumerate(spans):
        around = [s for s in spans[:i] if s[1] <= a and b <= s[2]]
        out.append((name, max(around, key=lambda s: s[1])[0] if around else None))
    return out


def _tree_evaluator(tmp_path):
    from repro_torch.core.tree import breadth_first_encode, random_tree
    from repro_torch.tune import TuneCache, TunedEvaluator

    enc = breadth_first_encode(random_tree(n_attrs=7, n_classes=5, max_depth=6, seed=1))
    return TunedEvaluator(enc, cache=TuneCache(tmp_path / "tune.json"), engines=("cuda",),
                         device="cpu")


def _forest_evaluator(tmp_path):
    from repro_torch.core.forest import EncodedForest
    from repro_torch.core.tree import breadth_first_encode, random_tree
    from repro_torch.tune import ForestTunedEvaluator, TuneCache

    trees = [breadth_first_encode(random_tree(n_attrs=7, n_classes=5, max_depth=5, seed=s))
             for s in range(6)]
    return ForestTunedEvaluator(EncodedForest(trees), cache=TuneCache(tmp_path / "tune.json"),
                                engines=("cuda",), device="cpu")


def _records(m: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).normal(size=(m, 7)).astype(np.float32))


def test_tuned_entry_spans_nest_as_documented(tmp_path):
    """``tune.call`` holds the resolution (first call only), the bucket's
    padding and the kernel wrapper; the launch itself needs the card."""
    from torch.profiler import ProfilerActivity, profile

    ev, rec = _tree_evaluator(tmp_path), _records(300)     # bucket 512: padded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev(rec)
        ev(rec)
    assert _parents(_program_spans(prof)) == [
        ("tune.call", None), ("tune.resolve", "tune.call"), ("tune.pad", "tune.call"),
        ("kernel.op", "tune.call"),
        ("tune.call", None), ("tune.pad", "tune.call"), ("kernel.op", "tune.call")]
    ev(_records(256))                              # a whole bucket: no copy, no pad span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev(_records(256))
    assert [s[0] for s in _program_spans(prof)] == ["tune.call", "kernel.op"]


def test_cascade_predict_spans_nest_as_documented(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tune import Candidate
    from repro_torch.tune.space import backend_tag

    ev, rec = _forest_evaluator(tmp_path), _records(256)
    key = ev.shape_of(rec).classes_key(5, backend_tag(torch.device("cpu")))
    ev.promote(key, Candidate.make("forest_cascade_fused_data_parallel", stages=2, block_m=64))
    ev.predict(rec, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.predict(rec, 5)
    # a stage: survival observed, gather, the stage (kernel wrapper, sync),
    # its latency observed, scatter and exit test (the survivors' read back:
    # not after the last stage, which leaves no tree to exit before), the
    # compaction's time observed
    gather = [("cascade.observe", "cascade.eval"), ("cascade.compact", "cascade.eval"),
              ("cascade.stage", "cascade.eval"), ("kernel.op", "cascade.stage"),
              ("cascade.sync", "cascade.stage"), ("cascade.observe", "cascade.eval"),
              ("cascade.compact", "cascade.eval")]
    first = gather + [("cascade.sync", "cascade.compact"), ("cascade.observe", "cascade.eval")]
    last = gather + [("cascade.observe", "cascade.eval")]
    got = _parents(_program_spans(prof))
    assert got[:2] == [("tune.predict", None), ("cascade.eval", "tune.predict")]
    assert got[2:-2] in (first, first + last)
    assert got[-2:] == [("cascade.finish", "tune.predict"), ("cascade.observe", "cascade.finish")]


def test_majority_predict_spans_nest_as_documented(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.tree_eval.cascade import MAJORITY_FAMILY
    from repro_torch.tune import Candidate
    from repro_torch.tune.space import backend_tag

    ev, rec = _forest_evaluator(tmp_path), _records(256)
    cpu = backend_tag(torch.device("cpu"))
    ev.promote(ev.shape_of(rec).classes_key(5, cpu), Candidate.make(MAJORITY_FAMILY))
    ev.promote(ev.shape_of(rec).key(cpu), Candidate.make("forest_fused_data_parallel", block_m=64))
    ev.predict(rec, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.predict(rec, 5)
    assert _parents(_program_spans(prof)) == [
        ("tune.predict", None), ("tune.forest_call", "tune.predict"),
        ("kernel.op", "tune.forest_call"), ("forest.vote", "tune.predict")]


# ---------------------------------------------------------------------------
# the trajectory store and regression detector (obs/perf.py)
# ---------------------------------------------------------------------------

# environments carrying both packages' key sets, so that both modules'
# ``env_key`` group the same runs: the key is the one deliberate difference
_CARD_ENV = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
             "torch": "2.11.0+cu128", "cuda": "12.8", "pallas_interpret": False, "jax": "0.9.0"}
_HOST_ENV = dict(_CARD_ENV, backend="cpu", device_kind="cpu", cuda=None, pallas_interpret=True)
_ENTRY_SHAPES = (
    {"name": "w"},
    {"workload": "x", "variant": "fused"},
    {"mix": "skew", "mode": "anytime", "mesh": [2, 4]},
    {"name": "shard", "decomposition": "replica"},
    {"name": "f", "stages": 2, "bound": 0.25},
)


def _payload(rng: np.random.Generator, env: dict) -> dict:
    """One bench payload: entries of every naming shape, each under one of
    the median keys (or none: an accuracy-only row), with a dispersion or
    without, a duplicate name now and then, some rows in ``forest_entries``."""
    entries, forest = [], []
    for shape in _ENTRY_SHAPES:
        if rng.random() < 0.2:
            continue                                   # a series absent from this run
        row = dict(shape)
        key = rng.choice(["median_ms", "tuned_ms", "forest_tuned_ms", "measured_ms", "accuracy"])
        row[str(key)] = float(rng.choice([1.0, 2.0, 8.0]) * rng.uniform(0.7, 2.6))
        if rng.random() < 0.5:
            row[str(rng.choice(["mad_ms", "tuned_mad_ms", "forest_tuned_mad_ms"]))] = float(rng.uniform(0.0, 0.5))
        (forest if "stages" in shape else entries).append(row)
    if rng.random() < 0.5:
        entries.append({"name": "w", "median_ms": float(rng.uniform(1.0, 3.0))})
    entries.append({"name": "acc_only", "accuracy": 0.9})
    return {"env": dict(env), "entries": entries, "forest_entries": forest}


def _regressions(found) -> list:
    return [(dataclasses.asdict(r), r.ratio, r.describe()) for r in found]


def test_perf_env_key_is_the_one_difference():
    assert jax_perf.ENV_KEYS == ("backend", "device_kind", "device_count", "pallas_interpret", "jax")
    assert torch_perf.ENV_KEYS == ("backend", "device_kind", "device_count", "torch", "cuda")
    for env in (_CARD_ENV, _HOST_ENV):
        assert (jax_perf.env_key(env) == jax_perf.env_key(_CARD_ENV)) \
            == (torch_perf.env_key(env) == torch_perf.env_key(_CARD_ENV))


@pytest.mark.parametrize("seed", range(6))
def test_perf_history_and_detector_equal_jax(seed, tmp_path):
    """The same payloads appended through both modules into two directories,
    read back, then every detector call on each growing prefix of the
    history, at the default gates and at tighter ones."""
    rng = np.random.default_rng(seed)
    payloads = [_payload(rng, _HOST_ENV if rng.random() < 0.25 else _CARD_ENV) for _ in range(9)]
    for payload in payloads:
        assert torch_perf.extract_series(payload) == jax_perf.extract_series(payload)
    for pkg, sub in ((jax_perf, "jax"), (torch_perf, "torch")):
        for i, payload in enumerate(payloads):
            pkg.append_history(tmp_path / sub, f"bench{seed}", payload, ts=f"2026-01-01T00:00:{i:02d}+00:00",
                               source="test")
        pkg.append_history(tmp_path / sub, "other", payloads[0], ts="2026-01-02T00:00:00+00:00")
    want = jax_perf.load_history(tmp_path / "jax" / f"bench{seed}.jsonl")
    got = torch_perf.load_history(tmp_path / "torch" / f"bench{seed}.jsonl")
    assert got == want and len(got) == len(payloads)
    assert (tmp_path / "torch" / f"bench{seed}.jsonl").read_text() == \
        (tmp_path / "jax" / f"bench{seed}.jsonl").read_text()
    for n in range(len(want) + 1):
        hist = want[:n]
        for window in (2, 5):
            assert torch_perf.baseline_pool(hist, window=window) == jax_perf.baseline_pool(hist, window=window)
            for min_runs in (1, 2, 3):
                assert torch_perf.skipped_series(hist, window=window, min_runs=min_runs) \
                    == jax_perf.skipped_series(hist, window=window, min_runs=min_runs)
        for gates in ({}, {"rel_threshold": 0.1, "k_mad": 1.0}, {"window": 3, "rel_threshold": 0.2}):
            assert _regressions(torch_perf.detect_regressions(hist, bench="b", **gates)) \
                == _regressions(jax_perf.detect_regressions(hist, bench="b", **gates))
    for benches in (None, [f"bench{seed}"], ["missing"]):
        got = torch_perf.check_history_dir(tmp_path / "torch", benches=benches, rel_threshold=0.1, k_mad=1.0)
        want = jax_perf.check_history_dir(tmp_path / "jax", benches=benches, rel_threshold=0.1, k_mad=1.0)
        assert {b: _regressions(r) for b, r in got.items()} == {b: _regressions(r) for b, r in want.items()}


def test_perf_corrupt_history_raises_the_same(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"ok": 1}\n\nnot json at all\n')
    with pytest.raises(ValueError) as jax_err:
        jax_perf.load_history(path)
    with pytest.raises(ValueError) as torch_err:
        torch_perf.load_history(path)
    assert str(torch_err.value) == str(jax_err.value) and "bad.jsonl:3" in str(torch_err.value)


# ---------------------------------------------------------------------------
# pending buffers, folded on read
# ---------------------------------------------------------------------------

FOLD_BOUNDARIES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
FOLD_BATCHES = ([0, 1, 1, 2, 3, 7, 256, 257, 40], [5, 0, 4, 4, 4], [1000, 1, 17], [9, 300, 2])


def _produce(buf: torch.Tensor, values) -> None:
    """Add integer observations to a pending buffer as a kernel does."""
    v = np.asarray(values, np.int64)
    nb = len(FOLD_BOUNDARIES) + 1
    adds = np.bincount(np.searchsorted(FOLD_BOUNDARIES, v, side="left"), minlength=nb)
    buf[:nb] += torch.from_numpy(adds)
    buf[nb] += v.size
    buf[nb + 1] += int(v.sum())
    buf[nb + 2] = min(int(buf[nb + 2]), int(v.min()))
    buf[nb + 3] = max(int(buf[nb + 3]), int(v.max()))


# Each case: the steps between two reads, each step (source, batch index);
# "disabled" runs on a disabled registry, where a histogram hands out no buffer.
FOLD_CASES = {
    "one source": [[("a", 0)]],
    "two sources": [[("a", 0), ("b", 1)]],
    "several folds": [[("a", 0)], [("a", 1), ("b", 2)], [], [("b", 3), ("a", 1)]],
    "with observe_many": [[("a", 0), (None, 2)], [("b", 1)]],
    "disabled": [[("a", 0), ("b", 1)]],
}
FOLD_READS = {
    "count": lambda h, reg: h.count,
    "sum": lambda h, reg: h.sum,
    "min_max": lambda h, reg: (h.state()["min"], h.state()["max"]),
    "bucket_counts": lambda h, reg: h.state()["bucket_counts"],
    "quantiles": lambda h, reg: [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0)],
    "percentiles": lambda h, reg: h.percentiles(),
    "state": lambda h, reg: h.state(),
    "snapshot": lambda h, reg: obs.snapshot(reg),
    "prometheus": lambda h, reg: obs.prometheus_text(reg),
}


@pytest.mark.parametrize("read", sorted(FOLD_READS))
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_pending_buffers_read_as_observe_many(case, read):
    """A histogram fed through pending buffers reads, by every read path and
    after every step, what ``observe_many`` of the same values gives."""
    enabled = case != "disabled"
    reg, ref_reg = obs.Registry(enabled=enabled), obs.Registry(enabled=enabled)
    h = reg.histogram("t.margin", "m", boundaries=FOLD_BOUNDARIES)
    ref = ref_reg.histogram("t.margin", "m", boundaries=FOLD_BOUNDARIES)
    made = []

    def make(init):
        made.append(torch.tensor(init, dtype=torch.int64))
        return made[-1]

    fn = FOLD_READS[read]
    for steps in FOLD_CASES[case]:
        for source, i in steps:
            if source is None:
                h.observe_many(FOLD_BATCHES[i])
            else:
                buf = h.pending(source, make)
                assert (buf is None) == (not enabled)
                if buf is not None:
                    assert buf is h.pending(source, make)
                    _produce(buf, FOLD_BATCHES[i])
            ref.observe_many(FOLD_BATCHES[i])
        assert fn(h, reg) == fn(ref, ref_reg), (case, read)
        assert fn(h, reg) == fn(ref, ref_reg), (case, read, "read twice")
    assert len(made) == len({s for steps in FOLD_CASES[case] for s, _ in steps if s}) * enabled
    assert h.state() == ref.state()
