"""The port's ``obs`` copies against the JAX package's ``repro.obs``.

The same calls go to both packages' registries and tracers; the snapshot
JSON, the Prometheus text and the Chrome-trace events (timestamps, durations
and thread ids aside) must be equal.  Mirrors the registry, exporter and
tracer parts of ``tests/test_obs.py``.
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.obs import metrics as metrics_mod

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
    """The bridge: every span is also a ``record_function`` of the same name."""
    from torch.profiler import ProfilerActivity, profile

    tr = obs.Tracer(torch_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("cascade.stage", cat="cascade", stage=0):
            torch.ones(4).sum()
    assert "cascade.stage" in {e.key for e in prof.key_averages()}
    assert [e.name for e in tr.events()] == ["cascade.stage"]
    assert obs.Tracer()._annotation_cls is None
