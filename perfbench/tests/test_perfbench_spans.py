"""The program spans' aggregation (``perfbench/spans.py``) and its readers."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, spans, trace_reader

ROOT = Path(__file__).resolve().parents[2]
MICROS = ("dispatch_host_us", "launch_host_us", "vote_host_us", "sync_wait_us", "metrics_host_us")
READERS = ("idle_in_program_pct",) + MICROS


def _read(name, t):
    return harness.metric_reader(ROOT, f"{name}.test").read(t)


def _two_tree_calls():
    """Two calls of 100 µs: dispatch 60, kernel wrapper 20, launch 20."""
    host = []
    for t0 in (0.0, 200.0):
        host += [("tune.call", 1, t0, t0 + 100), ("kernel.op", 1, t0 + 20, t0 + 60),
                 ("kernel.launch", 1, t0 + 30, t0 + 50)]
    return host


def test_self_times_and_idle_by_gap_midpoint():
    busy = [(55.0, 190.0), (255.0, 390.0)]
    s = spans.collect(_two_tree_calls(), busy, 0.0, 400.0)
    call, op, launch = (s.by_name[n] for n in ("tune.call", "kernel.op", "kernel.launch"))
    assert (call["count"], call["outer"], op["outer"], launch["outer"]) == (2, 2, 0, 0)
    assert call["total_s"] == pytest.approx(200e-6) and call["self_s"] == pytest.approx(120e-6)
    assert op["self_s"] == pytest.approx(40e-6) and launch["self_s"] == pytest.approx(40e-6)
    # gaps [0, 55] (middle 27.5: in kernel.op, before the launch opens),
    # [190, 255] (222.5: kernel.op again) and [390, 400] (no span: the caller)
    assert op["idle_s"] == pytest.approx(120e-6) and launch["idle_s"] == 0
    assert s.by_name["caller"]["idle_s"] == pytest.approx(10e-6)
    assert s.idle_s == pytest.approx(130e-6) and s.idle_in_program_share() == pytest.approx(12 / 13)
    assert (s.calls, s.call_us()) == (2, pytest.approx(100.0))
    assert s.self_us(("tune.",)) == pytest.approx(60.0)
    assert s.self_us(("kernel.",)) == pytest.approx(40.0)


def test_a_gap_goes_to_the_innermost_span_across_threads():
    host = [("tune.call", 1, 0.0, 100.0), ("kernel.launch", 1, 40.0, 45.0),
            ("cascade.observe", 2, 10.0, 60.0), ("cascade.sync", 2, 20.0, 30.0)]
    s = spans.collect(host, [(0.0, 48.0), (52.0, 100.0)], 0.0, 100.0)
    # one gap, [48, 52]: tune.call on thread 1, cascade.observe (opened
    # later) on thread 2; spans on the other thread do not nest
    assert s.by_name["cascade.observe"]["idle_s"] == pytest.approx(4e-6)
    assert s.by_name["tune.call"]["self_s"] == pytest.approx(95e-6)
    assert s.by_name["cascade.observe"]["outer"] == 1 and s.calls == 2


def _forest_calls():
    """Three cascade calls, every span kind of the forest cell in each."""
    host = []
    for k, t0 in enumerate((0.0, 3000.0, 6100.0)):
        host += [
            ("tune.predict", 1, t0, t0 + 2800 + k),
            ("cascade.eval", 1, t0 + 40, t0 + 1500),
            ("cascade.observe", 1, t0 + 45, t0 + 50),
            ("cascade.stage", 1, t0 + 60, t0 + 400),
            ("kernel.op", 1, t0 + 70, t0 + 120),
            ("kernel.launch", 1, t0 + 90, t0 + 110),
            ("cascade.sync", 1, t0 + 125, t0 + 390),
            ("cascade.compact", 1, t0 + 420, t0 + 700),
            ("cascade.sync", 1, t0 + 600, t0 + 690),
            ("cascade.finish", 1, t0 + 1510, t0 + 2790),
            ("cascade.observe", 1, t0 + 1600, t0 + 2700),
        ]
    return host


def _trace(host, busy, lo, hi):
    found = spans.collect(host, busy, lo, hi)
    return types.SimpleNamespace(busy_s=1e-3, spans=found.by_name, idle_s=found.idle_s)


def test_the_five_micros_sum_to_the_mean_call():
    t = _trace(_forest_calls(), [(100.0, 130.0), (3100.0, 3130.0)], 0.0, 9000.0)
    values = {name: _read(name, t) for name in MICROS}
    assert values["sync_wait_us"] == pytest.approx(355.0)
    assert values["metrics_host_us"] == pytest.approx(1105.0)
    assert values["launch_host_us"] == pytest.approx(50.0)
    assert sum(values.values()) == pytest.approx(2801.0)      # the mean tune.predict
    # gaps [0, 100] and [130, 3100] under the first call's observations,
    # [3130, 9000] after the second call: the caller's
    assert _read("idle_in_program_pct", t) == pytest.approx(100 * (100 + 2970) / (9000 - 60))


def test_the_tree_cell_reads_dispatch_and_launch_only():
    t = _trace(_two_tree_calls(), [(55.0, 190.0)], 0.0, 400.0)
    assert _read("dispatch_host_us", t) + _read("launch_host_us", t) == pytest.approx(100.0)
    assert _read("vote_host_us", t) == _read("sync_wait_us", t) == _read("metrics_host_us", t) == 0


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_device_time_or_program_spans(name):
    bare = trace_reader.TraceData(window_s=1.0, busy_s=0.0, kernel_s=0.0, bound_s=0.0,
                                  records=1, frames=1.0)
    assert _read(name, bare) is None
    # a program without spans (the parent of the tracer's bridge): no call
    assert _read(name, _trace([], [(0.0, 10.0)], 0.0, 100.0)) is None
    # outside the harness, with no session in any calling frame
    assert _read(name, trace_reader.TraceData(1.0, 0.5, 0.1, 0.0, 1, 1.0)) is None


def test_readers_find_the_session_in_the_calling_frame(tmp_path):
    """As the harness calls them: a ``trace_reader.Profiler`` in the caller's
    locals, a ``TraceData`` without spans."""
    from repro_torch.core.tree import breadth_first_encode, random_tree
    from repro_torch.tune import TuneCache, TunedEvaluator

    enc = breadth_first_encode(random_tree(n_attrs=7, n_classes=5, max_depth=6, seed=3))
    ev = TunedEvaluator(enc, cache=TuneCache(tmp_path / "tune.json"), engines=("cuda",), device="cpu")
    rec = torch.from_numpy(np.random.default_rng(1).normal(size=(300, 7)).astype(np.float32))
    ev(rec)
    profiler = trace_reader.Profiler(torch.device("cpu"))
    profiler.start()
    for _ in range(4):
        ev(rec)
    profiler.stop()
    t = trace_reader.TraceData(window_s=1.0, busy_s=1e-9, kernel_s=0.0, bound_s=0.0,
                               records=1200, frames=1.0)
    values = {name: _read(name, t) for name in READERS}
    s = profiler._program_spans
    assert s.calls == 4 and s.by_name["tune.call"]["outer"] == 4
    assert values["dispatch_host_us"] + values["launch_host_us"] == pytest.approx(s.call_us())
    assert values["vote_host_us"] == values["sync_wait_us"] == values["metrics_host_us"] == 0
    assert 0 <= values["idle_in_program_pct"] <= 100


def test_the_ports_hot_path_spans_carry_the_frozen_prefixes():
    src = ROOT / "src" / "repro_torch"
    named = set()
    for path in ("tune/dispatch.py", "tune/measure.py", "kernels/tree_eval/ops.py",
                 "kernels/tree_eval/kernel.py", "core/forest.py", "kernels/tree_eval/cascade.py"):
        named |= set(re.findall(r'\.span\(\s*"([a-z_.]+)"', (src / path).read_text()))
    documented = {"tune.call", "tune.forest_call", "tune.predict", "tune.resolve", "tune.pad",
                  "kernel.op", "kernel.launch", "forest.vote", "cascade.eval", "cascade.stage",
                  "cascade.compact", "cascade.sync", "cascade.observe", "cascade.finish"}
    assert documented <= named
    assert all(spans.is_program_span(n) for n in named)
