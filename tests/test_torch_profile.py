"""The port's traversal profiler against the JAX package's.

Mirrors ``tests/test_profile.py``: the profiling descent
(``kernels/tree_eval/profile.py``) field for field against the JAX
package's on the same seeded numpy inputs (``np.array_equal``: classes,
exit depths, per-level active fractions — a float32 mean of 0/1 over
M < 2**24, so exact — and node and leaf hits), the drift distance and
measured survival within 1e-12 relative (both sides compute in float64 on
the host), the ``TraversalProfiler`` fed the same wave stream in both
packages, and the measured d_µ reaching the port's tuner.  Inputs are
normal draws: no subnormals (XLA on the CPU flushes them).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import Node as JaxNode
from repro.core import breadth_first_encode as jax_encode
from repro.core import random_tree as jax_random_tree
from repro.core.forest import EncodedForest as JaxForest
from repro.kernels.tree_eval import profile_forest_eval as jax_profile_forest_eval
from repro.kernels.tree_eval import profile_tree_eval as jax_profile_tree_eval
from repro_torch import obs
from repro_torch.core import BOTTOM, EncodedForest, EncodedTree, tree_depth
from repro_torch.core.analysis import (
    level_active_fractions,
    mean_traversal_depth,
    observed_depths,
    speculation_waste_ratio,
)
from repro_torch.kernels.tree_eval import (
    ForestProfile,
    TreeProfile,
    forest_eval_ref,
    profile_forest_eval,
    profile_tree_eval,
    tree_eval_ref,
)
from repro_torch.obs.prof import leaf_drift_distance, survival_from_classes
from repro_torch.serve import BackgroundRetuner, RetunePolicy
from repro_torch.tune import TuneCache, TunedEvaluator, WorkloadShape

from torch_parity import assert_same

CPU = "cpu:cpu:x1"


def _encs(seed=0, max_depth=6, n_attrs=9, n_classes=5, balance=0.7):
    jenc = jax_encode(jax_random_tree(n_attrs=n_attrs, n_classes=n_classes, max_depth=max_depth,
                                      seed=seed, balance=balance))
    return jenc, EncodedTree.from_arrays(*jenc)


def _forests(n_trees=4, **kw):
    jf = JaxForest([_encs(seed=s, **kw)[0] for s in range(n_trees)])
    return jf, EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def _records(m, a, seed=0, shift=0.0):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32) + np.float32(shift)


# ---------------------------------------------------------------------------
# The profiling descent, field for field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,depth,balance,m", [(0, 4, 0.7, 128), (1, 6, 0.7, 256), (2, 9, 0.3, 97),
                                                  (3, 1, 1.0, 1), (4, 0, 1.0, 16)])
def test_tree_profile_equals_jax(seed, depth, balance, m):
    jenc, enc = _encs(seed=seed, max_depth=max(depth, 1), balance=balance)
    if depth == 0:   # a single leaf
        jenc = jax_encode(JaxNode(class_val=2))
        enc = EncodedTree.from_arrays(*jenc)
    rec = _records(m, 9, seed=seed)
    for max_depth in (None, max(tree_depth(enc), 1) + 3):
        got = profile_tree_eval(rec, enc, max_depth=max_depth, device="cpu")
        want = jax_profile_tree_eval(rec, jenc, max_depth=max_depth)
        assert isinstance(got, TreeProfile) and got._fields == want._fields
        for field, g, w in zip(got._fields, got, want):
            assert g.dtype == {"level_active": torch.float32}.get(field, torch.int32), field
            assert_same(g, np.asarray(w), field)
        assert got.d_mu() == want.d_mu()


def test_forest_profile_equals_jax():
    jf, f = _forests(n_trees=5, max_depth=5)
    rec = _records(96, 9, seed=5)
    got = profile_forest_eval(rec, f, device="cpu")
    want = jax_profile_forest_eval(rec, jf)
    assert isinstance(got, ForestProfile)
    for field, g, w in zip(got._fields, got, want):
        assert_same(g, np.asarray(w), field)
    assert got.d_mu() == want.d_mu()
    assert np.array_equal(got.leaf_histogram(), want.leaf_histogram())
    np.testing.assert_allclose(got.mean_level_active(), want.mean_level_active(), rtol=1e-6)
    assert got.leaf_histogram().sum() == f.n_trees * rec.shape[0]


def test_profile_classes_bit_exact_with_ref():
    jf, f = _forests(n_trees=3, max_depth=7)
    rec = _records(200, 9, seed=6)
    prof = profile_forest_eval(torch.from_numpy(rec), f)
    assert prof.classes.device.type == "cpu"
    want = forest_eval_ref(rec, f.attr_idx, f.threshold, f.child, f.class_val, max_depth=f.max_depth,
                           device="cpu")
    assert torch.equal(prof.classes, want)
    enc = f.tree(1)
    got = profile_tree_eval(rec, enc, device="cpu").classes
    assert torch.equal(got, tree_eval_ref(rec, *enc, max_depth=max(tree_depth(enc), 1), device="cpu"))


def test_exit_depth_level_active_and_hit_accounting():
    _, enc = _encs(seed=3)
    rec = _records(150, 9, seed=3)
    prof = profile_tree_eval(rec, enc, device="cpu")
    host = observed_depths(enc, rec)
    assert np.array_equal(prof.exit_depth.numpy(), host)
    assert np.isclose(prof.d_mu(), mean_traversal_depth(host))
    np.testing.assert_allclose(prof.level_active.numpy(),
                               level_active_fractions(host, max(tree_depth(enc), 1)), atol=1e-6)
    assert int(prof.node_hits.sum()) == int(prof.exit_depth.sum())
    assert int(prof.leaf_hits.sum()) == rec.shape[0]
    assert not prof.leaf_hits.numpy()[np.asarray(enc.class_val) == BOTTOM].any()


# ---------------------------------------------------------------------------
# Drift distance and measured survival
# ---------------------------------------------------------------------------


def test_drift_distance_equals_jax():
    rng = np.random.default_rng(7)
    pairs = [([10, 5, 0, 1], [10, 5, 0, 1]), ([1, 0, 0], [0, 0, 1]), ([4, 4], [4, 4, 0]), ([0, 0], [0, 0]),
             ([1, 1], [0, 0])] + [(rng.integers(0, 50, 31), rng.integers(0, 50, int(n))) for n in (31, 17, 40)]
    for p, q in pairs:
        got, want = leaf_drift_distance(p, q), jobs.leaf_drift_distance(p, q)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_survival_equals_jax():
    rng = np.random.default_rng(8)
    cases = [np.zeros((64,), np.int32), np.zeros((1, 64), np.int32), np.zeros((6, 32), np.int32),
             np.stack([np.full((32,), t % 2, np.int32) for t in range(6)])]
    cases += [rng.integers(0, 4, (t, 200)).astype(np.int32) for t in (3, 7, 16)]
    for classes in cases:
        for stages in (2, 3, 4):
            got = survival_from_classes(classes, 4, stages=stages)
            want = jobs.survival_from_classes(classes, 4, stages=stages)
            if want is None:
                assert got is None
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isclose(survival_from_classes(np.zeros((6, 32), np.int32), 4, stages=3), 0.5)


# ---------------------------------------------------------------------------
# The traversal profiler, the JAX package's and the port's on one wave stream
# ---------------------------------------------------------------------------


def _profilers(jenc, enc, policy_kw, **kw):
    port = obs.TraversalProfiler(lambda b: profile_tree_eval(b, enc, device="cpu"),
                                 obs.ProfilePolicy(**policy_kw), n_nodes=int(enc.n_nodes), **kw)
    jax = jobs.TraversalProfiler(lambda b: jax_profile_tree_eval(b, jenc),
                                 jobs.ProfilePolicy(**policy_kw), n_nodes=int(jenc.n_nodes))
    return port, jax


def test_profiler_equals_jax_on_one_wave_stream():
    jenc, enc = _encs(seed=6, max_depth=7, balance=0.6)
    policy = dict(sample_every=2, synchronous=True, drift_window=4, drift_min_samples=2, drift_threshold=0.05)
    events, jevents = [], []
    port, jax = _profilers(jenc, enc, policy, on_drift=lambda k, d, r: events.append((k, d)))
    jax.on_drift = lambda k, d, r: jevents.append((k, d))
    waves = [_records(256, 9, seed=i) for i in range(6)] + [_records(256, 9, seed=10 + i, shift=5.0)
                                                           for i in range(6)]
    for w in waves:
        assert port.note_wave("k", w) == jax.note_wave("k", w)
    got, want = port.profile("k"), jax.profile("k")
    assert got.d_mu == want.d_mu and got.samples == want.samples and got.records == want.records
    np.testing.assert_allclose(got.waste_ratio, want.waste_ratio, rtol=1e-12, atol=0)
    assert np.array_equal(got.level_active, want.level_active)
    assert np.array_equal(got.leaf_hist, want.leaf_hist)
    assert [k for k, _ in events] == [k for k, _ in jevents] and events
    np.testing.assert_allclose([d for _, d in events], [d for _, d in jevents], rtol=1e-12, atol=0)


def test_forest_profiler_survival_equals_jax():
    jf, f = _forests(n_trees=4, max_depth=4)
    kw = dict(n_nodes=int(f.n_nodes), n_classes=5)
    pol = dict(sample_every=1, synchronous=True)
    port = obs.TraversalProfiler(lambda b: profile_forest_eval(b, f, device="cpu"), obs.ProfilePolicy(**pol), **kw)
    jax = jobs.TraversalProfiler(lambda b: jax_profile_forest_eval(b, jf), jobs.ProfilePolicy(**pol), **kw)
    rec = _records(64, 9)
    port.note_wave("fk", rec)
    jax.note_wave("fk", rec)
    np.testing.assert_allclose(port.survival("fk"), jax.survival("fk"), rtol=1e-12, atol=0)
    assert port.d_mu("fk") == jax.d_mu("fk")


def test_sampling_cadence_and_metrics():
    _, enc = _encs(seed=0)
    r = obs.Registry()
    p = obs.TraversalProfiler(lambda b: profile_tree_eval(b, enc, device="cpu"),
                              obs.ProfilePolicy(sample_every=4, synchronous=True), registry=r,
                              n_nodes=int(enc.n_nodes))
    rec = _records(64, 9)
    assert [p.note_wave("k", rec) for _ in range(9)] == [True, False, False, False, True, False, False,
                                                           False, True]
    snap = obs.snapshot(r)
    assert (snap["counters"]["prof.waves"], snap["counters"]["prof.sampled"]) == (9, 3)
    host = mean_traversal_depth(observed_depths(enc, rec))
    assert p.d_mu("k") == host
    assert np.isclose(p.profile("k").waste_ratio, speculation_waste_ratio(enc.n_nodes, host))
    assert snap["histograms"]["prof.exit_depth"]["count"] == 3 * 64
    assert p.keys() == ["k"]


def test_policy_caps_disable_and_errors():
    _, enc = _encs(seed=0)
    fn = lambda b: profile_tree_eval(b, enc, device="cpu")  # noqa: E731
    off = obs.TraversalProfiler(fn, obs.ProfilePolicy(sample_every=0))
    assert off.note_wave("k", _records(32, 9)) is False and off.d_mu("k") is None
    capped = obs.TraversalProfiler(fn, obs.ProfilePolicy(sample_every=1, sample_records=50, synchronous=True))
    capped.note_wave("k", _records(400, 9))
    assert capped.profile("k").records == 50
    r = obs.Registry()

    def boom(batch):
        raise RuntimeError("shadow pass died")

    broken = obs.TraversalProfiler(boom, obs.ProfilePolicy(sample_every=1, synchronous=True), registry=r)
    assert broken.note_wave("k", _records(8, 4)) is True
    assert obs.snapshot(r)["counters"]["prof.errors"] == 1 and broken.profile("k") is None


def test_counter_tracks_and_async_pass():
    _, enc = _encs(seed=0)
    tr = obs.Tracer()
    p = obs.TraversalProfiler(lambda b: profile_tree_eval(b, enc, device="cpu"),
                              obs.ProfilePolicy(sample_every=1, synchronous=True), tracer=tr,
                              n_nodes=int(enc.n_nodes))
    p.note_wave("k", _records(32, 9))
    assert {e.name for e in tr.events() if e.ph == "C"} == {"prof.d_mu/k", "prof.waste/k"}
    a = obs.TraversalProfiler(lambda b: profile_tree_eval(b, enc, device="cpu"), obs.ProfilePolicy(sample_every=1))
    assert a.note_wave("k", _records(64, 9)) is True
    a.drain()
    assert a.d_mu("k") is not None


# ---------------------------------------------------------------------------
# Measured d_µ reaches the tuner
# ---------------------------------------------------------------------------


def _profiled(enc, rec):
    p = obs.TraversalProfiler(lambda b: profile_tree_eval(b, enc, device="cpu"),
                              obs.ProfilePolicy(sample_every=1, synchronous=True), n_nodes=int(enc.n_nodes))
    key = WorkloadShape.of(rec, enc).key(CPU)
    assert p.note_wave(key, rec) is True
    return p, key


def test_measured_d_mu_reaches_the_heuristic(tmp_path):
    _, enc = _encs(seed=0)
    rec = _records(64, 9)
    prof, key = _profiled(enc, rec)
    r = obs.Registry()
    ev = TunedEvaluator(enc, cache=TuneCache(tmp_path / "c.json"), profiler=prof, registry=r, device="cpu")
    out = ev(rec)
    ev(rec)   # the fast path: no second resolution
    assert torch.equal(out, tree_eval_ref(rec, *enc, max_depth=max(tree_depth(enc), 1), device="cpu"))
    snap = obs.snapshot(r)
    assert snap["gauges"]['tune.d_mu{level="tree",source="measured"}'] == prof.d_mu(key)
    assert snap["counters"]['tune.d_mu_provenance{level="tree",source="measured"}'] == 1
    agree = [k for k in snap["counters"] if k.startswith('tune.d_mu_agreement{level="tree"')]
    assert sum(snap["counters"][k] for k in agree) == 1


def test_unprofiled_bucket_falls_back_to_sampled(tmp_path):
    _, enc = _encs(seed=0)
    r = obs.Registry()
    TunedEvaluator(enc, cache=TuneCache(tmp_path / "c.json"), registry=r, device="cpu")(_records(64, 9))
    snap = obs.snapshot(r)
    assert snap["counters"]['tune.d_mu_provenance{level="tree",source="sampled"}'] == 1
    assert 'tune.d_mu{level="tree",source="measured"}' not in snap["gauges"]


def test_autotuned_entry_stamped_with_measured_d_mu(tmp_path):
    _, enc = _encs(seed=0)
    rec = _records(64, 9)
    prof, key = _profiled(enc, rec)
    cache = TuneCache(tmp_path / "c.json")
    TunedEvaluator(enc, cache=cache, autotune=True, profiler=prof, measure_kw={"warmup": 1, "iters": 1},
                   device="cpu")(rec)
    entry = cache.lookup(key)
    assert (entry.d_mu, entry.d_mu_source) == (prof.d_mu(key), "measured")


def test_retuner_force_bypasses_gates_and_dedups():
    release = threading.Event()
    measured = []

    def measure(batch):
        release.wait(5.0)
        measured.append(batch.shape)
        return object()

    r = obs.Registry()
    rt = BackgroundRetuner(measure, lambda key, entry: None, RetunePolicy(hot_waves=1000, max_concurrent=1),
                           registry=r)
    batch = _records(16, 4)
    assert rt.force("bucket", batch) is True
    assert rt.force("bucket", batch) is False
    assert rt.force("other", batch) is False
    release.set()
    rt.drain(5.0)
    snap = obs.snapshot(r)
    assert (snap["counters"]["serve.retune.forced"], snap["counters"]["serve.retune.launched"]) == (1, 1)
    assert measured == [batch.shape]
