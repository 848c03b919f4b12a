"""The port's ``repro_torch.dist`` and windowed evaluation against the JAX package.

Mirrors ``tests/test_dist.py`` and the windowed tests of
``tests/test_tree_core.py``.  The planner is host math and must plan exactly
as the JAX planner does (``==`` on every cost).  The executor runs on a
``("cpu",) * 8`` device grid — the port's counterpart of
``--xla_force_host_platform_device_count=8`` — and every decomposition must
equal the JAX package's ``eval_forest_tuned`` and stacked ``eval_serial``
with ``np.array_equal``, padding included (M 7, 3, 2).  The JAX side runs on
its one CPU device, where its executor *is* ``eval_forest_tuned``.  Inputs
are normal draws: no subnormals.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import dist as jdist
from repro.core import windowed as jwindowed
from repro.parallel import sharding as jshd
from repro.tune import TuneCache as JaxTuneCache
from repro_torch import dist
from repro_torch.core import (
    EncodedForest,
    EncodedTree,
    eval_forest_sharded,
    eval_serial,
    eval_windowed,
    forest_of,
    level_offsets,
    shard_eval_data_parallel,
    shard_eval_speculative,
)
from repro_torch.kernels.tree_eval import FOREST_VARIANTS
from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.parallel import sharding as shd
from repro_torch.tune import Candidate, ForestShape, TuneCache, TuneEntry, WorkloadShape, backend_tag

from hypothesis_compat import given, settings, st

REPO = Path(__file__).resolve().parents[1]
CPU8 = ("cpu",) * 8
ENGINES = ("cuda", "torch")   # the kernels' plain versions on CPU tensors, and the torch evaluators
CPU = backend_tag("cpu")


def _records(m, a, seed=0):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32)


def _forests(n_trees=12, n_attrs=9, depth=lambda i: 3 + (i % 6)):
    """The same random forest, encoded by the JAX package and as the port's."""
    trees = [jcore.breadth_first_encode(jcore.random_tree(n_attrs=n_attrs, n_classes=6,
                                                          max_depth=depth(i), seed=i))
             for i in range(n_trees)]
    jf = jcore.EncodedForest(trees)
    return jf, EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def _stacked_serial(forest, rec):
    return np.stack([eval_serial(forest.tree(i), rec) for i in range(forest.n_trees)])


def _workloads():
    out = []
    for m in (1, 3, 1000, 65_536, 1_000_000):
        for t in (1, 5, 16, 512):
            for n, depth, d_mu in ((7, 30, 30.0), (31, 11, 6.0), (1023, 10, 2.0)):
                out.append(dict(m=m, n_trees=t, n_nodes=n, n_attrs=19, depth=depth, d_mu=d_mu))
    return out


# ---------------------------------------------------------------------------
# The planner, against the JAX planner
# ---------------------------------------------------------------------------


def _plans(plans):
    return [(p.record_shards, p.tree_shards, p.algorithm, p.predicted, p.decomposition) for p in plans]


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8, 16])
def test_planner_plans_exactly_as_jax(n_devices):
    mcm, jmcm = dist.MeshCostModel(), jdist.MeshCostModel()
    assert dataclasses.asdict(mcm) == dataclasses.asdict(jmcm)
    for kw in _workloads():
        wl, jwl = dist.ForestWorkload(**kw), jdist.ForestWorkload(**kw)
        assert _plans(dist.enumerate_plans(wl, n_devices, mcm)) == _plans(jdist.enumerate_plans(jwl, n_devices, jmcm))
        for deco in (None, "records", "trees", "hybrid"):
            try:
                want = jdist.plan_forest(jwl, n_devices, mesh_cost=jmcm, decomposition=deco)
            except ValueError:
                with pytest.raises(ValueError, match="no feasible"):
                    dist.plan_forest(wl, n_devices, mesh_cost=mcm, decomposition=deco)
                continue
            assert _plans([dist.plan_forest(wl, n_devices, mesh_cost=mcm, decomposition=deco)]) == _plans([want])
        for r in (1, 2, n_devices):
            for g in (1, 3, n_devices):
                assert dist.shard_extents(wl, r, g) == jdist.shard_extents(jwl, r, g)
                assert dist.predicted_plan_time(wl, r, g, mcm) == jdist.predicted_plan_time(jwl, r, g, jmcm)
                assert _plans([dist.make_plan(wl, r, g, mcm)]) == _plans([jdist.make_plan(jwl, r, g, jmcm)])


def test_planner_with_zero_overheads_and_crossover_as_jax():
    """The closed-form properties of ``tests/test_dist.py`` hold for the port,
    with the JAX planner's exact numbers."""
    free = dict(sigma_rec=0.0, sigma_tree=0.0, sigma_out=0.0, gamma_launch=0.0)
    wire = dict(sigma_rec=1.0, sigma_tree=1.0, gamma_launch=0.0)
    base = dict(n_nodes=31, n_attrs=19, depth=11, d_mu=6.0)
    prev = float("inf")
    for d in (1, 2, 4, 8, 16):
        wl = dist.ForestWorkload(m=4096, n_trees=16, **base)
        got = dist.plan_forest(wl, d, mesh_cost=dist.MeshCostModel(**free))
        want = jdist.plan_forest(jdist.ForestWorkload(m=4096, n_trees=16, **base), d,
                                 mesh_cost=jdist.MeshCostModel(**free))
        assert got.predicted == want.predicted and got.predicted <= prev + 1e-9
        prev = got.predicted
    for m, t, deco in ((65_536, 4, "records"), (64, 512, "trees")):
        got = dist.plan_forest(dist.ForestWorkload(m=m, n_trees=t, **base), 4, mesh_cost=dist.MeshCostModel(**wire))
        assert got.decomposition == deco
    assert dist.ShardPlan(4, 2, "data_parallel", 0.0).decomposition == "hybrid"
    assert dist.ShardPlan(1, 1, "data_parallel", 0.0).decomposition == "single"


def test_calibrate_mesh_cost_fits_as_jax():
    bench = REPO / "results" / "BENCH_dist.json"
    got = dist.calibrate_mesh_cost(bench)
    want = jdist.calibrate_mesh_cost(bench)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for p_device in (1.0, 32.0):
        assert dataclasses.asdict(dist.calibrate_mesh_cost(bench, p_device=p_device)) == \
            dataclasses.asdict(jdist.calibrate_mesh_cost(bench, p_device=p_device))


def test_forest_workload_of_equals_jax():
    jf, pf = _forests()
    rec = _records(777, 9, seed=4)
    assert dataclasses.asdict(dist.ForestWorkload.of(pf, rec)) == dataclasses.asdict(jdist.ForestWorkload.of(jf, rec))
    assert dataclasses.asdict(dist.ForestWorkload.of(pf, rec, d_mu=3.25)) == \
        dataclasses.asdict(jdist.ForestWorkload.of(jf, rec, d_mu=3.25))


@given(m=st.integers(1, 100_000), t=st.integers(1, 64), d=st.sampled_from([1, 2, 4, 6, 8]),
       d_mu=st.floats(1.0, 16.0))
@settings(max_examples=20, deadline=None)
def test_planner_properties_randomized_as_jax(m, t, d, d_mu):
    kw = dict(m=m, n_trees=t, n_nodes=31, n_attrs=19, depth=11, d_mu=d_mu)
    assert _plans(dist.enumerate_plans(dist.ForestWorkload(**kw), d)) == \
        _plans(jdist.enumerate_plans(jdist.ForestWorkload(**kw), d))


# ---------------------------------------------------------------------------
# The device grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,size", [(0, 1), (7, 1), (7, 4), (8, 4), (1000, 3), (5, 8)])
def test_pad_to_multiple_equals_jax(dim, size):
    assert shd.pad_to_multiple(dim, size) == jshd.pad_to_multiple(dim, size)


def test_forest_mesh_lays_devices_row_major():
    grid = shd.forest_mesh(2, 3, devices=["cpu"] * 7)
    assert grid.devices.shape == (2, 3) and grid.shape == {"records": 2, "trees": 3}
    assert all(d == torch.device("cpu") for d in grid.devices.flat)
    with pytest.raises(ValueError, match="needs 8 devices"):
        shd.forest_mesh(4, 2, devices=["cpu"] * 7)


# ---------------------------------------------------------------------------
# The executor on a ("cpu",) * 8 grid, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decomposition", ["records", "trees", "hybrid", None])
def test_sharded_matches_jax_tuned_all_decompositions(tmp_path, decomposition):
    jf, pf = _forests()
    rec = _records(1000, 9, seed=1)
    want = np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json")))
    assert np.array_equal(want, _stacked_serial(pf, rec))
    ev = dist.ShardedForestEvaluator(pf, decomposition=decomposition, devices=CPU8,
                                     cache=TuneCache(tmp_path / "c.json"), engines=ENGINES)
    with K.thread_launches() as launches:
        out = ev(rec)
    assert out.device.type == "cpu" and np.array_equal(out.numpy(), want)
    if decomposition is not None:
        assert ev.plan.decomposition == decomposition
    assert ev.mesh is not None and ev.stats.shard_launches == ev.plan.n_devices
    assert launches == {}   # CPU tensors run the kernels' plain versions: nothing launches
    for m in (7, 3, 2):     # odd small M exercises the divisibility padding
        assert np.array_equal(ev(rec[:m]).numpy(), want[:, :m]), m


@pytest.mark.parametrize("r,g", [(4, 2), (2, 4), (8, 1), (1, 8), (3, 1), (1, 5)])
def test_explicit_plans_and_padding_equal_jax(tmp_path, r, g):
    """Trees pad by repeating tree 0 (12 trees over 5 or 8 tree shards),
    records by zero rows; both are sliced off."""
    jf, pf = _forests()
    rec = _records(333, 9, seed=7)
    want = np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json")))
    plan = dist.ShardPlan(record_shards=r, tree_shards=g, algorithm="data_parallel", predicted=0.0)
    ev = dist.ShardedForestEvaluator(pf, plan=plan, devices=CPU8, cache=TuneCache(tmp_path / "c.json"))
    for m in (333, 7, 2):
        assert np.array_equal(ev(rec[:m]).numpy(), want[:, :m]), m


def test_single_device_is_the_tuned_path(tmp_path):
    jf, pf = _forests(3, 7, depth=lambda i: (2, 5, 8)[i])
    rec = _records(333, 7, seed=3)
    cache = TuneCache(tmp_path / "c.json")
    want = np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json")))
    ev = dist.ShardedForestEvaluator(pf, cache=cache, devices=("cpu",))
    assert np.array_equal(ev(rec).numpy(), want)
    assert ev.plan.decomposition == "single" and ev.mesh is None and not ev._fast
    assert np.array_equal(eval_forest_sharded(pf, rec, cache=cache, devices=("cpu",)).numpy(), want)
    jev = jdist.ShardedForestEvaluator(jf, cache=JaxTuneCache(tmp_path / "j2.json"))
    assert np.array_equal(np.asarray(jev(rec)), want) and jev.plan.decomposition == "single"


def test_eval_forest_sharded_over_a_grid_equals_jax(tmp_path):
    jf, pf = _forests()
    rec = _records(500, 9, seed=8)
    want = np.asarray(jcore.eval_forest_sharded(jf, rec, cache=JaxTuneCache(tmp_path / "j.json")))  # one device
    got = eval_forest_sharded(pf, rec, decomposition="hybrid", devices=CPU8, cache=TuneCache(tmp_path / "c.json"))
    assert np.array_equal(got.numpy(), want)


def test_executor_resolves_a_tree_winner_through_tune_cache(tmp_path):
    """A winner seeded at the shard's tree shape (M/R = 256) is what the
    executor resolves, and its algorithm and tile are what the shards run."""
    jf, pf = _forests(8, 9, depth=lambda i: 6)
    rec = _records(1024, 9, seed=1)
    cache = TuneCache(tmp_path / "c.json")
    plan = dist.ShardPlan(record_shards=4, tree_shards=2, algorithm="data_parallel", predicted=0.0)
    shard_shape = WorkloadShape(m=256, n_nodes=pf.n_nodes, n_attrs=9, depth=pf.max_depth)
    cache.store(shard_shape.key(CPU), TuneEntry(variant="cuda_speculative_onehot",
                                                params={"block_m": 16}, median_ms=0.1))
    ev = dist.ShardedForestEvaluator(pf, plan=plan, devices=CPU8, cache=cache, engines=ENGINES)
    out = ev(rec).numpy()
    cand, source = ev.resolved
    assert source == "cache" and cand == Candidate.make("cuda_speculative_onehot", block_m=16)
    assert ev.shard_variant == ("forest_fused_speculative_onehot", {"block_m": 16})
    assert np.array_equal(out, np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json"))))


@pytest.mark.parametrize("variant,params,layouts,runs", [
    ("forest_fused_speculative_gather", {"block_m": 8}, None, "forest_fused_speculative_gather"),
    ("forest_batched_speculative_onehot", {"jumps_per_round": 3}, None, "forest_fused_speculative_onehot"),
    ("forest_fused_data_parallel_q", {"thr_dtype": "float16"}, ("f32", "quant"), "forest_fused_data_parallel_q"),
    ("forest_fused_data_parallel_q", {"thr_dtype": "float16"}, None, "forest_fused_data_parallel"),
])
def test_cache_seeded_shard_shape_winner_is_the_one_resolved(tmp_path, variant, params, layouts, runs):
    """A forest winner stored at the shard operating point (M/R × T/G) is
    resolved from the cache and lowered onto the fused kernel of its
    algorithm; a quantized one only where ``layouts`` lets it run."""
    jf, pf = _forests(8, 9, depth=lambda i: 6)
    rec = _records(1024, 9, seed=2)
    cache = TuneCache(tmp_path / "c.json")
    plan = dist.ShardPlan(record_shards=4, tree_shards=2, algorithm="data_parallel", predicted=0.0)
    ev = dist.ShardedForestEvaluator(pf, plan=plan, devices=CPU8, cache=cache, engines=ENGINES, layouts=layouts)
    fev = ev._forest_evaluator()
    fshape = ForestShape(t=4, m=256, n_nodes=pf.n_nodes, n_attrs=9, depth_min=fev.depth_min, depth_max=fev.depth_max)
    cache.store(fshape.key(CPU), TuneEntry(variant=variant, params=params, median_ms=0.1))
    out = ev(rec).numpy()
    assert ev.shard_variant[0] == runs
    if runs.endswith("_q") or variant.startswith("forest_fused_speculative"):
        assert ev.resolved == (Candidate.make(variant, **params), "cache")
    assert np.array_equal(out, np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json"))))


def test_grid_retune_stores_the_shard_key(tmp_path):
    """On a grid the re-tune measures the fused kernels at the *shard*
    operating point and stores under the key the shards resolve, so the
    promoted winner is what the next build finds."""
    jf, pf = _forests(8, 9, depth=lambda i: 5)
    rec = _records(512, 9, seed=3)
    oracle = _stacked_serial(pf, rec)
    cache = TuneCache(tmp_path / "c.json")
    plan = dist.ShardPlan(record_shards=4, tree_shards=2, algorithm="data_parallel", predicted=0.0)
    ev = dist.ShardedForestEvaluator(pf, plan=plan, devices=CPU8, cache=cache, engines=ENGINES)
    assert np.array_equal(ev(rec).numpy(), oracle)
    entry = ev.retune(rec, warmup=1, iters=2)
    assert entry.variant in FOREST_VARIANTS and FOREST_VARIANTS[entry.variant].family == "fused"
    assert {m.candidate.variant for m in ev.last_sweep} <= {v for v, s in FOREST_VARIANTS.items() if s.family == "fused"}
    ev.invalidate_resolution()
    assert np.array_equal(ev(rec).numpy(), oracle)
    cand, source = ev.resolved
    assert source == "cache" and cand.variant == entry.variant
    single = dist.ShardedForestEvaluator(pf, devices=("cpu",), cache=cache)
    s_entry = single.retune(rec, warmup=1, iters=2)
    key = single._forest_evaluator().shape_of(rec).key(CPU)
    assert cache.lookup(key).variant == s_entry.variant


def test_shard_eval_single_tree_equals_jax():
    """Records sharded over a 1-D grid, the tree replicated: both
    decompositions equal the JAX package's evaluators and ``eval_serial``."""
    import jax
    from jax.sharding import Mesh
    from repro.core.eval_dataparallel import shard_eval_data_parallel as jshard_dp
    from repro.core.eval_speculative import shard_eval_speculative as jshard_spec

    jenc = jcore.breadth_first_encode(jcore.random_tree(n_attrs=9, n_classes=6, max_depth=7, seed=3))
    enc = EncodedTree.from_arrays(*jenc)
    depth = jcore.tree_depth(jenc)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    for m in (1001, 5, 2):
        rec = _records(m, 9, seed=m)
        want = eval_serial(enc, rec)
        assert np.array_equal(np.asarray(jshard_dp(jenc, rec, max_depth=depth, mesh=mesh)), want)
        assert np.array_equal(np.asarray(jshard_spec(jenc, rec, max_depth=depth, mesh=mesh)), want)
        for grid in (("cpu",) * 4, shd.forest_mesh(3, 1, devices=("cpu",) * 3)):
            assert np.array_equal(shard_eval_data_parallel(enc, rec, max_depth=depth, mesh=grid).numpy(), want)
            assert np.array_equal(shard_eval_speculative(enc, rec, max_depth=depth, mesh=grid).numpy(), want)


# ---------------------------------------------------------------------------
# The streaming chunker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_chunker_counts_and_outputs_equal_jax(tmp_path, inflight):
    jf, pf = _forests(8, 9, depth=lambda i: 2 + (i % 5))
    rec = _records(1500, 9, seed=2)
    want = np.asarray(jcore.eval_forest_tuned(jf, rec, cache=JaxTuneCache(tmp_path / "j.json")))
    jck = jdist.StreamingChunker(jdist.ShardedForestEvaluator(jf, cache=JaxTuneCache(tmp_path / "j2.json")),
                                 chunk_records=256, inflight=inflight)
    ck = dist.StreamingChunker(dist.ShardedForestEvaluator(pf, devices=("cpu",), cache=TuneCache(tmp_path / "c.json")),
                               chunk_records=256, inflight=inflight)
    for _ in range(3):   # the third eval runs at the coalesced size
        j_out, out = jck.eval(rec), ck.eval(rec)
        assert np.array_equal(j_out, want) and np.array_equal(out, want)
    assert ck.stats.chunks == jck.stats.chunks and ck.stats.records == jck.stats.records == 3 * 1500
    assert len(ck.stats.chunk_ms) == ck.stats.chunks and all(x > 0 for x in ck.stats.chunk_ms)
    assert ck.stats.overlap_ratio[0] == 0.0 and all(0.0 <= x <= 1.0 for x in ck.stats.overlap_ratio)
    assert ck.effective_chunk_records in (256, 512)
    assert ck.eval(rec[:0]).shape == (8, 0)


def test_stream_eval_forest_over_a_grid_equals_jax(tmp_path):
    jf, pf = _forests()
    rec = _records(1000, 9, seed=5)
    want = np.asarray(jdist.stream_eval_forest(jf, rec, chunk_records=300, cache=JaxTuneCache(tmp_path / "j.json")))
    stats = dist.StreamStats()
    got = dist.stream_eval_forest(pf, rec, chunk_records=300, stats=stats, devices=CPU8,
                                  decomposition="records", cache=TuneCache(tmp_path / "c.json"))
    assert np.array_equal(got, want) and stats.chunks == 4


# ---------------------------------------------------------------------------
# Windowed evaluation (paper §6) and forest_of
# ---------------------------------------------------------------------------


def test_windowed_matches_serial_and_jax_on_paper_tree():
    jenc = jcore.breadth_first_encode(jcore.paper_tree())
    enc = EncodedTree.from_arrays(*jenc)
    rec = _records(256, 19, seed=3)
    for w in (1, 2, 4, 16):
        want = np.asarray(jwindowed.eval_windowed(jenc, rec, window_levels=w))
        got = eval_windowed(enc, rec, window_levels=w, device="cpu").numpy()
        assert np.array_equal(got, want) and np.array_equal(got, eval_serial(enc, rec)), w


@given(st.integers(0, 40), st.integers(2, 10), st.integers(1, 6))
@settings(max_examples=20, deadline=None)
def test_windowed_property_equals_jax(seed, depth, w):
    root = jcore.random_tree(n_attrs=5, n_classes=4, max_depth=depth, seed=seed, balance=0.6)
    jenc = jcore.breadth_first_encode(root)
    enc = EncodedTree.from_arrays(*jenc)
    rec = _records(32, 5, seed=seed + 1)
    np.testing.assert_array_equal(level_offsets(enc), jwindowed.level_offsets(jenc))
    want = np.asarray(jwindowed.eval_windowed(jenc, rec, window_levels=w))
    got = eval_windowed(enc, rec, window_levels=w, device="cpu").numpy()
    assert np.array_equal(got, want) and np.array_equal(got, eval_serial(enc, rec))
    chunked = eval_windowed(enc, torch.from_numpy(rec), window_levels=w, chunk_records=5).numpy()
    assert np.array_equal(chunked, want)


def test_windowed_band_width_bounded_and_big_tree_equals_jax():
    """The per-round node axis is the widest w-level band, not N; on a
    16,383-node tree (more than any CTA of the card holds) the port equals
    the JAX package and ``eval_serial``."""
    jenc = jcore.breadth_first_encode(jcore.perfect_tree(8, 4, 4))   # N = 511
    starts = level_offsets(EncodedTree.from_arrays(*jenc))
    widths = [int(starts[min(i + 3, len(starts) - 1)] - starts[i]) for i in range(0, len(starts) - 1, 3)]
    assert max(widths) < jenc.n_nodes
    jbig = jcore.breadth_first_encode(jcore.perfect_tree(13, 19, 7, seed=3))
    big = EncodedTree.from_arrays(*jbig)
    assert big.n_nodes == 16_383
    rec = _records(200, 19, seed=9)
    want = np.asarray(jwindowed.eval_windowed(jbig, rec, window_levels=4))
    assert np.array_equal(eval_windowed(big, rec, window_levels=4, device="cpu").numpy(), want)
    assert np.array_equal(eval_windowed(big, rec, window_levels=4, device="cpu", chunk_records=64).numpy(), want)
    assert np.array_equal(want, eval_serial(big, rec))


@pytest.mark.parametrize("n_trees", [1, 3, 7])
def test_forest_of_equals_jax(n_trees):
    from repro_torch.core import random_tree

    kw = [dict(n_attrs=6, n_classes=3, max_depth=2 + i, seed=i) for i in range(n_trees)]
    got = forest_of([random_tree(**k) for k in kw])
    want = jcore.tree.forest_of([jcore.random_tree(**k) for k in kw])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("attr_idx", "threshold", "child", "class_val"):
            assert np.array_equal(getattr(g, field), getattr(w, field)) and getattr(g, field).dtype == getattr(w, field).dtype
