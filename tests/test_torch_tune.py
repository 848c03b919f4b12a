"""The port's tuner (``repro_torch.tune``) against the JAX package's ``repro.tune``.

Mirrors ``tests/test_tune.py``.  The same seeded numpy inputs go to both
packages on the CPU; what must agree exactly (``np.array_equal`` / ``==``):
bucket keys under one explicit backend tag, the §3.6 heuristic's algorithm
at one shape and d_µ, and classes from ``tuned_eval``, ``eval_forest_tuned``
and ``predict`` under every resolution source (heuristic, autotune, cache
hit, ``promote``).  Float fields (measured survival) agree within 1e-12
relative.  The JAX side runs its ``jnp`` engine, as its own tests do off
TPU; the port runs its default ``torch`` engine and, explicitly, its
``cuda`` engine, whose variants run the kernels' plain versions on CPU
tensors.  Inputs are normal draws: no subnormals (XLA on the CPU flushes
them; the port does not).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import tune as jt
from repro.core import breadth_first_encode as jax_encode
from repro.core import eval_forest_tuned as jax_eval_forest_tuned
from repro.core import paper_tree as jax_paper_tree
from repro.core import random_tree as jax_random_tree
from repro.core.forest import EncodedForest as JaxForest
from repro.kernels.tree_eval import CASCADE_VARIANTS as JAX_CASCADE_VARIANTS
from repro.kernels.tree_eval import FOREST_VARIANTS as JAX_FOREST_VARIANTS
from repro.kernels.tree_eval import VARIANTS as JAX_VARIANTS
from repro_torch import tune as pt
from repro_torch.core import EncodedForest, EncodedTree, eval_forest_tuned, eval_serial
from repro_torch.core.analysis import CostModel, crossover_group_size, speculative_wins
from repro_torch.kernels import _build
from repro_torch.kernels.tree_eval import CASCADE_VARIANTS, FOREST_VARIANTS, VARIANTS, PER_TREE_FAMILY
from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.kernels.tree_eval import ops
from repro_torch.kernels.tree_eval.cascade import MAJORITY_FAMILY
from repro_torch.tune import space as pspace

from torch_parity import assert_same

CPU = "cpu:cpu:x1"
ALL = ("cuda", "torch")
FAST = {"warmup": 1, "iters": 2}


def _records(m, a, seed=0):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32)


def _trees(depths, n_attrs=9, n_classes=6, seed0=0):
    """The same random trees in both packages: (JAX encodings, port encodings)."""
    jax = [jax_encode(jax_random_tree(n_attrs=n_attrs, n_classes=n_classes, max_depth=d, seed=seed0 + d))
           for d in depths]
    return jax, [EncodedTree.from_arrays(*e) for e in jax]


def _forests(depths, **kw):
    jax, port = _trees(depths, **kw)
    jf = JaxForest(jax)
    return jf, EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def _paper():
    enc = jax_encode(jax_paper_tree())
    return enc, EncodedTree.from_arrays(*enc)


def _serial_stack(forest, rec):
    return np.stack([eval_serial(forest.tree(i), rec) for i in range(forest.n_trees)])


# The JAX package's variant names and the port's: engine "jnp" is the port's
# "torch", "pallas" its "cuda", and the family "vmap" its "batched".
def port_variant(name: str) -> str:
    for jax_prefix, port_prefix in (("jnp_", "torch_"), ("pallas_", "cuda_"), ("forest_vmap_", "forest_batched_"),
                                    ("forest_cascade_vmap_", "forest_cascade_batched_")):
        if name.startswith(jax_prefix):
            return port_prefix + name[len(jax_prefix):]
    return name


def port_entry(entry) -> pt.TuneEntry:
    """A JAX ``TuneEntry`` as the port's (jnp-engine winners only carry no tile)."""
    return pt.TuneEntry(variant=port_variant(entry.variant), params=dict(entry.params),
                        median_ms=entry.median_ms, shape=entry.shape, backend=CPU)


def _algorithm(name: str) -> str:
    return "data_parallel" if "data_parallel" in name else "speculative"


# ---------------------------------------------------------------------------
# Shapes, keys and the backend tag
# ---------------------------------------------------------------------------


SHAPES = [(100, 31, 19, 11), (127, 40, 25, 9), (128, 31, 19, 11), (129, 75, 19, 12),
          (65_536, 75, 19, 12), (1, 1, 1, 1), (3000, 1023, 4, 9)]


@pytest.mark.parametrize("m,n,a,d", SHAPES)
def test_bucket_keys_equal_jax(m, n, a, d):
    s, js = pt.WorkloadShape(m, n, a, d), jt.WorkloadShape(m, n, a, d)
    assert dataclasses.astuple(s.bucket()) == dataclasses.astuple(js.bucket())
    assert s.key(CPU) == js.key(CPU)
    f = pt.ForestShape(t=5, m=m, n_nodes=n, n_attrs=a, depth_min=max(d - 3, 1), depth_max=d)
    jf = jt.ForestShape(t=5, m=m, n_nodes=n, n_attrs=a, depth_min=max(d - 3, 1), depth_max=d)
    assert f.key(CPU) == jf.key(CPU)
    assert f.classes_key(7, CPU) == jf.classes_key(7, CPU)
    assert dataclasses.astuple(f.tree_shape()) == dataclasses.astuple(jf.tree_shape())


def test_shapes_of_records_equal_jax():
    jenc, enc = _paper()
    rec = _records(50, 19)
    assert dataclasses.astuple(pt.WorkloadShape.of(rec, enc)) == dataclasses.astuple(jt.WorkloadShape.of(rec, jenc))
    assert pt.WorkloadShape.of(torch.from_numpy(rec), enc) == pt.WorkloadShape.of(rec, enc)
    jf, f = _forests((2, 5, 8))
    assert dataclasses.astuple(pt.ForestShape.of(rec[:, :9], f)) == dataclasses.astuple(jt.ForestShape.of(rec[:, :9], jf))


def test_backend_tag_keys_the_evaluators_device(monkeypatch):
    """CPU rows stay CPU rows on a machine with a card; a card's rows carry
    its sanitized name and the device count."""
    assert pt.backend_tag("cpu") == CPU == jt.backend_tag()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    pspace._device_tag.cache_clear()
    try:
        assert pt.backend_tag("cuda:0") == "cuda:nvidia_h100_80gb_hbm3:x1"
        assert pt.backend_tag("cpu") == CPU
    finally:
        pspace._device_tag.cache_clear()


def test_dispatch_stores_under_backend_tag(tmp_path):
    jenc, enc = _paper()
    cache = pt.TuneCache(tmp_path / "c.json")
    pt.TunedEvaluator(enc, cache=cache, autotune=True, measure_kw=FAST, device="cpu")(_records(32, 19, seed=21))
    assert cache.keys() == [pt.WorkloadShape.of(_records(32, 19), enc).key(CPU)]


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engines", [None, ALL, ("cuda",)])
def test_candidates_only_registered_variants(engines):
    shape = pt.WorkloadShape(m=256, n_nodes=31, n_attrs=19, depth=6)
    cands = list(pt.search_space(shape, engines=engines, device="cpu"))
    assert cands
    for c in cands:
        spec = ops.get_variant(c.variant)
        assert set(c.param_dict) <= set(spec.tunables)
        assert spec.engine in (engines or ("torch",))


@pytest.mark.parametrize("n,a", [(31, 19), (75, 19), (1023, 19), (2000, 7), (7000, 19), (19_000, 19)])
def test_kernel_tiles_fit_every_tree_of_the_bucket(n, a):
    """Each cuda candidate's tile fits the bucket's upper N and A on the card."""
    shape = pt.WorkloadShape(m=65_536, n_nodes=n, n_attrs=a, depth=12)
    b = shape.bucket()
    for c in pt.search_space(shape, engines=("cuda",), device="cpu"):
        spec = ops.get_variant(c.variant)
        bm = c.param_dict["block_m"]
        cap = ops.DATA_PARALLEL_BM_MAX if spec.algorithm == "data_parallel" else ops.SPECULATIVE_BM_MAX
        assert 1 <= bm <= cap
        assert K.smem_bytes(spec.algorithm, bm, b.n_attrs, b.n_nodes, spec.jump_mode) <= K.SMEM_MAX
        assert K.smem_bytes(spec.algorithm, bm, a, n, spec.jump_mode) <= K.SMEM_MAX


def test_variants_without_a_tile_leave_the_space():
    huge = pt.WorkloadShape(m=256, n_nodes=100_000, n_attrs=19, depth=17)
    assert not [c for c in pt.search_space(huge, engines=("cuda",), device="cpu")]
    torch_only = {ops.get_variant(c.variant).jump_mode for c in pt.search_space(huge, device="cpu")}
    assert torch_only == {"gather"}     # MAX_ONEHOT_NODES for the torch one-hot form
    onehot_stop = pt.WorkloadShape(m=256, n_nodes=2100, n_attrs=19, depth=12)
    names = {c.variant for c in pt.search_space(onehot_stop, engines=("cuda",), device="cpu")}
    assert "cuda_speculative_onehot" not in names and "cuda_data_parallel" in names


def test_default_engines_follow_the_device():
    assert pspace.default_engines("cpu") == ("torch",)
    assert pspace.default_engines("cuda") == ("cuda",)


def test_forest_space_spans_three_families_and_quant_is_opt_in():
    shape = pt.ForestShape(t=4, m=256, n_nodes=31, n_attrs=19, depth_min=6, depth_max=6)
    variants = {c.variant for c in pt.forest_search_space(shape, engines=ALL)}
    assert PER_TREE_FAMILY in variants
    assert any(v.startswith("forest_batched_") for v in variants)
    assert any(v.startswith("forest_fused_") for v in variants)
    assert not any(v.endswith("_q") for v in variants)
    quant = [c for c in pt.forest_search_space(shape, engines=ALL, layouts=("f32", "quant")) if c.variant.endswith("_q")]
    assert {c.param_dict["thr_dtype"] for c in quant} == {"bfloat16", "float16"}
    only = {c.variant for c in pt.forest_search_space(shape, engines=ALL, layouts=("quant",))}
    assert only and all(v.endswith("_q") for v in only)


def test_cascade_space_sizes_the_vote_tile():
    shape = pt.ForestShape(t=16, m=65_536, n_nodes=51, n_attrs=19, depth_min=5, depth_max=8)
    cands = list(pt.cascade_search_space(shape, 7, engines=ALL))
    assert cands[0] == pt.Candidate.make(MAJORITY_FAMILY)
    assert pt.cascade_stage_grid(shape) == jt.cascade_stage_grid(jt.ForestShape(16, 65_536, 51, 19, 5, 8))
    b = shape.bucket()
    for c in cands[1:]:
        spec = CASCADE_VARIANTS[c.variant]
        if spec.engine == "cuda":
            assert K.smem_bytes(spec.algorithm, c.param_dict["block_m"], b.n_attrs, b.n_nodes,
                                spec.jump_mode, 7) <= K.SMEM_MAX


# ---------------------------------------------------------------------------
# Cache and registry fingerprint
# ---------------------------------------------------------------------------


ENTRY = pt.TuneEntry(variant="torch_data_parallel", params={}, median_ms=1.25,
                     shape={"m": 128, "n_nodes": 31, "n_attrs": 19, "depth": 11}, backend=CPU)


def test_cache_round_trip_and_params(tmp_path):
    path = tmp_path / "cache.json"
    pt.TuneCache(path).store("k", ENTRY)
    pt.TuneCache(path).store("q", pt.TuneEntry(variant="forest_fused_speculative_q",
                                               params={"block_m": 64, "thr_dtype": "float16"}, median_ms=0.5))
    again = pt.TuneCache(path)
    assert again.lookup("k") == ENTRY
    assert again.lookup("q").params == {"block_m": 64, "thr_dtype": "float16"}
    assert again.lookup("missing") is None


def test_cache_tolerates_corruption_and_drops_other_versions(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{not json")
    assert len(pt.TuneCache(path)) == 0
    path.write_text(json.dumps({"version": 999, "entries": {"k": {"variant": "x"}}}))
    assert pt.TuneCache(path).lookup("k") is None


def test_cache_lru_front_bounded(tmp_path):
    cache = pt.TuneCache(tmp_path / "c.json", lru_size=2)
    for i in range(5):
        cache.store(f"k{i}", dataclasses.replace(ENTRY, median_ms=float(i)))
    assert len(cache._lru) <= 2
    assert cache.lookup("k0").median_ms == 0.0


def test_changed_registry_discards_entries(tmp_path):
    pt.TuneCache(tmp_path / "c.json", registry="fp_a").store("k", ENTRY)
    assert pt.TuneCache(tmp_path / "c.json", registry="fp_a").lookup("k") is not None
    assert pt.TuneCache(tmp_path / "c.json", registry="fp_b").lookup("k") is None


def test_fingerprint_covers_the_cuda_source_and_its_flags(monkeypatch, tmp_path):
    pt.registry_fingerprint.cache_clear()
    fp = pt.registry_fingerprint()
    try:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-ftz=true",))
        pt.registry_fingerprint.cache_clear()
        assert pt.registry_fingerprint() != fp
        monkeypatch.undo()
        src = tmp_path / "tree_eval.cu"
        src.write_bytes(K.SOURCE.read_bytes() + b"\n// edited\n")
        monkeypatch.setattr(K, "SOURCE", src)
        pt.registry_fingerprint.cache_clear()
        assert pt.registry_fingerprint() != fp
    finally:
        monkeypatch.undo()
        pt.registry_fingerprint.cache_clear()
    assert pt.registry_fingerprint() == fp


def test_cache_path_is_kept_apart_from_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    assert pt.default_cache_path() != jt.default_cache_path()
    assert pt.default_cache_path().parent.name == "repro_torch_tune"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    assert pt.default_cache_path() == tmp_path / "torch.json"


# ---------------------------------------------------------------------------
# The §3.6 heuristic: the JAX package's algorithm choice
# ---------------------------------------------------------------------------


D_MUS = [None, 1.0, 2.0, 3.5, 6.186, 12.0, 30.0]
P_GROUPS = [None, 2.0, 4.0, 37.0, 500.0]


@pytest.mark.parametrize("m,n,a,d", SHAPES)
def test_heuristic_algorithm_equals_jax(m, n, a, d):
    shape, jshape = pt.WorkloadShape(m, n, a, d), jt.WorkloadShape(m, n, a, d)
    for d_mu in D_MUS:
        for p in P_GROUPS:
            kw = dict(d_mu=d_mu, p_group=p)
            assert pt.predicted_times(shape, **kw) == jt.predicted_times(jshape, **kw)
            want = _algorithm(jt.heuristic_candidate(jshape, **kw).variant)
            for engines in (None, ALL, ("cuda",)):
                got = pt.heuristic_candidate(shape, engines=engines, device="cpu", **kw)
                assert _algorithm(got.variant) == want, (d_mu, p, engines, got)
                assert ops.get_variant(got.variant).jump_mode == "gather"   # never one-hot on the card


def test_heuristic_kernel_tile_is_the_buckets():
    shape = pt.WorkloadShape(m=65_536, n_nodes=75, n_attrs=19, depth=12)
    c = pt.heuristic_candidate(shape, d_mu=6.186, engines=("cuda",))
    assert c.variant == "cuda_data_parallel"
    assert c.param_dict["block_m"] == ops.choose_block_m(128, 128, algorithm="data_parallel")


def test_model_choice_matches_crossover():
    cm = CostModel(t_e=1.0, t_c=1.0, t_i=0.0, sigma=0.0, gamma=0.0)
    shape = pt.WorkloadShape(m=1024, n_nodes=31, n_attrs=19, depth=8)
    for d_mu in (2.0, 4.0, 8.0, 16.0, 32.0):
        for factor in (0.5, 0.9, 1.1, 2.0):
            p = crossover_group_size(d_mu) * factor
            times = pt.predicted_times(shape, cm=cm, d_mu=d_mu, p_group=p)
            assert (times["speculative"] < times["data_parallel"]) == speculative_wins(d_mu, p)


FOREST_SHAPES = [(8, 1024, 127, 19, 6, 6), (8, 1024, 127, 19, 1, 24), (16, 65_536, 51, 19, 5, 8),
                 (3, 120, 255, 9, 2, 8), (2, 64, 31, 7, 4, 4)]


def _family(name: str) -> str:
    if name == PER_TREE_FAMILY:
        return name
    return "fused" if "_fused_" in name else "batched"


@pytest.mark.parametrize("t,m,n,a,lo,hi", FOREST_SHAPES)
def test_forest_and_cascade_heuristics_equal_jax(t, m, n, a, lo, hi):
    shape, jshape = pt.ForestShape(t, m, n, a, lo, hi), jt.ForestShape(t, m, n, a, lo, hi)
    for d_mu in (None, 2.0, 5.0, 12.0):
        for overhead in (1e-6, 50.0):
            kw = dict(d_mu=d_mu, launch_overhead=overhead)
            for engines, jengines in ((None, None), (ALL, ("pallas", "jnp"))):
                got = pt.forest_heuristic_candidate(shape, engines=engines, device="cpu", **kw)
                want = jt.forest_heuristic_candidate(jshape, engines=jengines, **kw)
                assert _family(port_variant(want.variant)) == _family(got.variant), (engines, kw)
                if got.variant != PER_TREE_FAMILY:
                    assert _algorithm(got.variant) == _algorithm(want.variant)
        for survival in (None, (1.0, 0.05), (1.0, 0.9, 0.8, 0.7)):
            got = pt.cascade_heuristic_candidate(shape, 7, survival=survival, d_mu=d_mu, device="cpu")
            want = jt.cascade_heuristic_candidate(jshape, 7, survival=survival, d_mu=d_mu)
            assert (got.variant == MAJORITY_FAMILY) == (want.variant == MAJORITY_FAMILY)
            if got.variant != MAJORITY_FAMILY:
                assert got.param_dict["stages"] == want.param_dict["stages"]
                assert _algorithm(got.variant) == _algorithm(want.variant)


def test_measured_depth_and_survival_equal_jax():
    jf, f = _forests((3, 5, 7, 9, 4), n_classes=4)
    rec = _records(300, 9, seed=5)
    assert pt.measured_d_mu(f.tree(3), rec) == jt.measured_d_mu(jf.tree(3), rec)
    assert pt.measured_d_mu(f.tree(3), torch.from_numpy(rec)) == jt.measured_d_mu(jf.tree(3), rec)
    assert pt.measured_forest_d_mu(f, rec) == jt.measured_forest_d_mu(jf, rec)
    for stages in (2, 3):
        got = pt.measured_survival_rate(f, rec, 4, stages=stages)
        want = jt.measured_survival_rate(jf, rec, 4, stages=stages)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# Dispatch: classes equal the JAX package's under every resolution source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engines", [None, ALL])
def test_heuristic_dispatch_equals_jax(tmp_path, engines):
    jenc, enc = _paper()
    rec = _records(300, 19, seed=3)
    want = np.asarray(jt.tuned_eval(rec, jenc, cache=jt.TuneCache(tmp_path / "j.json")))
    ev = pt.TunedEvaluator(enc, cache=pt.TuneCache(tmp_path / "p.json"), engines=engines, device="cpu")
    got = ev(rec)
    assert ev.resolve(rec)[1] == "memo"
    assert got.dtype == torch.int32
    assert_same(got, want, "heuristic")
    assert_same(got, eval_serial(enc, rec), "eval_serial")


@pytest.mark.parametrize("seed,depth,balance,m", [(1, 1, 1.0, 1), (7, 5, 0.6, 97), (23, 9, 0.3, 150)])
def test_random_trees_dispatch_equals_jax(tmp_path, seed, depth, balance, m):
    jenc = jax_encode(jax_random_tree(n_attrs=7, n_classes=5, max_depth=depth, seed=seed, balance=balance))
    enc = EncodedTree.from_arrays(*jenc)
    rec = _records(m, 7, seed=seed + 1)
    want = np.asarray(jt.tuned_eval(rec, jenc, cache=jt.TuneCache(tmp_path / "j.json")))
    for engines in (None, ALL):
        got = pt.tuned_eval(rec, enc, cache=pt.TuneCache(tmp_path / "p.json"), engines=engines, device="cpu")
        assert_same(got, want, f"{engines}")


def test_autotune_cache_hit_and_promote_equal_jax(tmp_path):
    jenc, enc = _paper()
    rec = _records(64, 19, seed=8)
    jentry, _ = jt.tune_workload(rec, jenc, cache=jt.TuneCache(tmp_path / "j.json"), **FAST)
    want = np.asarray(jt.TunedEvaluator(jenc, cache=jt.TuneCache(tmp_path / "j.json"))(rec))
    assert_same(want, eval_serial(enc, rec), "jax")

    cache = pt.TuneCache(tmp_path / "a.json")
    ev = pt.TunedEvaluator(enc, cache=cache, autotune=True, engines=ALL, measure_kw=FAST, device="cpu")
    assert_same(ev(rec), want, "autotune")
    assert ev.resolve(rec)[1] == "memo" and len(cache) == 1
    fresh = pt.TunedEvaluator(enc, cache=pt.TuneCache(tmp_path / "a.json"), engines=ALL, device="cpu")
    assert fresh.resolve(rec)[1] == "cache"
    assert_same(fresh(rec), want, "cache hit")

    # the JAX package's measured winner, carried across, is a port cache hit
    key = pt.WorkloadShape.of(rec, enc).key(CPU)
    hit = pt.TuneCache(tmp_path / "b.json")
    hit.store(key, port_entry(jentry))
    ev = pt.TunedEvaluator(enc, cache=hit, device="cpu")
    cand, source = ev.resolve(rec)
    assert (cand.variant, source) == (port_variant(jentry.variant), "cache")
    assert_same(ev(rec), want, "jax winner")

    for name in sorted(VARIANTS):
        spec = VARIANTS[name]
        params = {"block_m": 32} if "block_m" in spec.tunables else (
            {"jumps_per_round": 3} if spec.tunables else {})
        ev.promote(key, pt.Candidate.make(name, **params))
        assert ev.resolve(rec) == (pt.Candidate.make(name, **params), "memo")
        assert_same(ev(rec), want, f"promote {name}")


def test_cached_winner_that_cannot_run_here_is_refused(tmp_path):
    jenc, enc = _paper()
    rec = _records(40, 19, seed=10)
    cache = pt.TuneCache(tmp_path / "c.json")
    key = pt.WorkloadShape.of(rec, enc).key(CPU)
    for entry in (pt.TuneEntry("gone_variant", {}, 1.0),
                  pt.TuneEntry("torch_data_parallel", {}, 1.0)):      # torch not permitted below
        cache.store(key, entry)
        ev = pt.TunedEvaluator(enc, cache=cache, engines=("cuda",), device="cpu")
        cand, source = ev.resolve(rec)
        assert source == "heuristic" and cand.variant.startswith("cuda_")
        assert_same(ev(rec), eval_serial(enc, rec), entry.variant)
    # a tile too large for this tree's record rows on the card
    wide = _records(40, 4000, seed=11)
    cache.store(pt.WorkloadShape.of(wide, enc).key(CPU),
                pt.TuneEntry("cuda_speculative_onehot", {"block_m": 128}, 1.0))
    cand, source = pt.TunedEvaluator(enc, cache=cache, engines=ALL, device="cpu").resolve(wide)
    assert source == "heuristic"


def test_tile_refusal_scores_inf_and_other_faults_propagate(tmp_path, monkeypatch):
    jenc, enc = _paper()
    rec = _records(32, 19, seed=9)
    spec = VARIANTS["torch_data_parallel"]

    def refuse(*a, **k):
        raise K.TileError("no tile fits (forced)")

    monkeypatch.setitem(VARIANTS, spec.name, dataclasses.replace(spec, fn=refuse))
    m = pt.measure_candidate(pt.Candidate.make(spec.name), torch.from_numpy(rec), enc, max_depth=11)
    assert m.failed and m.median_ms == float("inf")
    entry, ms = pt.tune_workload(rec, enc, cache=pt.TuneCache(tmp_path / "a.json"), engines=ALL,
                                 device="cpu", **FAST)
    assert entry.variant != spec.name and sum(x.failed for x in ms) == 1

    def crash(*a, **k):
        raise RuntimeError("nvcc failed (forced)")

    monkeypatch.setitem(VARIANTS, spec.name, dataclasses.replace(spec, fn=crash))
    with pytest.raises(RuntimeError, match="forced"):
        pt.measure_candidate(pt.Candidate.make(spec.name), torch.from_numpy(rec), enc, max_depth=11)
    with pytest.raises(RuntimeError, match="forced"):
        pt.tune_workload(rec, enc, cache=pt.TuneCache(tmp_path / "b.json"), device="cpu", **FAST)
    with pytest.raises(RuntimeError, match="forced"):
        pt.TunedEvaluator(enc, cache=pt.TuneCache(tmp_path / "c.json"), autotune=True,
                          measure_kw=FAST, device="cpu")(rec)


def test_tune_workload_winner_is_measured_minimum(tmp_path):
    jenc, enc = _paper()
    entry, measurements = pt.tune_workload(_records(32, 19, seed=9), enc, cache=pt.TuneCache(tmp_path / "c.json"),
                                           engines=ALL, device="cpu", **FAST)
    ok = [m for m in measurements if not m.failed]
    assert entry.median_ms == min(m.median_ms for m in ok)
    assert {ops.get_variant(m.candidate.variant).engine for m in ok} == set(ALL)
    for m in ok:
        assert m.cost["bytes"] > 0 and m.cost["flops"] == 32 * 11 and m.launches == {}


def test_numpy_input_without_a_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jenc, enc = _paper()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.tuned_eval(_records(8, 19), enc, cache=pt.TuneCache(tmp_path / "c.json"))
    got = pt.tuned_eval(torch.from_numpy(_records(8, 19)), enc, cache=pt.TuneCache(tmp_path / "c.json"))
    assert got.device.type == "cpu"


# ---------------------------------------------------------------------------
# Forest and class-level dispatch
# ---------------------------------------------------------------------------


def test_forest_families_equal_jax(tmp_path):
    jf, f = _forests((2, 5, 8))
    rec = _records(150, 9, seed=40)
    want = np.asarray(jax_eval_forest_tuned(jf, rec, cache=jt.TuneCache(tmp_path / "j.json")))
    assert_same(want, _serial_stack(f, rec), "jax")
    for families in ((PER_TREE_FAMILY,), ("batched",), ("fused",), None):
        for engines in (None, ALL):
            out = eval_forest_tuned(f, rec, cache=pt.TuneCache(tmp_path / "p.json"), families=families,
                                    engines=engines, device="cpu")
            assert_same(out, want, f"{families} {engines}")
    assert_same(pt.tuned_eval_forest(rec, f, cache=pt.TuneCache(tmp_path / "q.json"), device="cpu"), want, "fn")


def test_forest_autotune_and_cache_hit_equal_jax(tmp_path):
    jf, f = _forests((3, 4), n_attrs=7, n_classes=5)
    rec = _records(64, 7, seed=41)
    jcache = jt.TuneCache(tmp_path / "j.json")
    want = np.asarray(jt.ForestTunedEvaluator(jf, cache=jcache, autotune=True, measure_kw=FAST)(rec))
    cache = pt.TuneCache(tmp_path / "p.json")
    ev = pt.ForestTunedEvaluator(f, cache=cache, autotune=True, engines=ALL, measure_kw=FAST, device="cpu")
    assert_same(ev(rec), want, "autotune")
    key = ev.shape_of(rec).key(CPU)
    entry = cache.lookup(key)
    assert entry is not None and (entry.variant in FOREST_VARIANTS or entry.variant == PER_TREE_FAMILY)
    fresh = pt.ForestTunedEvaluator(f, cache=pt.TuneCache(tmp_path / "p.json"), engines=ALL, device="cpu")
    assert fresh.resolve(rec) == (pt.Candidate.make(entry.variant, **entry.params), "cache")
    assert_same(fresh(rec), want, "cache hit")
    jentry = jcache.lookup(jt.ForestShape.of(rec, jf).key(CPU))
    hit = pt.TuneCache(tmp_path / "h.json")
    hit.store(key, port_entry(jentry))
    ev = pt.ForestTunedEvaluator(f, cache=hit, device="cpu")
    assert ev.resolve(rec)[1] == "cache"
    assert_same(ev(rec), want, "jax winner")
    for name in [PER_TREE_FAMILY] + sorted(FOREST_VARIANTS):
        spec = FOREST_VARIANTS.get(name)
        params = {} if spec is None else {k: v for k, v in (("block_m", 32), ("thr_dtype", "float16"),
                                                            ("jumps_per_round", 2)) if k in spec.tunables}
        ev.promote(key, pt.Candidate.make(name, **params))
        assert_same(ev(rec), want, f"promote {name}")


def test_quant_layouts_opt_in_and_stay_exact(tmp_path):
    jf, f = _forests((4, 4), n_attrs=7, n_classes=5, seed0=8)
    rec = _records(64, 7, seed=46)
    want = np.asarray(jax_eval_forest_tuned(jf, rec, cache=jt.TuneCache(tmp_path / "j.json"), autotune=True,
                                            layouts=("f32", "quant")))
    cache = pt.TuneCache(tmp_path / "p.json")
    got = eval_forest_tuned(f, rec, cache=cache, autotune=True, engines=ALL, layouts=("f32", "quant"),
                            device="cpu")
    assert_same(got, want, "autotune, quant opted in")
    assert len(cache) == 0 or all("|T" not in k for k in cache.keys())   # a restricted sweep stores no forest row
    ev = pt.ForestTunedEvaluator(f, cache=cache, engines=ALL, device="cpu")
    cache.store(ev.shape_of(rec).key(CPU), pt.TuneEntry("forest_fused_data_parallel_q",
                                                        {"block_m": 64, "thr_dtype": "bfloat16"}, 0.01))
    cand, source = ev.resolve(rec)
    assert source == "heuristic" and not cand.variant.endswith("_q")     # f32-only by default
    opted = pt.ForestTunedEvaluator(f, cache=cache, engines=ALL, layouts=("f32", "quant"), device="cpu")
    assert opted.resolve(rec)[1] == "cache"
    assert_same(opted(rec), want, "quant cache hit")


def test_family_restricted_evaluator_refuses_a_foreign_hit(tmp_path):
    jf, f = _forests((4, 4), n_attrs=7, n_classes=5, seed0=8)
    rec = _records(64, 7, seed=45)
    cache = pt.TuneCache(tmp_path / "c.json")
    restricted = pt.ForestTunedEvaluator(f, cache=cache, families=(PER_TREE_FAMILY,), device="cpu")
    cache.store(restricted.shape_of(rec).key(CPU), pt.TuneEntry("forest_batched_data_parallel", {}, 0.1))
    assert restricted.resolve(rec) == (pt.Candidate.make(PER_TREE_FAMILY), "heuristic")
    assert pt.ForestTunedEvaluator(f, cache=cache, device="cpu").resolve(rec) == (
        pt.Candidate.make("forest_batched_data_parallel"), "cache")


def test_predict_equals_jax_under_every_source(tmp_path):
    jf, f = _forests((3, 4, 5, 6, 7), n_classes=4)
    rec = _records(256, 9, seed=47)
    jcache = jt.TuneCache(tmp_path / "j.json")
    want = np.asarray(jt.ForestTunedEvaluator(jf, cache=jcache).predict(rec, 4))
    jt.ForestTunedEvaluator(jf, cache=jcache, autotune=True, measure_kw=FAST).predict(rec, 4)
    for engines in (None, ALL):
        ev = pt.ForestTunedEvaluator(f, cache=pt.TuneCache(tmp_path / "h.json"), engines=engines, device="cpu")
        assert_same(ev.predict(rec, 4), want, f"heuristic {engines}")
        assert ev.resolve_classes(rec, 4)[1] == "memo"
    cache = pt.TuneCache(tmp_path / "a.json")
    ev = pt.ForestTunedEvaluator(f, cache=cache, autotune=True, engines=ALL, measure_kw=FAST, device="cpu")
    assert_same(ev.predict(rec, 4), want, "autotune")
    ckey = ev.shape_of(rec).classes_key(4, CPU)
    assert cache.lookup(ckey) is not None
    fresh = pt.ForestTunedEvaluator(f, cache=pt.TuneCache(tmp_path / "a.json"), engines=ALL, device="cpu")
    assert fresh.resolve_classes(rec, 4)[1] == "cache"
    assert_same(fresh.predict(rec, 4), want, "cache hit")
    jentry = jcache.lookup(jt.ForestShape.of(rec, jf).classes_key(4, CPU))
    assert jentry.variant == MAJORITY_FAMILY or jentry.variant in JAX_CASCADE_VARIANTS
    hit = pt.TuneCache(tmp_path / "b.json")
    hit.store(ckey, port_entry(jentry))
    ev = pt.ForestTunedEvaluator(f, cache=hit, device="cpu")
    assert ev.resolve_classes(rec, 4)[1] == "cache"
    assert_same(ev.predict(rec, 4), want, "jax winner")
    for name in [MAJORITY_FAMILY] + sorted(CASCADE_VARIANTS):
        spec = CASCADE_VARIANTS.get(name)
        params = {} if spec is None else ({"stages": 3} | ({"block_m": 16} if "block_m" in spec.tunables else {}))
        ev.promote(ckey, pt.Candidate.make(name, **params))
        assert_same(ev.predict(rec, 4), want, f"promote {name}")


def test_port_variant_names_cover_the_jax_registries():
    assert {port_variant(v) for v in JAX_VARIANTS} == set(VARIANTS)
    assert {port_variant(v) for v in JAX_FOREST_VARIANTS} == set(FOREST_VARIANTS)
    assert {port_variant(v) for v in JAX_CASCADE_VARIANTS} == set(CASCADE_VARIANTS)
