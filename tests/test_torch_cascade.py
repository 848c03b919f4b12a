"""The port's early-exit cascade and vote kernels against the JAX package.

Mirrors ``tests/test_cascade.py`` (plan geometry, exactness, the fused vote
primitive, the unflippable-exit property) and adds the parity the port owes:
on the same numpy inputs, ``plan_cascade``/``rank_trees``,
``forest_votes_fused``, ``CascadeEvaluator``/``eval_cascade`` and
``eval_forest_cascade`` equal the JAX package's with ``np.array_equal`` on
every field, against its ``jnp`` engine, its Pallas engine in interpret
mode and its per-record ``cascade_eval_ref``.  The port's CUDA engine runs
its kernels' plain versions here (CPU tensors).

The margin pass (``kernels/tree_eval/margin.py``): its plain versions
against NumPy here, and, in the tests marked ``gpu`` (they skip without a
card), its two kernels against the plain versions bit for bit and a whole
evaluator on the card against the same evaluator on the CPU.
"""

from __future__ import annotations

import functools
import re
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import EncodedForest as JaxForest
from repro.core import Node, breadth_first_encode, eval_forest_cascade as jax_eval_forest_cascade
from repro.core import majority_vote as jax_majority_vote
from repro.core import random_tree
from repro.kernels.tree_eval import CASCADE_VARIANTS as JAX_CASCADE_VARIANTS
from repro.kernels.tree_eval import CascadeEvaluator as JaxCascadeEvaluator
from repro.kernels.tree_eval import CascadePlan as JaxCascadePlan
from repro.kernels.tree_eval import cascade_eval_ref as jax_cascade_eval_ref
from repro.kernels.tree_eval import eval_cascade as jax_eval_cascade
from repro.kernels.tree_eval import exit_enabling_prefix as jax_exit_enabling_prefix
from repro.kernels.tree_eval import forest_votes_fused as jax_forest_votes_fused
from repro.kernels.tree_eval import plan_cascade as jax_plan_cascade
from repro.kernels.tree_eval.cascade import rank_trees as jax_rank_trees
from repro.kernels.tree_eval.ref import forest_eval_ref as jax_forest_eval_ref
from repro_torch import obs
from repro_torch.core import EncodedForest, eval_forest_cascade, majority_vote
from repro_torch.core import Node as PortNode
from repro_torch.core import breadth_first_encode as port_encode
from repro_torch.core import random_tree as port_random_tree
from repro_torch.kernels.tree_eval import (
    CASCADE_FAMILY,
    CASCADE_VARIANTS,
    MAJORITY_FAMILY,
    CascadeEvaluator,
    CascadePlan,
    cascade_eval_ref,
    cascade_ref_from_classes,
    eval_cascade,
    exit_enabling_prefix,
    forest_votes_fused,
    get_cascade_variant,
    list_cascade_variants,
    plan_cascade,
    rank_trees,
    register_cascade_variant,
)
from repro_torch.kernels.tree_eval import margin, ops

# hypothesis is optional: the shim runs a deterministic fixed-example sweep
# when the real package is not installed (see hypothesis_compat.py).
from hypothesis_compat import given, settings, st
from torch_parity import FOREST, N_CLASSES, PORT_FOREST, RECORDS, assert_same, cpu

MODES = [("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")]
BOUNDS = [None, 1.0, 0.5, 0.25]
FIELDS = ("classes", "margin", "trees_evaluated", "exit_stage", "confidence")
REF_FIELDS = ("classes", "exit_stage", "trees_evaluated")   # JAX cascade_eval_ref's, in order


def _jax_forest(n_trees=12, n_attrs=9, n_classes=6, depth_span=5, seed0=0) -> JaxForest:
    """``tests/test_cascade.py``'s forest."""
    return JaxForest([
        breadth_first_encode(
            random_tree(n_attrs=n_attrs, n_classes=n_classes,
                        max_depth=2 + ((seed0 + i) % depth_span), seed=seed0 + i)
        )
        for i in range(n_trees)
    ])


def _port(jf: JaxForest) -> EncodedForest:
    return EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def _records(m, a, seed=0):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32)


JAX_F10 = _jax_forest(n_trees=10, n_classes=5)
F10 = _port(JAX_F10)
REC = _records(300, 9, seed=7)


def _assert_result(got, want, label: str) -> None:
    """Every CascadeResult field of the port equals the JAX package's."""
    for field in FIELDS:
        assert_same(getattr(got, field), getattr(want, field), f"{label}: {field}")
        assert getattr(got, field).dtype == getattr(torch, np.asarray(getattr(want, field)).dtype.name)
    assert got.stages_run == want.stages_run, label
    assert got.stage_survivors == want.stage_survivors, label


@functools.cache
def _jax_plan(stages: int, bound):
    return jax_plan_cascade(JAX_F10, REC, n_classes=5, stages=stages, bound=bound)


@functools.cache
def _jax_jnp(algorithm: str, jump_mode: str, stages: int, bound):
    ev = JaxCascadeEvaluator(JAX_F10, _jax_plan(stages, bound), n_classes=5, bound=bound,
                             engine="jnp", algorithm=algorithm, jump_mode=jump_mode)
    return ev(REC)


@functools.cache
def _jax_ref(stages: int, bound):
    plan = _jax_plan(stages, bound)
    return jax_cascade_eval_ref(
        REC, JAX_F10.attr_idx, JAX_F10.threshold, JAX_F10.child, JAX_F10.class_val,
        max_depth=JAX_F10.max_depth, order=plan.order, stage_sizes=plan.stage_sizes,
        n_classes=5, bound=bound,
    )


# -- plan geometry -----------------------------------------------------------


def test_exit_enabling_prefix():
    # k trees can decide against T-k outstanding only if margin k > (T-k)·b
    for t in (2, 3, 8, 16, 33):
        for b in (1.0, 0.5, 0.25):
            k = exit_enabling_prefix(t, b)
            assert k == jax_exit_enabling_prefix(t, b)
            assert k > b * (t - k)                    # the prefix can decide
            assert k == 1 or (k - 1) <= b * (t - (k - 1))  # and is minimal


def test_plan_cascade_geometry_and_validation():
    forest = _port(_jax_forest(n_trees=16))
    rec = _records(256, 9, seed=3)
    plan = plan_cascade(forest, rec, n_classes=6, stages=3, bound=1.0, device="cpu")
    assert plan.n_trees == 16 and plan.n_stages == 3
    assert sum(plan.stage_sizes) == 16
    assert sorted(plan.order) == list(range(16))
    assert plan.stage_sizes[0] >= exit_enabling_prefix(16, 1.0)
    assert plan.stage_trees(1) == plan.order[plan.stage_sizes[0]:sum(plan.stage_sizes[:2])]
    with pytest.raises(ValueError):
        CascadePlan(order=tuple(range(16)), stage_sizes=(8, 9))   # not a partition
    with pytest.raises(ValueError):
        CascadePlan(order=(0, 0, 1), stage_sizes=(2, 1))          # not a permutation
    with pytest.raises(ValueError):
        CascadePlan(order=(0, 1), stage_sizes=(2, 0))             # empty stage
    with pytest.raises(ValueError, match="permutation"):
        plan_cascade(forest, n_classes=6, order=(0, 1, 2))
    with pytest.raises(ValueError, match="bound must be positive"):
        plan_cascade(forest, n_classes=6, bound=0.0)


def test_plan_respects_explicit_order():
    order = tuple(reversed(range(10)))
    plan = plan_cascade(F10, n_classes=5, stages=2, order=order)
    assert plan.order == order
    assert plan_cascade(F10, n_classes=5, stages=1).stage_sizes == (10,)


@pytest.mark.parametrize("stages", [1, 2, 3, 4, 12])
@pytest.mark.parametrize("bound", BOUNDS)
def test_plan_and_rank_match_jax(stages, bound):
    got = plan_cascade(F10, REC, n_classes=5, stages=stages, bound=bound, device="cpu")
    want = _jax_plan(stages, bound)
    assert (got.order, got.stage_sizes) == (want.order, want.stage_sizes)


@pytest.mark.parametrize("sample", [1, 64, 512])
def test_rank_trees_matches_jax(sample):
    forest = _jax_forest(n_trees=16, n_classes=6, seed0=3)
    rec = _records(200, 9, seed=sample)
    got = rank_trees(_port(forest), rec, n_classes=6, sample=sample, device="cpu")
    assert got == jax_rank_trees(forest, rec, n_classes=6, sample=sample)
    assert rank_trees(_port(forest), cpu(rec), n_classes=6, sample=sample) == got   # tensor input
    assert rank_trees(_port(forest), rec[:0], n_classes=6) == tuple(range(16))


# -- the fused vote primitive ------------------------------------------------


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("n_classes", [1, 3, 5, 8])
def test_forest_votes_fused_matches_jax(algorithm, jump_mode, n_classes):
    """n_classes below the forest's 5 drops the votes of the classes above it."""
    rec = _records(200, 9, seed=11)
    want = jax_forest_votes_fused(rec, JAX_F10, n_classes=n_classes, algorithm=algorithm,
                                  jump_mode=jump_mode, block_m=64, interpret=True)
    got = forest_votes_fused(rec, F10, n_classes=n_classes, algorithm=algorithm,
                             jump_mode=jump_mode, device="cpu")
    assert got.dtype == torch.int32
    assert_same(got, want, f"{algorithm}/{jump_mode}/C={n_classes}")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_forest_votes_fused_fixtures_match_jax(algorithm, jump_mode):
    """The conformance forest and adversarial records, explicit block_m."""
    want = jax_forest_votes_fused(RECORDS, FOREST, n_classes=N_CLASSES, algorithm=algorithm,
                                  jump_mode=jump_mode, block_m=16, interpret=True)
    packed = ops.PackedForest(PORT_FOREST, RECORDS.shape[1], device="cpu")
    got = forest_votes_fused(cpu(RECORDS), packed, n_classes=N_CLASSES, algorithm=algorithm,
                             jump_mode=jump_mode, block_m=16)
    assert_same(got, want, f"fixtures/{algorithm}/{jump_mode}")
    per_tree = ops.forest_eval_fused(cpu(RECORDS), packed, algorithm=algorithm, jump_mode=jump_mode)
    assert_same(got.sum(1), np.full(RECORDS.shape[0], FOREST.n_trees), "one vote per tree")


def test_cascade_conforms_on_fixtures():
    """``test_conformance.py``'s cascade case: bound 1.0 equals the majority vote."""
    want = np.asarray(jax_majority_vote(jax_forest_eval_ref(
        jnp.asarray(RECORDS), *map(jnp.asarray, (FOREST.attr_idx, FOREST.threshold, FOREST.child,
                                                 FOREST.class_val)),
        max_depth=FOREST.max_depth), N_CLASSES))
    got = eval_cascade(PORT_FOREST, cpu(RECORDS), n_classes=N_CLASSES, bound=1.0)
    assert_same(got.classes, want, "cascade/bound=1.0")
    _assert_result(got, jax_eval_cascade(FOREST, jnp.asarray(RECORDS), n_classes=N_CLASSES, bound=1.0),
                   "fixtures")


# -- the evaluator against the JAX package -----------------------------------


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("bound", BOUNDS)
def test_cascade_matches_jax_jnp_and_ref(engine, algorithm, jump_mode, stages, bound):
    plan = plan_cascade(F10, REC, n_classes=5, stages=stages, bound=bound, device="cpu")
    ev = CascadeEvaluator(F10, plan, n_classes=5, bound=bound, engine=engine,
                          algorithm=algorithm, jump_mode=jump_mode, device="cpu")
    got = ev(REC)
    label = f"{engine}/{algorithm}/{jump_mode}/stages={stages}/bound={bound}"
    _assert_result(got, _jax_jnp(algorithm, jump_mode, stages, bound), label)
    for field, want in zip(REF_FIELDS, _jax_ref(stages, bound)):
        assert_same(getattr(got, field), want, f"{label}: ref {field}")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("bound", [1.0, 0.5])
def test_cascade_matches_jax_pallas_interpret(algorithm, jump_mode, bound):
    jax_plan = _jax_plan(3, bound)
    want = JaxCascadeEvaluator(JAX_F10, jax_plan, n_classes=5, bound=bound, engine="pallas",
                               interpret=True, algorithm=algorithm, jump_mode=jump_mode,
                               block_m=64)(REC)
    plan = CascadePlan(order=jax_plan.order, stage_sizes=jax_plan.stage_sizes)
    got = CascadeEvaluator(F10, plan, n_classes=5, bound=bound, engine="cuda", algorithm=algorithm,
                           jump_mode=jump_mode, block_m=64, device="cpu")(cpu(REC))
    _assert_result(got, want, f"pallas/{algorithm}/{jump_mode}/bound={bound}")


@pytest.mark.parametrize("bound", [None, 1.0, 0.25])
def test_eval_forest_cascade_matches_jax(bound):
    got = eval_forest_cascade(F10, REC, n_classes=5, stages=3, bound=bound, device="cpu")
    want = jax_eval_forest_cascade(JAX_F10, REC, n_classes=5, stages=3, bound=bound, engine="jnp")
    _assert_result(got, want, f"eval_forest_cascade/bound={bound}")
    if bound in (None, 1.0):
        per_tree = ops.forest_eval_fused(REC, F10, device="cpu")
        assert_same(got.classes, majority_vote(per_tree, 5), "exact bound = majority vote")


def test_cascade_exact_parity_with_full_forest():
    forest = _port(_jax_forest(n_trees=12))
    rec = _records(700, 9, seed=1)
    want = majority_vote(ops.forest_eval_fused(rec, forest, device="cpu"), 6)
    for bound in (None, 1.0):
        res = eval_forest_cascade(forest, rec, n_classes=6, stages=3, bound=bound, device="cpu")
        assert_same(res.classes, want, f"bound={bound}")
    exited = res.exit_stage >= 0
    remaining = forest.n_trees - res.trees_evaluated
    assert bool((res.margin[exited] > remaining[exited]).all())
    assert bool((res.trees_evaluated[~exited] == forest.n_trees).all())
    assert bool(((res.confidence >= 0) & (res.confidence <= 1)).all())


# -- the oracle ---------------------------------------------------------------


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("bound", BOUNDS)
def test_vectorised_ref_matches_jax_loop(stages, bound):
    got = cascade_eval_ref(REC, F10.attr_idx, F10.threshold, F10.child, F10.class_val,
                           max_depth=F10.max_depth, order=_jax_plan(stages, bound).order,
                           stage_sizes=_jax_plan(stages, bound).stage_sizes, n_classes=5,
                           bound=bound, device="cpu")
    for field, want in zip(REF_FIELDS, _jax_ref(stages, bound)):
        assert_same(getattr(got, field), want, f"ref {field}")
    if stages > 1:    # margin and confidence follow the evaluator's definitions
        res = _jax_jnp("speculative", "gather", stages, bound)
        assert_same(got.margin, res.margin, "ref margin")
        assert_same(got.confidence, res.confidence, "ref confidence")


# -- traps ---------------------------------------------------------------------


def _single_leaf_forest(n_trees: int, cls: int = 0):
    jf = JaxForest([breadth_first_encode(Node(class_val=cls))] * n_trees)
    return jf, _port(jf)


def test_exit_test_compares_in_float64():
    """29 unanimous votes against 0.58·50 = 28.999999999999996 remaining:
    numpy (float64) exits, a float32 comparison (29 > 29.0) would not."""
    assert not bool(torch.tensor([29], dtype=torch.int32) > 0.58 * 50)   # the trap itself
    jf, f = _single_leaf_forest(79)
    rec = _records(16, 3, seed=0)
    plan = CascadePlan(order=tuple(range(79)), stage_sizes=(29, 50))
    want = JaxCascadeEvaluator(jf, JaxCascadePlan(plan.order, plan.stage_sizes), n_classes=3,
                               bound=0.58, engine="jnp")(rec)
    assert np.all(np.asarray(want.exit_stage) == 0)
    ref = jax_cascade_eval_ref(rec, jf.attr_idx, jf.threshold, jf.child, jf.class_val, max_depth=1,
                               order=plan.order, stage_sizes=plan.stage_sizes, n_classes=3, bound=0.58)
    assert np.all(ref[1] == 0)
    for engine in ("cuda", "torch"):
        got = CascadeEvaluator(f, plan, n_classes=3, bound=0.58, engine=engine, device="cpu")(rec)
        _assert_result(got, want, engine)
        assert got.stages_run == 1 and got.stage_survivors == (16,)
    port_ref = cascade_eval_ref(rec, f.attr_idx, f.threshold, f.child, f.class_val, max_depth=1,
                                order=plan.order, stage_sizes=plan.stage_sizes, n_classes=3, bound=0.58,
                                device="cpu")
    assert np.all(port_ref.exit_stage == 0)


def test_ties_go_to_the_lowest_class():
    """Two trees vote 4 and 1: a tie; the lowest class wins, margin 0."""
    jf4, _ = _single_leaf_forest(1, cls=4)
    jf1, _ = _single_leaf_forest(1, cls=1)
    jf = JaxForest([jf4.tree(0), jf1.tree(0)])
    f = _port(jf)
    rec = _records(5, 3, seed=1)
    want = JaxCascadeEvaluator(jf, n_classes=6, bound=None, engine="jnp")(rec)
    assert np.all(np.asarray(want.classes) == 1) and np.all(np.asarray(want.margin) == 0)
    for engine in ("cuda", "torch"):
        for bound in (None, 1.0):
            got = CascadeEvaluator(f, n_classes=6, bound=bound, engine=engine, device="cpu")(rec)
            _assert_result(got, want, f"{engine}/bound={bound}")
    ref = cascade_ref_from_classes(np.array([[4] * 5, [1] * 5]), order=(0, 1), stage_sizes=(1, 1),
                                   n_classes=6, bound=1.0)
    assert np.all(ref.classes == 1) and np.all(ref.margin == 0)


# -- property: early exits are provably unflippable --------------------------


@settings(max_examples=10, deadline=None)
@given(
    n_trees=st.integers(4, 20),
    stages=st.integers(2, 4),
    n_classes=st.integers(2, 7),
    seed=st.integers(0, 1000),
)
def test_early_exit_margins_unflippable(n_trees, stages, n_classes, seed):
    forest = _port(_jax_forest(n_trees=n_trees, n_classes=n_classes, seed0=seed % 17))
    rec = _records(120, 9, seed=seed)
    plan = plan_cascade(forest, rec[:64], n_classes=n_classes, stages=stages, bound=1.0, device="cpu")
    res = eval_forest_cascade(forest, rec, n_classes=n_classes, plan=plan, bound=1.0, device="cpu")
    per_tree = ops.forest_eval_fused(rec, forest, device="cpu").numpy()       # (T, M)
    classes, exit_stage = res.classes.numpy(), res.exit_stage.numpy()
    trees_eval = res.trees_evaluated.numpy()
    order = np.asarray(plan.order)
    for i in np.flatnonzero(exit_stage >= 0):
        k = int(trees_eval[i])
        votes = np.bincount(per_tree[order[:k], i], minlength=n_classes)
        top1 = int(votes.argmax())
        assert top1 == classes[i]
        # adversarial completion: hand every unseen tree to the runner-up —
        # the exit class must still win outright
        adv = votes.copy()
        adv[top1] = -1
        runner = int(adv.argmax())
        worst = votes.copy()
        worst[runner] += n_trees - k
        assert votes[top1] > worst[runner]
        full = np.bincount(per_tree[:, i], minlength=n_classes)
        assert int(full.argmax()) == top1


# -- anytime deadlines -------------------------------------------------------


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_deadline_zero_runs_only_the_first_stage(engine):
    plan = plan_cascade(F10, REC, n_classes=5, stages=3, bound=None, device="cpu")
    ev = CascadeEvaluator(F10, plan, n_classes=5, bound=None, engine=engine, device="cpu")
    res = ev(REC, deadline_ms=0)
    assert res.stages_run == 1 and res.stage_survivors == (300,)
    assert bool((res.trees_evaluated == plan.stage_sizes[0]).all())
    assert bool((res.exit_stage == -1).all())
    remaining = 10 - plan.stage_sizes[0]
    want = np.clip(res.margin.numpy() / remaining, 0.0, 1.0).astype(np.float32)
    assert_same(res.confidence, want, "partial-margin confidence")
    full = ev(REC, deadline_ms=1e9)
    assert full.stages_run == 3 and bool((full.trees_evaluated == 10).all())
    assert bool((full.confidence == 1.0).all())
    assert {k[0] for k in ev._stage_ms} == {0, 1, 2}      # every stage's latency was learnt


def test_deadline_uses_the_learnt_stage_latency():
    plan = plan_cascade(F10, REC, n_classes=5, stages=2, bound=None, device="cpu")
    ev = CascadeEvaluator(F10, plan, n_classes=5, bound=None, device="cpu")
    ev(REC)
    ev._stage_ms[(1, 512)] = 1e6                        # stage 1 predicted to take 1000 s
    assert ev(REC, deadline_ms=1e5).stages_run == 1
    assert ev._stage_estimate_ms(1, 300) == 1e6 and ev._stage_estimate_ms(1, 3) == 1e6
    assert ev._stage_estimate_ms(0, 300) > 0 and ev._stage_estimate_ms(5, 300) == 0.0


# -- metrics, spans, registry --------------------------------------------------


def test_cascade_metrics_and_spans_match_jax():
    plan = _jax_plan(3, 1.0)
    reg, tr = obs.Registry(), obs.Tracer()
    got = CascadeEvaluator(F10, CascadePlan(plan.order, plan.stage_sizes), n_classes=5, bound=1.0,
                           registry=reg, tracer=tr, device="cpu")(REC)
    from repro import obs as jax_obs

    jreg, jtr = jax_obs.Registry(), jax_obs.Tracer()
    JaxCascadeEvaluator(JAX_F10, plan, n_classes=5, bound=1.0, engine="jnp", registry=jreg, tracer=jtr)(REC)
    snap, jsnap = obs.snapshot(reg), jax_obs.snapshot(jreg)
    assert snap["counters"] == jsnap["counters"] == {"cascade.evals": 1.0, "cascade.records": 300.0}
    assert set(snap["histograms"]) == set(jsnap["histograms"])
    for key in ('cascade.stage_survival{stage="0"}', 'cascade.stage_survival{stage="1"}',
                "cascade.exit_margin"):
        for field in ("count", "sum", "bucket_counts"):
            assert snap["histograms"][key][field] == jsnap["histograms"][key][field], (key, field)
    vocabulary = {e.name for e in jtr.events()}
    names = [(e.name, e.args.get("stage"), e.args.get("phase")) for e in tr.events()
             if e.name in vocabulary]
    assert names == [(e.name, e.args.get("stage"), e.args.get("phase")) for e in jtr.events()]
    (outer,) = [e for e in tr.events() if e.name == "cascade.eval"]
    assert outer.args["stages_run"] == got.stages_run == 3
    # the port's own spans: the syncs and observations of the stage loop lie
    # inside cascade.eval, the finish (and the exit margins' observation in
    # it) after it
    (finish,) = [e for e in tr.events() if e.name == "cascade.finish"]
    assert finish.ts_us >= outer.ts_us + outer.dur_us

    def inside(e, span):
        return span.ts_us <= e.ts_us and e.ts_us + e.dur_us <= span.ts_us + span.dur_us

    extra = [e for e in tr.events() if e.name not in vocabulary and e is not finish]
    assert {e.name for e in extra} == {"cascade.sync", "cascade.observe"}
    assert all(inside(e, outer) or inside(e, finish) for e in extra)
    assert sum(inside(e, finish) for e in extra) == 1


def test_cascade_variants_mirror_jax():
    assert set(CASCADE_VARIANTS) == {
        n.replace("_vmap_", "_batched_") for n in JAX_CASCADE_VARIANTS
    }
    for name, spec in CASCADE_VARIANTS.items():
        jax_name = name.replace("_batched_", "_vmap_")
        jspec = JAX_CASCADE_VARIANTS[jax_name]
        assert spec.family == jspec.family == CASCADE_FAMILY
        assert (spec.algorithm, spec.jump_mode, spec.tunables) == \
            (jspec.algorithm, jspec.jump_mode, jspec.tunables)
        assert spec.engine == {"pallas": "cuda", "jnp": "torch"}[jspec.engine]
    assert [s.name for s in list_cascade_variants(engine="cuda")] == [
        "forest_cascade_fused_data_parallel", "forest_cascade_fused_speculative_gather",
        "forest_cascade_fused_speculative_onehot"]
    assert MAJORITY_FAMILY == "forest_majority"
    with pytest.raises(KeyError, match="unknown cascade variant"):
        get_cascade_variant("forest_cascade_vmap_data_parallel")
    with pytest.raises(ValueError, match="already registered"):
        register_cascade_variant(get_cascade_variant("forest_cascade_fused_data_parallel"))


@pytest.mark.parametrize("name", sorted(CASCADE_VARIANTS))
def test_cascade_variants_build_exact_evaluators(name):
    spec = get_cascade_variant(name)
    ev = spec.build(F10, n_classes=5, stages=3, bound=1.0, calibration=REC, device="cpu")
    assert (ev.engine, ev.algorithm, ev.jump_mode) == (spec.engine, spec.algorithm, spec.jump_mode)
    _assert_result(ev(REC), _jax_jnp(spec.algorithm, spec.jump_mode, 3, 1.0), name)


def test_evaluator_defaults_and_refusals():
    assert CascadeEvaluator(F10, n_classes=5, device="cpu").engine == "torch"
    with pytest.raises(ValueError, match="unknown engine"):
        CascadeEvaluator(F10, n_classes=5, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="bound must be positive"):
        CascadeEvaluator(F10, n_classes=5, bound=-1.0, device="cpu")
    with pytest.raises(ValueError, match="plan covers"):
        CascadeEvaluator(F10, CascadePlan((0, 1), (2,)), n_classes=5, device="cpu")
    ev = CascadeEvaluator(F10, n_classes=5, device="cpu")
    with pytest.raises(ValueError, match="records must be"):
        ev(REC[0])
    empty = ev(REC[:0])
    assert empty.stages_run == 0 and empty.classes.shape == (0,)


# -- the margin pass -----------------------------------------------------------

MARGIN_BOUNDARIES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tally(m: int, c: int, t: int, seed: int) -> np.ndarray:
    """(m, c) int32 vote counts of ``t`` trees: rows led by one class, rows
    split evenly (ties at the top), unanimous rows and empty rows."""
    rng = np.random.default_rng(seed)
    lead = rng.integers(0, c, m)
    p = np.full((m, c), 1.0 / c)
    p[np.arange(m), lead] += rng.uniform(0.0, 3.0, m)
    votes = rng.multinomial(t, p / p.sum(1, keepdims=True)).astype(np.int32)
    k = m // 8
    votes[:k] = 0
    votes[:k, :2] = t // 2                                   # a tie between classes 0 and 1
    votes[k:2 * k] = 0
    votes[k:2 * k, c - 1] = t                                # unanimous, the last class
    votes[2 * k:2 * k + 2] = 0                               # no tree voted
    return votes


def _np_margin(votes: np.ndarray):
    top = np.sort(votes, axis=1)
    return votes.argmax(1).astype(np.int32), (top[:, -1] - top[:, -2]).astype(np.int32)


def _margin_histogram():
    return obs.Registry().histogram("cascade.exit_margin", boundaries=MARGIN_BOUNDARIES)


@pytest.mark.parametrize("c", [2, 3, 7, 16])
def test_margin_plain_versions_match_numpy(c):
    """Winner, margin, confidence and the histogram against NumPy; the exit test
    against a float64 comparison, with margins past the last boundary."""
    t_total = 400
    hist, want_hist, margins = _margin_histogram(), _margin_histogram(), []
    for call in range(3):
        votes = _tally(300, c, t_total - 100 * call, seed=c + call)
        trees = np.full(300, t_total - 100 * call, np.int32)
        trees[::3] = t_total
        classes, mar, conf = margin.finish(torch.from_numpy(votes), torch.from_numpy(trees), t_total,
                                           hist)
        want_classes, want_margin = _np_margin(votes)
        assert_same(classes, want_classes, "classes")
        assert_same(mar, want_margin, "margin")
        rem = t_total - trees
        want_conf = np.where(rem <= 0, 1.0, np.clip(want_margin / np.maximum(rem, 1), 0.0, 1.0))
        assert_same(conf, want_conf.astype(np.float32), "confidence")
        margins.append(want_margin)
        want_hist.observe_many(want_margin)
        assert hist.state() == want_hist.state()
    assert max(np.concatenate(margins)) > MARGIN_BOUNDARIES[-1]
    votes = _tally(300, c, 50, seed=c)
    for alive in (np.arange(300), np.flatnonzero(np.arange(300) % 3), np.arange(0)):
        exit_stage = torch.full((300,), -1, dtype=torch.int32)
        keep = margin.exit_test_plain(torch.from_numpy(votes), torch.from_numpy(alive), 2, 0.58 * 50,
                                      exit_stage)
        decided = _np_margin(votes)[1][alive].astype(np.float64) > 0.58 * 50
        assert_same(keep, ~decided, "keep")
        want = np.full(300, -1, np.int32)
        want[alive[decided]] = 2
        assert_same(exit_stage, want, "exit_stage")


def test_margin_wrappers_refuse_what_the_kernels_do_not_take():
    votes = torch.empty((4, 7), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        margin.finish(votes, torch.empty((4,), dtype=torch.int32, device="meta"), 7)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        margin.exit_test(votes, torch.empty((2,), dtype=torch.int64, device="meta"), 0, 1.0,
                         torch.empty((4,), dtype=torch.int32, device="meta"))


def _card_margin_case(dev, m: int, c: int, seed: int) -> None:
    t_total = 300 + seed
    votes_np = _tally(m, c, t_total, seed)
    votes, cpu_votes = torch.from_numpy(votes_np).to(dev), torch.from_numpy(votes_np)
    rng = np.random.default_rng(seed)
    before = dict(margin.LAUNCHES)
    subsets = (np.arange(m), np.sort(rng.choice(m, size=max(m // 3, 1), replace=False)), np.arange(0))
    thresholds = (0.58 * 50, 0.0, float(t_total // 2))
    for alive_np, thr in zip(subsets, thresholds):
        stage = int(rng.integers(0, 4))
        init = rng.integers(-1, 2, m).astype(np.int32)
        got_stage, want_stage = torch.from_numpy(init).to(dev), torch.from_numpy(init.copy())
        keep = margin.exit_test(votes, torch.from_numpy(alive_np).to(dev), stage, thr, got_stage)
        want = margin.exit_test_plain(cpu_votes, torch.from_numpy(alive_np), stage, thr, want_stage)
        assert keep.dtype == torch.bool and keep.device == votes.device
        assert_same(keep, want.numpy(), f"keep m={m} c={c} thr={thr}")
        assert_same(got_stage, want_stage.numpy(), f"exit_stage m={m} c={c} thr={thr}")
    hist, want_hist = _margin_histogram(), _margin_histogram()
    for call in range(3):
        trees_np = np.minimum(rng.integers(t_total - 60, t_total + 60, m), t_total).astype(np.int32)
        got = margin.finish(votes, torch.from_numpy(trees_np).to(dev), t_total, hist)
        want = margin.finish(cpu_votes, torch.from_numpy(trees_np), t_total, want_hist)
        for name, g, w in zip(("classes", "margin", "confidence"), got, want):
            assert g.dtype == w.dtype, name
            assert_same(g, w.numpy(), f"{name} m={m} c={c} call {call}")
        assert hist.state() == want_hist.state(), f"histogram m={m} c={c} call {call}"
    unbinned = margin.finish(votes, torch.from_numpy(trees_np).to(dev), t_total)
    assert all(torch.equal(g, w.to(dev)) for g, w in zip(unbinned, want))
    torch.cuda.synchronize()
    assert margin.LAUNCHES["exit_test"] - before["exit_test"] == 2      # none for no survivors
    assert margin.LAUNCHES["finish"] - before["finish"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 3, 7, 16])
def test_margin_kernels_equal_plain_on_card(cuda_device, c):
    """Both kernels against their plain versions, bit for bit: ties, the
    float64 trap (29 against 0.58·50), M off the 256-row block, one record,
    no survivors, and margins past the last boundary (T ≥ 300)."""
    for m, seed in ((1, 1), (300, 2), (65_536, 3)):
        _card_margin_case(cuda_device, m, c, seed)


@pytest.mark.gpu
def test_margin_bins_under_streams(cuda_device):
    """Finishes on four threads, each on a stream of its own, bin into one
    histogram while another thread reads it: every read is whole (the
    buckets sum to the count, the least and greatest lie among the
    margins), and the last equals ``observe_many`` of every margin."""
    t_total, m = 300, 65_536
    tallies = [torch.from_numpy(_tally(m, 7, t_total, seed=20 + i)).to(cuda_device) for i in range(4)]
    trees = torch.full((m,), t_total, dtype=torch.int32, device=cuda_device)
    hist = _margin_histogram()
    margins, errors, torn, stop = [], [], [], threading.Event()

    def serve(votes):
        try:
            with torch.cuda.stream(torch.cuda.Stream(device=cuda_device)):
                for _ in range(25):
                    margins.append(margin.finish(votes, trees, t_total, hist)[1])
                torch.cuda.current_stream(cuda_device).synchronize()
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    def read():
        while not stop.is_set():
            st = hist.state()
            if sum(st["bucket_counts"]) != st["count"] or (
                    st["count"] and not 0 <= st["min"] <= st["max"] <= t_total):
                torn.append(st)

    reader = threading.Thread(target=read)
    workers = [threading.Thread(target=serve, args=(v,)) for v in tallies]
    reader.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    stop.set()
    reader.join(timeout=30)
    assert not errors and not torn and not reader.is_alive() and not any(w.is_alive() for w in workers)
    want = _margin_histogram()
    want.observe_many(torch.cat(margins).cpu().numpy())
    assert len(margins) == 100 and hist.state() == want.state()


def _frame_forest(n_attrs: int = 19, n_classes: int = 7) -> EncodedForest:
    """50 trees as ``forest-frame``'s plan takes them (26 + 24): 25 vote
    class 2 whatever the record and go first, 25 are random, so a record
    exits after the first stage where its random tree there votes 2 too."""
    trees = [PortNode(class_val=2)] * 25 + [
        port_random_tree(n_attrs=n_attrs, n_classes=n_classes, max_depth=6, seed=i) for i in range(25)]
    return EncodedForest([port_encode(t) for t in trees])


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_cascade_on_card_equals_cpu(cuda_device, engine):
    """A whole evaluator on the card equals it on the CPU, field for field and
    in its exit-margin histogram, and adds two margin launches a call."""
    forest = _frame_forest()
    rec = _records(4_099, 19, seed=5)
    plan = plan_cascade(forest, rec[:512], n_classes=7, stages=2, bound=1.0, device="cpu")
    assert plan.stage_sizes == (26, 24)
    regs = {"card": obs.Registry(), "cpu": obs.Registry()}
    card = CascadeEvaluator(forest, plan, n_classes=7, bound=1.0, engine=engine, registry=regs["card"],
                            device=cuda_device)
    host = CascadeEvaluator(forest, plan, n_classes=7, bound=1.0, engine=engine, registry=regs["cpu"],
                            device="cpu")
    before = dict(margin.LAUNCHES)
    for seed in range(3):
        batch = _records(4_099, 19, seed=10 + seed)
        got, want = card(torch.from_numpy(batch).to(cuda_device)), host(batch)
        for field in FIELDS:
            assert_same(getattr(got, field), getattr(want, field).numpy(), f"{engine} {field}")
        assert got.stage_survivors == want.stage_survivors and got.stages_run == want.stages_run == 2
        assert 0 < got.stage_survivors[1] < 4_099
    assert {k: margin.LAUNCHES[k] - before[k] for k in before} == {"exit_test": 3, "finish": 3}
    snaps = {k: obs.snapshot(r)["histograms"]["cascade.exit_margin"] for k, r in regs.items()}
    assert snaps["card"] == snaps["cpu"] and snaps["card"]["count"] == 3 * 4_099


def test_margin_kernels_read_as_time_outside_the_tree_kernels():
    """The benchmark reads K1–K8 by their frozen names; the margin kernels'
    names match none of them, so their time counts as the vote's."""
    trace_reader = pytest.importorskip("perfbench.trace_reader")
    src = margin.SOURCE.read_text()
    defined = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\(\w+\)\s*)?(\w+)\s*\(", src)
    assert sorted(defined) == ["cascade_exit_test_kernel", "cascade_finish_kernel"]
    for name in defined:
        assert not trace_reader.is_tree_kernel(f"void (anonymous namespace)::{name}(int const*, int)")


def test_exit_margin_histogram_under_threads():
    """Evaluators on 12 threads (more than the cores) share a registry while
    another thread reads it: no margin is lost or counted twice."""
    reg = obs.Registry()
    plan = plan_cascade(F10, REC, n_classes=5, stages=2, bound=1.0, device="cpu")
    evs = [CascadeEvaluator(F10, plan, n_classes=5, bound=1.0, registry=reg, device="cpu")
           for _ in range(12)]
    hist = reg.histogram("cascade.exit_margin", "final top-1 minus top-2 vote margins",
                         boundaries=MARGIN_BOUNDARIES)
    margins, errors, stop = [], [], threading.Event()

    def serve(ev):
        try:
            for _ in range(8):
                margins.append(ev(REC).margin.numpy())
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    def read():
        while not stop.is_set():
            obs.snapshot(reg)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        workers = [threading.Thread(target=serve, args=(ev,)) for ev in evs]
        reader.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        stop.set()
        reader.join(timeout=30)
    finally:
        sys.setswitchinterval(saved)
    assert not errors and not reader.is_alive() and not any(w.is_alive() for w in workers)
    want = obs.Registry().histogram("m", boundaries=MARGIN_BOUNDARIES)
    want.observe_many(np.concatenate(margins))
    assert len(margins) == 96 and hist.state() == want.state()
