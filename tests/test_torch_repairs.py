"""Faults of the port found against the reference, each pinned by a test.

1. Large trees on CPU tensors: every entry point evaluates a tree too large
   for any record tile of a CTA, as the JAX package does (the plain versions
   take no tile); only a CUDA tensor gets the tile refusal.
2. Subnormals: the port compares as IEEE does, as ``eval_serial`` does; the
   JAX package on XLA's CPU flushes them to zero, so this is held against
   ``eval_serial`` only, and parity tests keep subnormals out of their
   inputs.
3. ``sanitize_records`` on the speculative paths (±inf → ±FLT_MAX, NaN →
   −FLT_MAX): the port equals the JAX package there, and both differ from
   ``eval_serial`` on the rows shown, so the port cannot drift on its own.
4. The background re-tune ranked candidates by host contention: a sample is
   now the call's device time with the host's enqueue hidden behind a spin,
   checked and retaken when the spin ran out, and a candidate's score adds
   the host price of its launches.  The arithmetic and the retry rule are
   held here with fake events; the card test
   ``test_torch_device.py::test_sweep_under_serving_load_picks_the_same_algorithm_on_card``
   holds the sweep under load.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import Node as JaxNode
from repro.core import breadth_first_encode as jax_encode
from repro.core import eval_speculative_tree as jax_eval_speculative_tree
from repro.core import perfect_tree as jax_perfect_tree
from repro.core.forest import EncodedForest as JaxForest
from repro.core.forest import majority_vote as jax_majority_vote
from repro.kernels.tree_eval import forest_eval_fused as jax_forest_eval_fused
from repro.kernels.tree_eval import forest_eval_fused_q as jax_forest_eval_fused_q
from repro.kernels.tree_eval import forest_votes_fused as jax_forest_votes_fused
from repro.kernels.tree_eval import tree_eval as jax_tree_eval
from repro_torch.core import (
    BOTTOM,
    EncodedForest,
    EncodedTree,
    eval_data_parallel_tree,
    eval_forest_cascade,
    eval_serial,
    eval_speculative_tree,
    random_tree,
    breadth_first_encode,
    vote_winner,
)
from repro_torch.kernels.tree_eval import QuantizedForest, ops, profile_tree_eval
from repro_torch.kernels.tree_eval import kernel as K

from torch_parity import assert_same

MODES = [("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")]
FLT_MAX = np.float32(np.finfo(np.float32).max)


def _records(m, a, seed):
    return np.random.default_rng(seed).normal(size=(m, a)).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. large trees on CPU tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big_forest():
    """A 16,383-node perfect tree and two smaller ones padded to it, A 19."""
    trees = [jax_encode(jax_perfect_tree(d, 19, 7, seed=d)) for d in (13, 9, 5)]
    jf = JaxForest(trees)
    return jf, EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


def test_choose_block_m_still_refuses_the_tree():
    """The tile model has no tile for it: a CUDA tensor would get this error."""
    for algorithm, jump_mode in MODES[:2]:
        with pytest.raises(K.TileError, match="no .* record tile fits"):
            ops.choose_block_m(16_383, 19, algorithm=algorithm, jump_mode=jump_mode)


def test_large_tree_entry_points_on_cpu_equal_jax(big_forest):
    jf, f = big_forest
    assert f.n_nodes == 16_383
    rec = _records(64, 19, seed=1)
    cpu = torch.from_numpy(rec)
    # the JAX package's gather and data-parallel forms (its one-hot form at
    # this N takes ~20 s in interpret mode); all forms compute one function
    want_tree = np.asarray(jax_tree_eval(rec, jf.tree(0), algorithm="speculative", jump_mode="gather"))
    assert_same(want_tree, np.asarray(jax_tree_eval(rec, jf.tree(0), algorithm="data_parallel")), "jax")
    want = np.asarray(jax_forest_eval_fused(rec, jf, algorithm="data_parallel"))
    assert_same(want, np.asarray(jax_forest_eval_fused(rec, jf, algorithm="speculative")), "jax fused")
    want_votes = np.asarray(jax_forest_votes_fused(rec, jf, n_classes=7, algorithm="data_parallel"))
    for algorithm, jump_mode in MODES:
        kw = dict(algorithm=algorithm, jump_mode=jump_mode)
        assert_same(ops.tree_eval(rec, f.tree(0), device="cpu", **kw), want_tree, f"tree_eval {kw}")
        assert_same(ops.forest_eval_fused(cpu, f, **kw), want, f"forest_eval_fused {kw}")
        assert_same(ops.forest_votes_fused(cpu, f, n_classes=7, **kw), want_votes, f"forest_votes_fused {kw}")
    for algorithm in ("speculative", "data_parallel"):
        got = ops.forest_eval_fused_q(cpu, QuantizedForest(f, 19, device="cpu"), algorithm=algorithm)
        assert_same(got, np.asarray(jax_forest_eval_fused_q(rec, jf, algorithm=algorithm)), f"q {algorithm}")
    # the cascade's default engine on the host runs the vote kernels' plain versions
    res = eval_forest_cascade(f, cpu, n_classes=7, engine="cuda", bound=None)
    assert_same(res.classes, np.asarray(jax_majority_vote(want, 7)), "cascade")
    assert_same(vote_winner(torch.from_numpy(np.array(want_votes))), np.asarray(jax_majority_vote(want, 7)), "votes")


def test_32767_node_tree_at_four_attributes_on_cpu_equals_jax():
    enc = jax_encode(jax_perfect_tree(14, 4, 5, seed=3))
    assert enc.n_nodes == 32_767
    rec = _records(48, 4, seed=2)
    want = np.asarray(jax_tree_eval(rec, enc, algorithm="data_parallel"))
    port = EncodedTree.from_arrays(*enc)
    for algorithm, jump_mode in MODES:
        got = ops.tree_eval(rec, port, algorithm=algorithm, jump_mode=jump_mode, device="cpu")
        assert_same(got, want, f"{algorithm}/{jump_mode}")


# ---------------------------------------------------------------------------
# 2. subnormals: IEEE compares, as eval_serial
# ---------------------------------------------------------------------------


SUBNORMALS = np.array([1e-45, -1e-45, 1e-40, -1e-40, 2.0**-140, -(2.0**-140), 0.0, -0.0], np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_port_keeps_subnormals_as_eval_serial_does(seed):
    rng = np.random.default_rng(seed)
    enc = breadth_first_encode(random_tree(n_attrs=5, n_classes=4, max_depth=6, seed=seed, balance=0.7))
    thr = enc.threshold.copy()
    split = enc.class_val == BOTTOM
    thr[split] = rng.choice(SUBNORMALS, int(split.sum()))
    enc = EncodedTree(enc.attr_idx, thr, enc.child, enc.class_val)
    rec = rng.choice(SUBNORMALS, size=(300, 5)).astype(np.float32)
    assert (np.abs(rec[rec != 0]) < np.finfo(np.float32).tiny).any()
    want = eval_serial(enc, rec)
    cpu = torch.from_numpy(rec)
    for algorithm, jump_mode in MODES:
        assert_same(ops.tree_eval(cpu, enc, algorithm=algorithm, jump_mode=jump_mode), want, jump_mode)
    for onehot in (False, True):
        assert_same(eval_speculative_tree(enc, cpu, max_depth=6, use_onehot_matmul=onehot), want, "core spec")
    assert_same(eval_data_parallel_tree(enc, cpu, max_depth=6), want, "core dp")
    assert_same(profile_tree_eval(cpu, enc).classes, want, "profile")
    forest = EncodedForest([enc, enc])
    for algorithm, jump_mode in MODES:
        assert_same(ops.forest_eval_fused(cpu, forest, algorithm=algorithm, jump_mode=jump_mode),
                    np.stack([want, want]), f"fused {jump_mode}")
        votes = ops.forest_votes_fused(cpu, forest, n_classes=4, algorithm=algorithm, jump_mode=jump_mode)
        assert_same(vote_winner(votes), want, f"votes {jump_mode}")
    for thr_dtype in ("bfloat16", "float16"):
        q = QuantizedForest(forest, 5, thr_dtype=thr_dtype, device="cpu")   # universal: exact for any input
        for algorithm in ("speculative", "data_parallel"):
            assert_same(ops.forest_eval_fused_q(cpu, q, algorithm=algorithm), np.stack([want, want]), "q")


# ---------------------------------------------------------------------------
# 3. the inherited sanitize_records clamping, pinned to the JAX package
# ---------------------------------------------------------------------------


def _stump(threshold) -> JaxNode:
    return JaxNode(attr=0, threshold=float(threshold), left=JaxNode(class_val=0), right=JaxNode(class_val=1))


def test_speculative_paths_clamp_as_the_jax_package_does():
    rec = np.zeros((4, 3), np.float32)
    rec[:, 0] = [np.inf, -np.inf, np.nan, 1.0]
    jforest = JaxForest([jax_encode(_stump(FLT_MAX)), jax_encode(_stump(-np.inf))])
    forest = EncodedForest.from_arrays(jforest.attr_idx, jforest.threshold, jforest.child, jforest.class_val)
    cpu = torch.from_numpy(rec)
    serial = np.stack([eval_serial(forest.tree(t), rec) for t in range(2)])
    # +inf > FLT_MAX goes right in the serial descent, left once clamped;
    # -inf and NaN > -inf go left in the serial descent, right once clamped
    assert serial.tolist() == [[1, 0, 0, 0], [1, 0, 0, 1]]
    clamped = [[0, 0, 0, 0], [1, 1, 1, 1]]
    for t in range(2):
        jtree = jforest.tree(t)
        for jump_mode in ("gather", "onehot"):
            want = np.asarray(jax_tree_eval(rec, jtree, algorithm="speculative", jump_mode=jump_mode))
            got = ops.tree_eval(cpu, forest.tree(t), algorithm="speculative", jump_mode=jump_mode)
            assert_same(got, want, f"tree {t} {jump_mode}")
            assert want.tolist() == clamped[t]
        want = np.asarray(jax_eval_speculative_tree(jtree, rec, max_depth=1, use_onehot_matmul=True))
        assert_same(eval_speculative_tree(forest.tree(t), cpu, max_depth=1, use_onehot_matmul=True), want, "core")
        assert want.tolist() == clamped[t]
        # the data-parallel path does not clamp: it is the serial descent
        assert_same(ops.tree_eval(cpu, forest.tree(t), algorithm="data_parallel"), serial[t], "dp")
    for jump_mode in ("gather", "onehot"):
        want = np.asarray(jax_forest_eval_fused(rec, jforest, algorithm="speculative", jump_mode=jump_mode))
        assert_same(ops.forest_eval_fused(cpu, forest, algorithm="speculative", jump_mode=jump_mode), want, "fused")
        assert want.tolist() == clamped
        want = np.asarray(jax_forest_votes_fused(rec, jforest, n_classes=2, algorithm="speculative",
                                                 jump_mode=jump_mode))
        got = ops.forest_votes_fused(cpu, forest, n_classes=2, algorithm="speculative", jump_mode=jump_mode)
        assert_same(got, want, "votes")


# ---------------------------------------------------------------------------
# 4. the tuner's samples hide the host, and its scores price the launches
# ---------------------------------------------------------------------------


class _FakeEvent:
    """A CUDA event stand-in: ``query`` reports the start as already reached
    while the shared ``late`` count lasts (the spin ran out), and
    ``elapsed_time`` is the record-order distance times 0.5 ms."""

    clock = 0
    late = 0

    def record(self, *a):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        if _FakeEvent.late:
            _FakeEvent.late -= 1
            return True
        return False

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 0.5 * (end.t - self.t)


@pytest.mark.parametrize("late", [0, 1, 3])
def test_contaminated_samples_are_retaken_with_a_longer_spin(late):
    from repro_torch.tune import measure

    _FakeEvent.late, spins, calls = late, [], []
    ms, spin = measure.hidden_sample(lambda: calls.append(1), spin_ms=1.0, spin=spins.append, event=_FakeEvent)
    assert ms == 0.5 and len(calls) == late + 1
    assert spins == [1.0 * measure.SPIN_GROWTH ** i for i in range(late + 1)] and spin == spins[-1]


def test_a_sample_the_spin_never_hides_raises_and_is_never_scored():
    from repro_torch.tune import measure

    _FakeEvent.late, spins = 10**6, []
    with pytest.raises(measure.HostNotHidden, match="outlasted"):
        measure.hidden_sample(lambda: None, spin_ms=1.0, tries=4, spin=spins.append, event=_FakeEvent)
    assert spins == [1.0, 4.0, 16.0, 64.0]
    _FakeEvent.late = 0


def test_score_adds_the_launches_of_one_call():
    from repro_torch.tune.measure import score_ms

    assert score_ms(0.004, 4, 4, 0.003) == pytest.approx(0.007)       # one launch a call
    assert score_ms(0.02, 64, 4, 0.003) == pytest.approx(0.068)       # the per-tree family: 16 a call
    assert score_ms(1.5, 0, 7, 0.003) == 1.5
    assert score_ms(1.5, 3, 0, 0.0) == 1.5


def test_measured_scores_on_the_card_path_and_the_host_clock(monkeypatch):
    """On a CUDA device the score is the median plus launches a call × the
    launch cost, with warmup calls counted; on the host it is the median."""
    from repro_torch.kernels.tree_eval import kernel as K
    from repro_torch.tune import measure
    from repro_torch.tune.space import Candidate

    def launching():
        K._THREAD.counts["data_parallel"] = K._THREAD.counts.get("data_parallel", 0) + 2

    def fake_time_callable(fn, *, warmup, iters, device, hide_host):
        assert hide_host and device == "cuda"
        for _ in range(warmup + iters):
            fn()
        return (0.010, 0.012, 0.011)

    monkeypatch.setattr(measure, "time_callable", fake_time_callable)
    monkeypatch.setattr(K, "launch_cost_ms", lambda device: 0.004)
    m = measure._measured(Candidate.make("cuda_data_parallel"), launching, "cuda", 1, 3)
    assert m.launches == {"data_parallel": 8} and m.median_ms == 0.011
    assert m.score_ms == pytest.approx(0.011 + 2 * 0.004)
    monkeypatch.undo()
    host = measure._measured(Candidate.make("torch_data_parallel"), lambda: None, "cpu", 1, 3)
    assert host.score_ms == host.median_ms and len(host.samples_ms) == 3

