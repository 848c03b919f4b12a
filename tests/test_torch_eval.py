"""The port's tensor evaluators against the JAX package on the CPU.

Every evaluator — data-parallel (both loops), speculative (gather and
one-hot, ``jumps_per_round`` ∈ {1, 2, 3}, early exit), the ``ref`` oracles,
the forest helpers — gets the same numpy inputs as its JAX counterpart and
must return the same classes exactly.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tree_depth
from repro_torch.core import forest

# The packages' core/__init__ re-export functions under their modules' names.
jax_dp = importlib.import_module("repro.core.eval_dataparallel")
jax_spec = importlib.import_module("repro.core.eval_speculative")
jax_forest = importlib.import_module("repro.core.forest")
jax_ref = importlib.import_module("repro.kernels.tree_eval.ref")
dp = importlib.import_module("repro_torch.core.eval_dataparallel")
spec = importlib.import_module("repro_torch.core.eval_speculative")
ref = importlib.import_module("repro_torch.kernels.tree_eval.ref")

from torch_parity import (
    FOREST,
    N_CLASSES,
    PORT_FOREST,
    PORT_TREES,
    RECORDS,
    TREES,
    assert_same,
    cpu,
)

FIXTURES = sorted(TREES)


def _depth(name: str) -> int:
    return max(tree_depth(TREES[name]), 1)


def _jax_tables(enc):
    return (jnp.asarray(enc.attr_idx), jnp.asarray(enc.threshold),
            jnp.asarray(enc.child), jnp.asarray(enc.class_val))


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("loop", ["fixed", "early_exit"])
def test_eval_data_parallel_matches_jax(fixture, loop):
    want = jax_dp.eval_data_parallel_tree(TREES[fixture], RECORDS, max_depth=_depth(fixture), loop=loop)
    got = dp.eval_data_parallel_tree(PORT_TREES[fixture], RECORDS, max_depth=_depth(fixture), loop=loop, device="cpu")
    assert got.dtype == torch.int32
    assert_same(got, want, f"{fixture}/{loop}")


def test_eval_data_parallel_rejects_unknown_loop():
    with pytest.raises(ValueError, match="loop"):
        dp.eval_data_parallel_tree(PORT_TREES["deep"], RECORDS, max_depth=3, loop="while", device="cpu")


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("jumps", [1, 2, 3])
@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
def test_eval_speculative_matches_jax(fixture, jumps, onehot, early_exit):
    kw = dict(max_depth=_depth(fixture), jumps_per_round=jumps, use_onehot_matmul=onehot, early_exit=early_exit)
    want = jax_spec.eval_speculative_tree(TREES[fixture], RECORDS, **kw)
    got = spec.eval_speculative_tree(PORT_TREES[fixture], RECORDS, device="cpu", **kw)
    assert got.dtype == torch.int32
    assert_same(got, want, f"{fixture}/j{jumps}/onehot={onehot}/early={early_exit}")


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("onehot", [False, True])
def test_speculative_node_eval_and_pointer_jump_match_jax(fixture, onehot):
    enc = TREES[fixture]
    a, t, c, _ = _jax_tables(enc)
    want = jax_spec.speculative_node_eval(jnp.asarray(RECORDS), a, t, c, use_onehot_matmul=onehot)
    got = spec.speculative_node_eval(
        cpu(RECORDS), cpu(enc.attr_idx), cpu(enc.threshold), cpu(enc.child), use_onehot_matmul=onehot
    )
    assert got.dtype == torch.int32
    assert_same(got, want, "path")
    for rounds, k in ((1, 1), (2, 2), (1, 3)):
        assert_same(spec.pointer_jump(got, rounds, k), jax_spec.pointer_jump(want, rounds, k), f"jump {rounds}x{k}")


def test_rounds_for_depth_and_sanitize_match_jax():
    for depth in range(0, 40):
        for k in (1, 2, 3):
            assert spec.rounds_for_depth(depth, k) == jax_spec.rounds_for_depth(depth, k)
    got = spec.sanitize_records(cpu(RECORDS))
    assert_same(got, jax_spec.sanitize_records(jnp.asarray(RECORDS)), "sanitize")
    assert torch.isfinite(got).all()


def test_sanitize_upcasts_bf16():
    rec = torch.tensor([[1.5, float("nan"), float("inf")]], dtype=torch.bfloat16)
    got = spec.sanitize_records(rec)
    assert got.dtype == torch.float32
    assert got[0, 0] == 1.5 and got[0, 1] == -spec._F32_MAX and got[0, 2] == spec._F32_MAX


@pytest.mark.parametrize("fixture", FIXTURES)
def test_tree_eval_ref_matches_jax(fixture):
    enc = TREES[fixture]
    want = jax_ref.tree_eval_ref(jnp.asarray(RECORDS), *_jax_tables(enc), max_depth=_depth(fixture))
    got = ref.tree_eval_ref(RECORDS, *PORT_TREES[fixture], max_depth=_depth(fixture), device="cpu")
    assert got.dtype == torch.int32
    assert_same(got, want, fixture)


def test_forest_eval_ref_matches_jax():
    depth = max(int(FOREST.max_depth), 1)
    want = jax_ref.forest_eval_ref(jnp.asarray(RECORDS), *map(jnp.asarray, (
        FOREST.attr_idx, FOREST.threshold, FOREST.child, FOREST.class_val)), max_depth=depth)
    got = ref.forest_eval_ref(RECORDS, PORT_FOREST.attr_idx, PORT_FOREST.threshold,
                              PORT_FOREST.child, PORT_FOREST.class_val, max_depth=depth, device="cpu")
    assert_same(got, want, "forest_eval_ref")


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("jumps", [1, 2])
def test_eval_forest_matches_jax(onehot, jumps):
    want = jax_forest.eval_forest(FOREST, RECORDS, jumps_per_round=jumps, use_onehot_matmul=onehot)
    got = forest.eval_forest(PORT_FOREST, RECORDS, jumps_per_round=jumps, use_onehot_matmul=onehot, device="cpu")
    assert_same(got, want, "eval_forest")


@pytest.mark.parametrize("early_exit", [False, True])
def test_batched_tables_equal_per_tree(early_exit):
    """A (T, N) table batch gives the per-tree results stacked."""
    depth = max(int(PORT_FOREST.max_depth), 1)
    tables = (PORT_FOREST.attr_idx, PORT_FOREST.threshold, PORT_FOREST.child, PORT_FOREST.class_val)
    got = spec.eval_speculative(RECORDS, *tables, max_depth=depth, early_exit=early_exit, device="cpu")
    got_dp = dp.eval_data_parallel(RECORDS, *tables, max_depth=depth,
                                   loop="early_exit" if early_exit else "fixed", device="cpu")
    for i in range(PORT_FOREST.n_trees):
        one = PORT_FOREST.tree(i)
        assert_same(got[i], spec.eval_speculative_tree(one, RECORDS, max_depth=depth, device="cpu"), f"spec {i}")
        assert_same(got_dp[i], dp.eval_data_parallel_tree(one, RECORDS, max_depth=depth, device="cpu"), f"dp {i}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_majority_vote_matches_jax(seed):
    per_tree = np.random.default_rng(seed).integers(0, N_CLASSES, size=(6, 200)).astype(np.int32)
    want = jax_forest.majority_vote(jnp.asarray(per_tree), N_CLASSES)
    got = forest.majority_vote(cpu(per_tree), N_CLASSES)
    assert got.dtype == torch.int32
    assert_same(got, want, "vote")


def test_majority_vote_tie_goes_to_lowest_class():
    per_tree = np.array([[3, 1, 4, 0],
                         [1, 3, 4, 2],
                         [3, 1, 2, 2],
                         [1, 3, 2, 0]], np.int32)    # every record: a two-way tie
    want = jax_forest.majority_vote(jnp.asarray(per_tree), N_CLASSES)
    got = forest.majority_vote(cpu(per_tree), N_CLASSES)
    assert got.tolist() == [1, 1, 2, 0]
    assert_same(got, want, "tie")


def test_majority_vote_ignores_out_of_range_classes():
    per_tree = np.array([[7, 7], [2, 7], [-1, 7]], np.int32)
    assert_same(forest.majority_vote(cpu(per_tree), 3),
                jax_forest.majority_vote(jnp.asarray(per_tree), 3), "out of range")


def test_route_topk_matches_jax():
    per_tree = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert_same(forest.route_topk(cpu(per_tree)), jax_forest.route_topk(jnp.asarray(per_tree)), "route")


def test_numpy_input_without_device_raises_without_a_card(monkeypatch):
    """No card and no device="cpu": entry points raise, never run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = PORT_TREES["deep"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.eval_speculative_tree(enc, RECORDS, max_depth=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.eval_data_parallel_tree(enc, RECORDS, max_depth=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ref.tree_eval_ref(RECORDS, *enc, max_depth=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forest.majority_vote(np.zeros((2, 3), np.int32), 3)
    # A CPU tensor runs where it lies.
    assert spec.eval_speculative_tree(enc, cpu(RECORDS), max_depth=8).device.type == "cpu"
