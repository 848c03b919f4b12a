"""The benchmark's NumPy reference against the port, and what it may import."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import cart as ref_cart
from perfbench.reference import descend as ref_descend
from perfbench.reference import segmentation as ref_seg
from perfbench.reference.descend_torch import Bf16Reference
from repro_torch.core.cart import CartConfig, train_cart
from repro_torch.core.eval_serial import eval_serial
from repro_torch.core.forest import EncodedForest, majority_vote
from repro_torch.core.tree import breadth_first_encode, random_tree
from repro_torch.data import make_segmentation

PERFBENCH = Path(__file__).resolve().parents[1]


def _records(rng, m, a):
    x = rng.normal(size=(m, a)).astype(np.float32)
    x[rng.random((m, a)) < 0.05] = np.nan
    x[rng.random((m, a)) < 0.02] = np.inf
    x[rng.random((m, a)) < 0.02] = -np.inf
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_descent_matches_eval_serial_with_nan_and_inf(seed):
    rng = np.random.default_rng(seed)
    enc = breadth_first_encode(random_tree(n_attrs=19, n_classes=7, max_depth=9,
                                           seed=seed, balance=0.8))
    x = _records(rng, 3000, 19)
    # a record exactly on each threshold goes left
    internal = np.nonzero(enc.class_val < 0)[0]
    x[: internal.size, :] = 0
    x[np.arange(internal.size), enc.attr_idx[internal]] = enc.threshold[internal]
    tables = tuple(t[None] for t in enc)
    classes, depths = ref_descend.descend(tables, x)
    np.testing.assert_array_equal(classes[0], eval_serial(enc, x))
    assert depths.min() >= 1 and depths.max() <= 9


@pytest.mark.parametrize("seed", [0, 1])
def test_forest_vote_matches_majority_vote(seed):
    rng = np.random.default_rng(seed)
    forest = EncodedForest([breadth_first_encode(random_tree(
        n_attrs=19, n_classes=7, max_depth=6, seed=seed * 100 + t, balance=0.9))
        for t in range(16)])
    x = _records(rng, 2000, 19)
    tables = (forest.attr_idx, forest.threshold, forest.child, forest.class_val)
    per_tree, _ = ref_descend.descend(tables, x)
    want = np.stack([eval_serial(forest.tree(t), x) for t in range(16)])
    np.testing.assert_array_equal(per_tree, want)
    got, _ = ref_descend.classify(tables, x, 7)
    np.testing.assert_array_equal(got, majority_vote(torch.from_numpy(want), 7, device="cpu").numpy())


def test_vote_ties_go_to_the_lowest_class():
    per_tree = np.array([[3, 1, 6], [1, 3, 5], [3, 1, 6], [1, 3, 5], [2, 2, 0]], np.int32)
    np.testing.assert_array_equal(ref_descend.majority(per_tree, 7), [1, 1, 5])
    np.testing.assert_array_equal(
        majority_vote(torch.from_numpy(per_tree), 7, device="cpu").numpy(), [1, 1, 5])


def test_twin_and_trainer_reproduce_the_ports():
    x_train, y_train, x_test, y_test = ref_seg.make_segmentation(0)
    data = make_segmentation(0)
    for ours, theirs in ((x_train, data.x_train), (y_train, data.y_train),
                         (x_test, data.x_test), (y_test, data.y_test)):
        np.testing.assert_array_equal(ours, theirs)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, x_train.shape[0], 400)
    s = ref_cart.CartSettings(max_depth=6, min_samples_split=8, min_gain=4e-3)
    ours = ref_cart.encode(ref_cart.train_cart(x_train[idx], y_train[idx], 7, s))
    theirs = breadth_first_encode(train_cart(
        x_train[idx], y_train[idx], 7, CartConfig(max_depth=6, min_samples_split=8, min_gain=4e-3)))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _depth(tables) -> int:
    attr, _, child, cls = tables
    depth = np.zeros(attr.shape[0], np.int64)
    for i in np.nonzero(cls < 0)[0]:
        depth[child[i]] = depth[child[i] + 1] = depth[i] + 1
    return int(depth.max())


def test_best_first_growth_without_a_leaf_cap_is_the_depth_first_tree():
    x_train, y_train, _, _ = ref_seg.make_segmentation(0)
    idx = np.random.default_rng(6).integers(0, x_train.shape[0], 500)
    s = ref_cart.CartSettings(max_depth=7, min_samples_split=8, min_gain=4e-3)
    want = ref_cart.encode(ref_cart.train_cart(x_train[idx], y_train[idx], 7, s))
    got = ref_cart.encode(ref_cart.train_cart(
        x_train[idx], y_train[idx], 7, dataclasses.replace(s, max_leaves=10**6)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [2, 5, 16])
def test_best_first_growth_stops_at_its_leaf_cap_and_splits_the_largest_gain_first(cap):
    x_train, y_train, _, _ = ref_seg.make_segmentation(0)
    s = ref_cart.CartSettings(max_leaves=cap, max_depth=11)
    tables = ref_cart.encode(ref_cart.train_cart(x_train, y_train, 7, s))
    assert int((tables[3] >= 0).sum()) == cap and tables[0].shape[0] == 2 * cap - 1
    assert _depth(tables) <= 11
    # the root's split is the depth-first tree's: the same best split
    full = ref_cart.encode(ref_cart.train_cart(x_train, y_train, 7,
                                               ref_cart.CartSettings(max_depth=11)))
    assert (tables[0][0], tables[1][0]) == (full[0][0], full[1][0])


def test_frames_tile_permutations_of_the_base_records():
    idx = ref_seg.frame_indices(np.random.default_rng(3), 100, 4, 350)
    assert idx.shape == (4, 350) and idx.dtype == np.int32
    for f in range(4):
        for k in range(3):
            assert sorted(idx[f, k * 100:(k + 1) * 100]) == list(range(100))
        assert len(set(idx[f, 300:])) == 50


def test_bf16_round_matches_torch():
    x = np.random.default_rng(1).normal(size=10_000).astype(np.float32) * 100
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    want = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(ref_descend.bf16_round(x), want)


def test_bf16_reference_is_the_reference_on_rounded_records():
    rng = np.random.default_rng(2)
    forest = EncodedForest([breadth_first_encode(random_tree(
        n_attrs=19, n_classes=7, max_depth=5, seed=t, balance=0.9)) for t in range(5)])
    tables = (forest.attr_idx, forest.threshold, forest.child, forest.class_val)
    x = rng.normal(size=(500, 19)).astype(np.float32)
    got = Bf16Reference(tables, 7, torch.device("cpu"))(torch.from_numpy(x)).numpy()
    want, _ = ref_descend.classify(tables, ref_descend.bf16_round(x), 7)
    np.testing.assert_array_equal(got, want)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in PERFBENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "jax", "repro"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_nothing_opens_a_path_under_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value and node.value != "benchmarks"
