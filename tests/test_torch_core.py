"""The port's host-side modules against the JAX package: encodings, data, CART,
analysis and the serial oracle give identical arrays for identical seeds."""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import analysis as jax_analysis
from repro.core import cart as jax_cart
from repro.core.eval_serial import eval_serial as jax_eval_serial
from repro.core.eval_serial import eval_serial_vectorized_host as jax_eval_serial_host
from repro.core import tree as jax_tree
from repro.data import segmentation as jax_seg
from repro_torch.core import analysis, cart, tree
from repro_torch.core.eval_serial import eval_serial, eval_serial_vectorized_host
from repro_torch.core.forest import EncodedForest
from repro_torch.data import segmentation as seg

from torch_parity import FOREST, PORT_TREES, RECORDS, TREES, assert_same

PAPER_CART = dict(max_depth=12, min_samples_split=8, min_gain=4e-3)
FOREST_CART = dict(max_depth=8, min_samples_split=16, min_gain=4e-3)


def _assert_encoding(got, want, label=""):
    for field in ("attr_idx", "threshold", "child", "class_val"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, f"{label}.{field}: {g.dtype} != {w.dtype}"
        assert_same(g, w, f"{label}.{field}")


@pytest.mark.parametrize("seed,depth,balance,min_depth", [
    (0, 1, 1.0, 1), (1, 4, 0.7, 1), (2, 7, 0.5, 2), (3, 10, 0.3, 3), (4, 8, 1.0, 8),
])
def test_random_tree_encoding_identical(seed, depth, balance, min_depth):
    kw = dict(n_attrs=19, n_classes=7, max_depth=depth, seed=seed, balance=balance, min_depth=min_depth)
    want = jax_tree.breadth_first_encode(jax_tree.random_tree(**kw))
    got = tree.breadth_first_encode(tree.random_tree(**kw))
    _assert_encoding(got, want, "encode")
    assert tree.tree_depth(got) == jax_tree.tree_depth(want)
    assert_same(tree.node_depths(got), jax_tree.node_depths(want), "node_depths")
    assert_same(tree.leaf_paths(got), jax_tree.leaf_paths(want), "leaf_paths")
    assert_same(tree.processor_node_map(got), jax_tree.processor_node_map(want), "processor_node_map")
    assert_same(tree.attr_select_matrix(got, 19), jax_tree.attr_select_matrix(want, 19), "attr_select")
    pad = got.n_nodes + 1 + seed * 37
    _assert_encoding(tree.pad_tree(got, pad), jax_tree.pad_tree(want, pad), "pad_tree")


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_paper_and_perfect_trees_identical(seed):
    _assert_encoding(
        tree.breadth_first_encode(tree.paper_tree(seed)),
        jax_tree.breadth_first_encode(jax_tree.paper_tree(seed)), "paper_tree",
    )
    _assert_encoding(
        tree.breadth_first_encode(tree.perfect_tree(5, 19, 7, seed)),
        jax_tree.breadth_first_encode(jax_tree.perfect_tree(5, 19, 7, seed)), "perfect_tree",
    )


@pytest.mark.parametrize("fixture", sorted(PORT_TREES))
def test_decode_roundtrip_and_validation(fixture):
    enc = PORT_TREES[fixture]
    tree.validate_encoding(enc)
    _assert_encoding(tree.breadth_first_encode(tree.decode_to_linked(enc)), TREES[fixture], fixture)


def test_validate_encoding_rejects_broken_leaf():
    enc = PORT_TREES["deep"]
    leaf = int(np.nonzero(enc.is_leaf_mask)[0][0])
    broken = enc._replace(threshold=enc.threshold.copy())
    broken.threshold[leaf] = 0.0
    with pytest.raises(ValueError, match="threshold must be"):
        tree.validate_encoding(broken)


def test_pad_tree_rejects_shrinking():
    with pytest.raises(ValueError):
        tree.pad_tree(PORT_TREES["deep"], 3)


def test_from_arrays_round_trip_and_checks():
    enc = TREES["deep"]
    _assert_encoding(tree.EncodedTree.from_arrays(*enc), enc, "from_arrays")
    with pytest.raises(TypeError, match="threshold must be float32"):
        tree.EncodedTree.from_arrays(enc.attr_idx, enc.threshold.astype(np.float64), enc.child, enc.class_val)
    with pytest.raises(ValueError, match="shapes differ"):
        tree.EncodedTree.from_arrays(enc.attr_idx[:-1], enc.threshold, enc.child, enc.class_val)
    with pytest.raises(TypeError, match="numpy array"):
        tree.EncodedTree.from_arrays(list(enc.attr_idx), enc.threshold, enc.child, enc.class_val)

    forest = EncodedForest.from_arrays(FOREST.attr_idx, FOREST.threshold, FOREST.child, FOREST.class_val)
    assert (forest.n_trees, forest.n_nodes, forest.max_depth) == (FOREST.n_trees, FOREST.n_nodes, FOREST.max_depth)
    for field in ("attr_idx", "threshold", "child", "class_val"):
        assert_same(getattr(forest, field), getattr(FOREST, field), f"forest.{field}")
    with pytest.raises(ValueError, match="2-D"):
        EncodedForest.from_arrays(*enc)


def test_forest_stacking_identical():
    from repro.core.forest import EncodedForest as JaxForest

    trees = [tree.breadth_first_encode(tree.random_tree(n_attrs=5, n_classes=3, max_depth=d, seed=d))
             for d in (1, 3, 6)]
    want = JaxForest([jax_tree.breadth_first_encode(jax_tree.random_tree(n_attrs=5, n_classes=3, max_depth=d, seed=d))
                      for d in (1, 3, 6)])
    got = EncodedForest(trees)
    assert (got.n_trees, got.n_nodes, got.max_depth) == (want.n_trees, want.n_nodes, want.max_depth)
    for i in range(got.n_trees):
        _assert_encoding(got.tree(i), want.tree(i), f"tree{i}")


@pytest.mark.parametrize("seed", [0, 5])
def test_make_segmentation_identical(seed):
    got, want = seg.make_segmentation(seed), jax_seg.make_segmentation(seed)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype
        assert_same(g, w, field)


@pytest.mark.parametrize("n_records,seed", [(5000, 1), (300, 2)])
def test_replicated_dataset_identical(n_records, seed):
    data = seg.make_segmentation(0)
    gx, gy = seg.replicated_dataset(data, n_records, seed=seed)
    wx, wy = jax_seg.replicated_dataset(jax_seg.make_segmentation(0), n_records, seed=seed)
    assert_same(gx, wx, "x")
    assert_same(gy, wy, "y")


def test_train_cart_paper_config_identical():
    data = seg.make_segmentation(0)
    got = cart.train_cart(data.x_train, data.y_train, 7, cart.CartConfig(**PAPER_CART))
    want = jax_cart.train_cart(data.x_train, data.y_train, 7, jax_cart.CartConfig(**PAPER_CART))
    genc, wenc = tree.breadth_first_encode(got), jax_tree.breadth_first_encode(want)
    _assert_encoding(genc, wenc, "cart")
    assert cart.accuracy(eval_serial(genc, data.x_test), data.y_test) == \
        jax_cart.accuracy(jax_eval_serial(wenc, data.x_test), data.y_test)


@pytest.mark.parametrize("seed", [0, 3])
def test_train_cart_bootstrap_identical(seed):
    data = seg.make_segmentation(0)
    idx = np.random.default_rng(seed).integers(0, data.x_train.shape[0], data.x_train.shape[0])
    x, y = data.x_train[idx], data.y_train[idx]
    got = cart.train_cart(x, y, 7, cart.CartConfig(**FOREST_CART))
    want = jax_cart.train_cart(x, y, 7, jax_cart.CartConfig(**FOREST_CART))
    _assert_encoding(tree.breadth_first_encode(got), jax_tree.breadth_first_encode(want), "cart")


def test_train_cart_degenerate_labels_identical():
    x = np.random.default_rng(0).normal(size=(20, 3))
    y = np.zeros(20, np.int64)
    _assert_encoding(
        tree.breadth_first_encode(cart.train_cart(x, y, 2)),
        jax_tree.breadth_first_encode(jax_cart.train_cart(x, y, 2)), "degenerate",
    )


@pytest.mark.parametrize("fixture", sorted(TREES))
def test_eval_serial_identical(fixture):
    enc, port = TREES[fixture], PORT_TREES[fixture]
    assert_same(eval_serial(port, RECORDS), jax_eval_serial(enc, RECORDS), fixture)
    depth = max(tree.tree_depth(port), 1)
    assert_same(
        eval_serial_vectorized_host(port, RECORDS, depth),
        jax_eval_serial_host(enc, RECORDS, depth), fixture,
    )


@pytest.mark.parametrize("fixture", sorted(TREES))
def test_analysis_identical(fixture):
    got = analysis.observed_depths(PORT_TREES[fixture], RECORDS)
    want = jax_analysis.observed_depths(TREES[fixture], RECORDS)
    assert_same(got, want, "observed_depths")
    assert analysis.mean_traversal_depth(got) == jax_analysis.mean_traversal_depth(want)
    assert_same(analysis.level_active_fractions(got, 9), jax_analysis.level_active_fractions(want, 9))


@pytest.mark.parametrize("d_mu", [0.5, 1.0, 3.7, 11.0])
def test_cost_model_identical(d_mu):
    cm = dict(t_e=1.0, t_c=0.5, t_i=2.0, sigma=1e-3, gamma=4.0)
    got_cm, want_cm = analysis.CostModel(**cm), jax_analysis.CostModel(**cm)
    for name in ("t2_serial",):
        assert getattr(analysis, name)(65536, d_mu, got_cm) == getattr(jax_analysis, name)(65536, d_mu, want_cm)
    assert analysis.t3_data_parallel(65536, d_mu, 128, got_cm) == jax_analysis.t3_data_parallel(65536, d_mu, 128, want_cm)
    if d_mu >= 1:
        assert analysis.t5_speculative(65536, d_mu, 128, 16, got_cm) == \
            jax_analysis.t5_speculative(65536, d_mu, 128, 16, want_cm)
        assert analysis.e5_efficiency(65536, d_mu, 128, 16, got_cm) == \
            jax_analysis.e5_efficiency(65536, d_mu, 128, 16, want_cm)
    assert analysis.e3_efficiency(65536, d_mu, 128, got_cm) == jax_analysis.e3_efficiency(65536, d_mu, 128, want_cm)
    assert analysis.crossover_group_size(d_mu) == jax_analysis.crossover_group_size(d_mu)
    assert analysis.speculative_wins(d_mu, 4) == jax_analysis.speculative_wins(d_mu, 4)
    assert analysis.speculation_waste_ratio(31, d_mu) == jax_analysis.speculation_waste_ratio(31, d_mu)
