"""The port's slice as a whole against the JAX package, at small M on the CPU.

The paper's pipeline: the segmentation twin, CART, the branchless encoding,
then one tree (``ops.tree_eval``, three modes), a bagged forest
(``ops.forest_eval_fused``, three modes, then ``majority_vote``), the
early-exit cascade over that forest (``CascadeEvaluator``, three modes, on
the records and on a 90/10 mix of them with noise) and the same forest in
its quantized layouts (``ops.forest_eval_fused_q``, both algorithms) — each
stage fed the same numpy inputs in both packages and compared exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import CartConfig as JaxCartConfig
from repro.core import EncodedForest as JaxForest
from repro.core import breadth_first_encode as jax_encode
from repro.core import eval_serial as jax_eval_serial
from repro.core import majority_vote as jax_majority_vote
from repro.core import train_cart as jax_train_cart
from repro.data.segmentation import make_segmentation as jax_make_segmentation
from repro.data.segmentation import replicated_dataset as jax_replicated_dataset
from repro.kernels.tree_eval import CascadeEvaluator as JaxCascadeEvaluator
from repro.kernels.tree_eval import QuantizedForest as JaxQuantizedForest
from repro.kernels.tree_eval import forest_eval_fused as jax_forest_eval_fused
from repro.kernels.tree_eval import forest_eval_fused_q as jax_forest_eval_fused_q
from repro.kernels.tree_eval import plan_cascade as jax_plan_cascade
from repro.kernels.tree_eval import tree_eval as jax_tree_eval
from repro_torch.core import (
    CartConfig,
    EncodedForest,
    breadth_first_encode,
    eval_serial,
    majority_vote,
    train_cart,
)
from repro_torch.data import make_segmentation, replicated_dataset
from repro_torch.kernels.tree_eval import (
    CascadeEvaluator,
    PackedForest,
    PackedTree,
    QuantizedForest,
    forest_eval_fused,
    forest_eval_fused_q,
    plan_cascade,
    tree_eval,
)

from torch_parity import assert_same

MODES = [("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")]
M = 256
N_TREES = 5
PAPER_CART = dict(max_depth=12, min_samples_split=8, min_gain=4e-3)
FOREST_CART = dict(max_depth=8, min_samples_split=16, min_gain=4e-3)


@pytest.fixture(scope="module")
def slice_inputs():
    """Both packages' data, tree and bagged forest, built from the same seeds."""
    data, jax_data = make_segmentation(0), jax_make_segmentation(0)
    enc = breadth_first_encode(train_cart(data.x_train, data.y_train, 7, CartConfig(**PAPER_CART)))
    jax_enc = jax_encode(jax_train_cart(jax_data.x_train, jax_data.y_train, 7, JaxCartConfig(**PAPER_CART)))
    rng = np.random.default_rng(0)
    trees, jax_trees = [], []
    for _ in range(N_TREES):
        idx = rng.integers(0, data.x_train.shape[0], data.x_train.shape[0])
        trees.append(breadth_first_encode(train_cart(
            data.x_train[idx], data.y_train[idx], 7, CartConfig(**FOREST_CART))))
        jax_trees.append(jax_encode(jax_train_cart(
            jax_data.x_train[idx], jax_data.y_train[idx], 7, JaxCartConfig(**FOREST_CART))))
    rec, labels = replicated_dataset(data, M, seed=1)
    jax_rec, _ = jax_replicated_dataset(jax_data, M, seed=1)
    assert_same(rec, jax_rec, "records")
    return dict(enc=enc, jax_enc=jax_enc, forest=EncodedForest(trees), jax_forest=JaxForest(jax_trees),
                rec=rec, labels=labels, rows=np.concatenate([data.x_train, data.x_test]))


def test_slice_tree(slice_inputs):
    s = slice_inputs
    for field in ("attr_idx", "threshold", "child", "class_val"):
        assert_same(getattr(s["enc"], field), getattr(s["jax_enc"], field), field)
    want_serial = jax_eval_serial(s["jax_enc"], s["rec"])
    assert_same(eval_serial(s["enc"], s["rec"]), want_serial, "eval_serial")
    packed = PackedTree(s["enc"], 19, device="cpu")
    for algorithm, jump_mode in MODES:
        want = jax_tree_eval(s["rec"], s["jax_enc"], algorithm=algorithm, jump_mode=jump_mode)
        got = tree_eval(s["rec"], packed, algorithm=algorithm, jump_mode=jump_mode, device="cpu")
        assert_same(got, want, f"tree/{algorithm}/{jump_mode}")
        assert_same(got, want_serial, f"tree/{algorithm}/{jump_mode} vs serial")
    assert float((want_serial == s["labels"]).mean()) > 0.9


def test_slice_forest_and_vote(slice_inputs):
    s = slice_inputs
    forest, jax_forest = s["forest"], s["jax_forest"]
    assert (forest.n_trees, forest.n_nodes, forest.max_depth) == \
        (jax_forest.n_trees, jax_forest.n_nodes, jax_forest.max_depth)
    per_tree = np.stack([jax_eval_serial(jax_forest.tree(t), s["rec"]) for t in range(N_TREES)])
    packed = PackedForest(forest, 19, device="cpu")
    for algorithm, jump_mode in MODES:
        want = jax_forest_eval_fused(s["rec"], jax_forest, algorithm=algorithm, jump_mode=jump_mode)
        got = forest_eval_fused(s["rec"], packed, algorithm=algorithm, jump_mode=jump_mode, device="cpu")
        assert_same(got, want, f"forest/{algorithm}/{jump_mode}")
        assert_same(got, per_tree, f"forest/{algorithm}/{jump_mode} vs serial")
        assert_same(majority_vote(got, 7), jax_majority_vote(jnp.asarray(want), 7), "vote")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_slice_cascade(slice_inputs, algorithm, jump_mode):
    s = slice_inputs
    forest, jax_forest, rec = s["forest"], s["jax_forest"], s["rec"]
    rng = np.random.default_rng(1)               # the 90/10 mix of benchmarks/cascade_sweep.py
    noise = rng.normal(loc=rec.mean(0), scale=rec.std(0) + 1e-6, size=rec.shape).astype(np.float32)
    mix = rec.copy()
    mix[rng.permutation(M)[: M // 10]] = noise[: M // 10]
    per_tree = {
        "records": np.stack([jax_eval_serial(jax_forest.tree(t), rec) for t in range(N_TREES)]),
        "mix": np.stack([jax_eval_serial(jax_forest.tree(t), mix) for t in range(N_TREES)]),
    }
    for bound in (None, 1.0, 0.5):
        plan = plan_cascade(forest, rec, n_classes=7, stages=2, bound=bound, device="cpu")
        jax_plan = jax_plan_cascade(jax_forest, rec, n_classes=7, stages=2, bound=bound)
        assert (plan.order, plan.stage_sizes) == (jax_plan.order, jax_plan.stage_sizes)
        ev = CascadeEvaluator(forest, plan, n_classes=7, bound=bound, engine="cuda",
                              algorithm=algorithm, jump_mode=jump_mode, device="cpu")
        jax_ev = JaxCascadeEvaluator(jax_forest, jax_plan, n_classes=7, bound=bound, engine="jnp",
                                     algorithm=algorithm, jump_mode=jump_mode)
        for name, x in (("records", rec), ("mix", mix)):
            got, want = ev(x), jax_ev(x)
            for field in ("classes", "margin", "trees_evaluated", "exit_stage", "confidence"):
                assert_same(getattr(got, field), getattr(want, field), f"{name}/{bound}/{field}")
            assert got.stage_survivors == want.stage_survivors
            if bound in (None, 1.0):
                assert_same(got.classes, jax_majority_vote(jnp.asarray(per_tree[name]), 7),
                            f"{name}/{bound} vs serial majority")


@pytest.mark.parametrize("thr_dtype", ["bfloat16", "float16"])
def test_slice_quantized_forest(slice_inputs, thr_dtype):
    """Universal and calibrated (on the train+test rows the records are tiled
    from) layouts: classes equal the JAX package's and the serial oracle's."""
    s = slice_inputs
    forest, jax_forest, rec = s["forest"], s["jax_forest"], s["rec"]
    per_tree = np.stack([jax_eval_serial(jax_forest.tree(t), rec) for t in range(N_TREES)])
    for calibration in (None, s["rows"]):
        q = QuantizedForest(forest, 19, thr_dtype=thr_dtype, calibration=calibration, device="cpu")
        jax_q = JaxQuantizedForest(jax_forest, 19, thr_dtype=thr_dtype, calibration=calibration)
        assert (q.thr_stored, q.fallback_nodes) == (jax_q.thr_stored, jax_q.fallback_nodes)
        for algorithm in ("speculative", "data_parallel"):
            got = forest_eval_fused_q(rec, q, algorithm=algorithm, device="cpu")
            label = f"quant/{thr_dtype}/{algorithm}/calibrated={calibration is not None}"
            assert_same(got, jax_forest_eval_fused_q(rec, jax_q, algorithm=algorithm), label)
            assert_same(got, per_tree, label + " vs serial")
