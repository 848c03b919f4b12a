"""The port's quantized forest layout (``kernels/tree_eval/quant.py``) and its
entry point ``ops.forest_eval_fused_q`` against the JAX package.

Everything is held with ``np.array_equal`` and no tolerance: narrow
thresholds as their uint16 bit patterns (the port keeps bfloat16 as bits on
the host, the JAX package as ``ml_dtypes``), integer tables by dtype and value
on the port's N columns (the JAX package pads N to 128 lanes with phantom
leaves), and classes from the port's CPU path (K7/K8's plain versions)
against the JAX package's Pallas kernels in interpret mode.  The last part
carries the JAX package's quantization properties over to the port.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

import jax.numpy as jnp

from repro.core import breadth_first_encode as jax_encode
from repro.core import train_cart as jax_train_cart
from repro.core import CartConfig as JaxCartConfig
from repro.core.forest import EncodedForest as JaxForest
from repro.core.tree import EncodedTree as JaxTree
from repro.data.segmentation import make_segmentation as jax_make_segmentation
from repro.kernels.tree_eval import quant as jq
from repro.kernels.tree_eval.ops import forest_eval_fused_q as jax_forest_eval_fused_q
from repro_torch.core import EncodedForest, Node, breadth_first_encode, random_tree
from repro_torch.kernels.tree_eval import QuantizedForest, forest_eval_fused_q, ops
from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.kernels.tree_eval import quant as Q
from repro_torch.kernels.tree_eval.ref import forest_eval_ref

from torch_parity import FOREST, N_ATTRS, PORT_FOREST, RECORDS, TREES, assert_same, cpu

THR = sorted(Q.THR_DTYPES)
ALGORITHMS = ("speculative", "data_parallel")


def _jax_bits(x, thr_dtype: str) -> np.ndarray:
    """f32 values cast by the JAX package's dtype (ml_dtypes / numpy), as bits."""
    with np.errstate(over="ignore"):   # beyond the narrow range a cast is ±inf, as intended
        return np.asarray(x, np.float32).astype(jq.THR_DTYPES[thr_dtype]).view(np.uint16)


def _special_values(n: int, seed: int = 0) -> np.ndarray:
    """Random f32 over many binades plus ±0, ±inf, subnormals, overflow and ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-45, 38, size=n)).astype(np.float32)
    bf16_mids = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    return np.concatenate([
        x, bf16_mids, -bf16_mids,
        np.float32([0.0, -0.0, np.inf, -np.inf, 1e-42, -1e-42, 6e-8, 65504, 65520, 3.4e38, 0.5]),
    ])


@pytest.fixture(scope="module")
def cart_forests():
    """A small bagged CART forest of the segmentation twin in both packages."""
    data = jax_make_segmentation(0)
    rng = np.random.default_rng(0)
    trees = []
    for _ in range(3):
        idx = rng.integers(0, data.x_train.shape[0], data.x_train.shape[0])
        trees.append(jax_encode(jax_train_cart(
            data.x_train[idx], data.y_train[idx], 7,
            JaxCartConfig(max_depth=6, min_samples_split=16, min_gain=4e-3))))
    jax_forest = JaxForest(trees)
    port = EncodedForest.from_arrays(jax_forest.attr_idx, jax_forest.threshold,
                                     jax_forest.child, jax_forest.class_val)
    cal = np.concatenate([data.x_train, data.x_test])
    return jax_forest, port, cal


# ---------------------------------------------------------------------------
# bit patterns, neighbours, intervals, leaf bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("thr_dtype", THR)
def test_rounding_and_upcast_match_the_jax_dtypes_bit_for_bit(thr_dtype):
    x = _special_values(100_000)
    bits = Q.to_bits(x, thr_dtype)
    assert bits.dtype == np.uint16
    assert np.array_equal(bits, _jax_bits(x, thr_dtype))
    up = Q.from_bits(bits, thr_dtype)
    want = bits.view(jq.THR_DTYPES[thr_dtype]).astype(np.float32)
    assert np.array_equal(up, want, equal_nan=True)


@pytest.mark.parametrize("thr_dtype", THR)
def test_neighbors_match_bit_for_bit(thr_dtype):
    bits = np.concatenate([_jax_bits(_special_values(5_000, seed=1), thr_dtype),
                           np.arange(0, 0x10000, 97, dtype=np.uint16)])
    bits = bits[~np.isnan(Q.from_bits(bits, thr_dtype))]   # the JAX side never sees NaN patterns
    prev, nxt = Q._neighbors(bits, thr_dtype)
    jprev, jnxt = jq._neighbors(bits.view(jq.THR_DTYPES[thr_dtype]), jq.THR_DTYPES[thr_dtype])
    assert np.array_equal(prev, jprev.view(np.uint16))
    assert np.array_equal(nxt, jnxt.view(np.uint16))
    keys = Q._ordered_from_bits(bits)
    assert np.array_equal(Q._bits_from_ordered(keys), bits)
    assert np.array_equal(keys, jq._ordered_from_bits(bits))


def test_routing_interval_matches():
    rng = np.random.default_rng(3)
    vals = np.sort(np.unique(rng.normal(size=200).astype(np.float32)))
    for t in [*vals[::17], -5.0, 5.0, float(vals[0]), float(vals[-1]), 0.0]:
        assert Q.routing_interval(vals, float(t)) == jq.routing_interval(vals, float(t))
    assert Q.routing_interval(vals[:0], 1.0) == (-np.inf, np.inf)


@pytest.mark.parametrize("thr_dtype", THR)
@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_thresholds_matches_bit_for_bit(thr_dtype, calibrated, cart_forests):
    jax_forest, _, cal = cart_forests
    trees = [(t, None) for t in TREES.values()] + [(jax_forest.tree(i), cal) for i in range(3)]
    for enc, own_cal in trees:
        attr_values = None
        if calibrated:
            attr_values = jq.calibration_attr_values(RECORDS if own_cal is None else own_cal, 19)
            assert all(np.array_equal(a, b) for a, b in zip(
                attr_values.values(),
                Q.calibration_attr_values(RECORDS if own_cal is None else own_cal, 19).values()))
        args = (enc.threshold, enc.is_leaf_mask, enc.attr_idx)
        q, safe = Q.quantize_thresholds(*args, thr_dtype=thr_dtype, attr_values=attr_values)
        wq, wsafe = jq.quantize_thresholds(*args, thr_dtype=thr_dtype, attr_values=attr_values)
        assert np.array_equal(q, np.asarray(wq).view(np.uint16))
        assert np.array_equal(safe, wsafe)


@pytest.mark.parametrize("thr_dtype", THR)
def test_quantize_thresholds_breaks_ties_as_the_jax_package(thr_dtype):
    """Thresholds halfway between two narrow values, calibrated so that both
    neighbours fit the routing interval: the candidate order decides, and in
    some of these cases the JAX package picks the neighbour over the cast."""
    lo = np.float32([0.5, 1.25, -3.0, 100.0, 7e-3, 0.3, 2.2, 9.1, -0.77, 33.3])
    step = Q.from_bits(Q.to_bits(lo, thr_dtype) + 1, thr_dtype) - Q.from_bits(Q.to_bits(lo, thr_dtype), thr_dtype)
    lo = Q.from_bits(Q.to_bits(lo, thr_dtype), thr_dtype)
    mids = lo + step / 2
    vals = {0: np.sort(np.concatenate([lo - 4 * step, lo + 4 * step]).astype(np.float32))}
    leaf = np.zeros(mids.shape, bool)
    attr = np.zeros(mids.shape, np.int32)
    q, safe = Q.quantize_thresholds(mids, leaf, attr, thr_dtype=thr_dtype, attr_values=vals)
    wq, wsafe = jq.quantize_thresholds(mids, leaf, attr, thr_dtype=thr_dtype, attr_values=vals)
    assert safe.all() and np.array_equal(safe, wsafe)
    assert np.array_equal(q, np.asarray(wq).view(np.uint16))
    assert (q != Q.to_bits(mids, thr_dtype)).any()


def test_leaf_bits_match():
    for enc in TREES.values():
        bits = Q.pack_leaf_bits(enc.is_leaf_mask)
        assert np.array_equal(bits, jq.pack_leaf_bits(enc.is_leaf_mask))
        assert np.array_equal(Q.unpack_leaf_bits(bits, enc.n_nodes), enc.is_leaf_mask)


@pytest.mark.parametrize("lane", [1, 4, 128])
def test_level_sync_renumber_matches(lane):
    for name, enc in TREES.items():
        got, off = Q.level_sync_renumber(enc, lane=lane)
        want, woff = jq.level_sync_renumber(enc, lane=lane)
        assert np.array_equal(off, woff), name
        for field in ("attr_idx", "threshold", "child", "class_val"):
            assert_same(getattr(got, field), getattr(want, field), f"{name}/{field}/lane={lane}")


# ---------------------------------------------------------------------------
# QuantizedForest tables
# ---------------------------------------------------------------------------


def _assert_same_layout(port: QuantizedForest, jax, label: str) -> None:
    n = port.n_nodes
    for field in ("thr_dtype", "thr_stored", "fallback_nodes", "logical_nodes", "max_depth",
                  "n_trees", "renumbered"):
        assert getattr(port, field) == getattr(jax, field), f"{label}: {field}"
    for field in ("attr_idx", "child", "class_val"):
        got, want = getattr(port, field).numpy(), np.asarray(getattr(jax, field))
        assert got.dtype == want.dtype, f"{label}: {field} {got.dtype} != {want.dtype}"
        assert np.array_equal(got, want[:, :n]), f"{label}: {field}"
    want_thr = np.asarray(jax.threshold)
    if port.thr_stored == "float32":
        assert port.threshold.dtype == torch.float32
        got_thr = port.threshold.numpy()
    else:
        assert port.threshold.dtype == Q.THR_DTYPES[port.thr_stored]
        got_thr, want_thr = port.threshold.view(torch.int16).numpy().view(np.uint16), want_thr.view(np.uint16)
    assert np.array_equal(got_thr, want_thr[:, :n]), f"{label}: threshold"
    assert np.array_equal(Q.unpack_leaf_bits(port.leaf_bits.numpy(), n),
                          np.stack([jq.unpack_leaf_bits(b, jax.n_nodes)[:n] for b in np.asarray(jax.leaf_bits)]))
    if jax.level_offsets is None:
        assert port.level_offsets is None
    else:
        assert all(np.array_equal(a, b) for a, b in zip(port.level_offsets, jax.level_offsets))
    report, jreport = port.bytes_report(), jax.bytes_report()
    assert {k: v["dtype"] for k, v in report["tables"].items()} == \
        {k: v["dtype"] for k, v in jreport["tables"].items()}, label


@pytest.mark.parametrize("thr_dtype", THR)
@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("renumber", [False, True])
def test_quantized_forest_tables_match(thr_dtype, calibrated, renumber, cart_forests):
    jax_cart, port_cart, cal = cart_forests
    for label, jf, pf, records, a in (("fixture", FOREST, PORT_FOREST, RECORDS, N_ATTRS),
                                      ("cart", jax_cart, port_cart, cal, 19)):
        kw = dict(thr_dtype=thr_dtype, calibration=records if calibrated else None, renumber=renumber)
        port = QuantizedForest(pf, a, device="cpu", **kw)
        _assert_same_layout(port, jq.QuantizedForest(jf, a, **kw), f"{label}/{kw}")


def test_layouts_store_what_the_thresholds_allow(cart_forests):
    """CART midpoints never round-trip; calibrated, some nodes fit, and a
    forest snapped to a narrow type stores it with no fallback."""
    _, forest, cal = cart_forests
    internal = int((forest.class_val == -1).sum())
    for thr_dtype in THR:
        uni = QuantizedForest(forest, 19, thr_dtype=thr_dtype, device="cpu")
        assert (uni.thr_stored, uni.fallback_nodes) == ("float32", internal)
        calib = QuantizedForest(forest, 19, thr_dtype=thr_dtype, calibration=cal, device="cpu")
        assert calib.thr_stored == "float32" and 0 < calib.fallback_nodes < internal
        snapped = forest.threshold.copy()
        snapped[forest.class_val == -1] = Q.from_bits(Q.to_bits(snapped[forest.class_val == -1], thr_dtype),
                                                      thr_dtype)
        narrow = QuantizedForest(EncodedForest.from_arrays(forest.attr_idx, snapped, forest.child,
                                                           forest.class_val), 19, thr_dtype=thr_dtype,
                                 device="cpu")
        assert (narrow.thr_stored, narrow.fallback_nodes) == (thr_dtype, 0)
        t, n = narrow.n_trees, narrow.n_nodes
        assert narrow.nbytes == t * n * (1 + 2 + 1 + 1) + t * ((n + 7) // 8)
        assert uni.nbytes == narrow.nbytes + 2 * t * n
        assert narrow.bytes_report()["total_bytes"] == narrow.nbytes == Q.forest_table_bytes(narrow)
        packed = ops.PackedForest(forest, 19, device="cpu")
        assert packed.nbytes == Q.packed_forest_nbytes(packed) == Q.forest_table_bytes(packed) \
            == 4 * t * n * (4 + 19)


def test_int16_child_when_n_exceeds_128():
    enc = breadth_first_encode(random_tree(n_attrs=N_ATTRS, n_classes=5, max_depth=7, seed=1, balance=1.0))
    q = QuantizedForest(EncodedForest([enc]), N_ATTRS, device="cpu")
    assert q.n_nodes == 255 and q.child.dtype == torch.int16 and q.attr_idx.dtype == torch.int8
    jaxq = jq.QuantizedForest(JaxForest([JaxTree(*enc)]), N_ATTRS)
    _assert_same_layout(q, jaxq, "N=255")


def test_quantized_forest_rejects_bad_input(monkeypatch):
    with pytest.raises(ValueError, match="thr_dtype must be one of"):
        QuantizedForest(PORT_FOREST, N_ATTRS, thr_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="attr_idx outside"):
        QuantizedForest(PORT_FOREST, 3, device="cpu")
    f = PORT_FOREST
    narrow = dict(thr_dtype="bfloat16", max_depth=3, n_attrs=N_ATTRS, device="cpu")
    bits = Q.to_bits(f.threshold, "bfloat16")
    with pytest.raises(TypeError, match="threshold may not be stored as float32"):
        QuantizedForest.from_tables(f.attr_idx, f.threshold, f.child, f.class_val, thr_stored="bfloat16", **narrow)
    with pytest.raises(TypeError, match="child may not be stored as int64"):
        QuantizedForest.from_tables(f.attr_idx, bits, f.child.astype(np.int64), f.class_val,
                                    thr_stored="bfloat16", **narrow)
    with pytest.raises(ValueError, match="thr_stored must be"):
        QuantizedForest.from_tables(f.attr_idx, bits, f.child, f.class_val, thr_stored="float16", **narrow)
    with pytest.raises(ValueError, match="child index outside"):
        QuantizedForest.from_tables(f.attr_idx, bits, f.child + 1, f.class_val, thr_stored="bfloat16", **narrow)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuantizedForest(PORT_FOREST, N_ATTRS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forest_eval_fused_q(RECORDS, PORT_FOREST)


# ---------------------------------------------------------------------------
# forest_eval_fused_q against the JAX package's kernels (interpret mode)
# ---------------------------------------------------------------------------


def _carried(jax_q) -> QuantizedForest:
    """The JAX package's layout carried across with ``from_tables``."""
    thr = np.asarray(jax_q.threshold)
    return QuantizedForest.from_tables(
        np.asarray(jax_q.attr_idx), thr.view(np.uint16) if jax_q.thr_stored != "float32" else thr,
        np.asarray(jax_q.child), np.asarray(jax_q.class_val), thr_dtype=jax_q.thr_dtype,
        thr_stored=jax_q.thr_stored, fallback_nodes=jax_q.fallback_nodes,
        max_depth=jax_q.max_depth, n_attrs=jax_q.n_attrs, device="cpu",
    )


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_forest_eval_fused_q_matches_jax_on_adversarial_records(algorithm):
    """Universal bf16 (stored f32), split-safe f16 (stored f16) and the
    f16 layout carried across: raw records, ±inf and NaN included."""
    for kw in (dict(thr_dtype="bfloat16"), dict(thr_dtype="float16", calibration=RECORDS)):
        jax_q = jq.QuantizedForest(FOREST, N_ATTRS, **kw)
        want = np.asarray(jax_forest_eval_fused_q(jnp.asarray(RECORDS), jax_q, algorithm=algorithm))
        got = forest_eval_fused_q(RECORDS, PORT_FOREST, algorithm=algorithm, device="cpu", **kw)
        assert got.device.type == "cpu"
        assert_same(got, want, f"{algorithm}/{kw['thr_dtype']}")
        carried = _carried(jax_q)
        assert (carried.n_nodes, carried.thr_stored) == (jax_q.n_nodes, jax_q.thr_stored)
        assert_same(forest_eval_fused_q(cpu(RECORDS), carried, algorithm=algorithm), want, "carried")
    # universal layouts are exact for any input: they equal the f32 reference
    ref = forest_eval_ref(RECORDS, PORT_FOREST.attr_idx, PORT_FOREST.threshold, PORT_FOREST.child,
                          PORT_FOREST.class_val, max_depth=PORT_FOREST.max_depth, device="cpu")
    assert_same(forest_eval_fused_q(RECORDS, PORT_FOREST, algorithm=algorithm, device="cpu"), ref, "universal")


def test_quantized_wrappers_on_cpu_are_their_plain_versions():
    q = QuantizedForest(PORT_FOREST, N_ATTRS, calibration=RECORDS, thr_dtype="float16", device="cpu")
    rec = cpu(RECORDS)
    tabs = (q.attr_idx, q.threshold, q.child, q.class_val)
    K.reset_launches()
    got = K.fused_speculative_q(rec, *tabs, total_jumps=3, block_m=8)
    assert_same(got, K.fused_speculative_q_plain(rec, *tabs, total_jumps=3), "K7")
    got = K.fused_data_parallel_q(rec, *tabs, max_depth=q.max_depth, block_m=32)
    assert_same(got, K.fused_data_parallel_q_plain(rec, *tabs, max_depth=q.max_depth), "K8")
    assert all(v == 0 for v in K.LAUNCHES.values())
    meta = torch.empty((5, N_ATTRS), device="meta")
    with pytest.raises(ValueError, match="kernels take CPU or CUDA tensors"):
        K.fused_speculative_q(meta, *tabs, total_jumps=3, block_m=8)
    with pytest.raises(ValueError, match="tables are on cpu"):
        forest_eval_fused_q(meta, q)
    with pytest.raises(ValueError, match="unknown algorithm"):
        forest_eval_fused_q(rec, q, algorithm="serial")


def test_quantized_tile_is_the_gather_footprint():
    """K7/K8 widen their tables in shared memory: the tile and the bytes a
    launch is given are those of K3 gather and K4."""
    for n in (51, 255, 1023):
        for algorithm in ALGORITHMS:
            bm = ops.choose_block_m(n, 19, algorithm=algorithm)
            assert K._tile_smem(algorithm, bm, 19, n, "gather") == K.smem_bytes(algorithm, bm, 19, n, "gather")


# ---------------------------------------------------------------------------
# the quantization properties of tests/test_quant_properties.py, on the port
# ---------------------------------------------------------------------------

P_ATTRS, P_CLASSES = 5, 4


def _prop_forest(seed: int, depth: int) -> EncodedForest:
    return EncodedForest([breadth_first_encode(random_tree(
        n_attrs=P_ATTRS, n_classes=P_CLASSES, max_depth=depth, min_depth=min(depth, 2), seed=seed + i))
        for i in range(3)])


def _f32_ref(forest: EncodedForest, rec) -> torch.Tensor:
    return forest_eval_ref(rec, forest.attr_idx, forest.threshold, forest.child, forest.class_val,
                           max_depth=max(int(forest.max_depth), 1), device="cpu")


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    depth=st.integers(min_value=1, max_value=7),
    thr_dtype=st.sampled_from(THR),
    scale=st.floats(min_value=0.05, max_value=50.0),
)
def test_split_safe_roundtrip_preserves_calibration_routing(seed, depth, thr_dtype, scale):
    forest = _prop_forest(seed, depth)
    rng = np.random.default_rng(seed)
    cal = (rng.normal(size=(64, P_ATTRS)) * scale).astype(np.float32)
    thr = np.unique(forest.threshold[np.isfinite(forest.threshold)])
    if thr.size:
        cal[: min(8, thr.size), 0] = thr[: min(8, thr.size)].astype(np.float32)
    for algorithm in ALGORITHMS:
        got = forest_eval_fused_q(cal, forest, thr_dtype=thr_dtype, calibration=cal,
                                  algorithm=algorithm, device="cpu")
        assert torch.equal(got, _f32_ref(forest, cal)), (seed, depth, thr_dtype, scale, algorithm)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000), thr_dtype=st.sampled_from(THR))
def test_quantized_interval_membership(seed, thr_dtype):
    """Every quantized threshold lies inside its node's routing interval."""
    enc = breadth_first_encode(random_tree(n_attrs=P_ATTRS, n_classes=P_CLASSES, max_depth=5, seed=seed))
    cal = np.random.default_rng(seed).normal(size=(128, P_ATTRS)).astype(np.float32)
    attr_values = {a: np.sort(cal[:, a].astype(np.float64)) for a in range(P_ATTRS)}
    leaf = enc.is_leaf_mask
    q, safe = Q.quantize_thresholds(enc.threshold, leaf, enc.attr_idx, thr_dtype=thr_dtype,
                                    attr_values=attr_values)
    up = Q.from_bits(q, thr_dtype)
    for n in range(enc.n_nodes):
        if leaf[n]:
            assert safe[n], "leaves (+inf self-loops) are always safe"
            continue
        v_lo, v_hi = Q.routing_interval(attr_values[int(enc.attr_idx[n])], float(enc.threshold[n]))
        assert (v_lo <= float(up[n]) < v_hi) == bool(safe[n]), n


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000), thr_dtype=st.sampled_from(THR))
def test_tie_break_on_quantized_path(seed, thr_dtype):
    """Records exactly on a threshold go left (strict ``>``), universal and
    split-safe calibrated on the tie rows themselves."""
    forest = _prop_forest(seed, 5)
    thr = np.unique(forest.threshold[np.isfinite(forest.threshold)]).astype(np.float32)[:32]
    rec = np.repeat(thr[:, None], P_ATTRS, axis=1)
    want = _f32_ref(forest, rec)
    for cal in (None, rec):
        got = forest_eval_fused_q(rec, forest, thr_dtype=thr_dtype, calibration=cal, device="cpu")
        assert torch.equal(got, want), ("universal" if cal is None else "split-safe", seed)


@pytest.mark.parametrize("thr_dtype", THR)
def test_tie_break_both_directions_single_split(thr_dtype):
    """One split, records straddling and hitting it: left iff ``v <= t``."""
    t = 0.7281349  # not exactly representable in bf16 or f16
    forest = EncodedForest([breadth_first_encode(
        Node(attr=0, threshold=t, left=Node(class_val=0), right=Node(class_val=1)))])
    eps = float(np.finfo(np.float32).eps) * abs(t)
    rec = np.zeros((3, P_ATTRS), np.float32)
    rec[0, 0] = np.float32(t) - np.float32(eps)
    rec[1, 0] = np.float32(t)
    rec[2, 0] = np.nextafter(np.float32(t), np.float32(np.inf))
    assert _f32_ref(forest, rec).tolist() == [[0, 0, 1]]
    qs = QuantizedForest(forest, P_ATTRS, thr_dtype=thr_dtype, calibration=rec, device="cpu")
    for algorithm in ALGORITHMS:
        assert forest_eval_fused_q(cpu(rec), qs, algorithm=algorithm).tolist() == [[0, 0, 1]]

