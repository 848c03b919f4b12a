"""Where the port runs, and its CUDA kernels on the card.

Imports nothing of JAX, so the card tests run on a machine without it:

    python -m pytest -m gpu tests/test_torch_device.py

Tests marked ``gpu`` decide inside a fixture whether there is a card and skip
without one; each holds a CUDA kernel against its plain version with
``torch.equal``.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BOTTOM,
    EncodedForest,
    Node,
    breadth_first_encode,
    majority_vote,
    random_tree,
    sanitize_records,
    vote_winner,
)
from repro_torch.kernels.tree_eval import CascadeEvaluator, QuantizedForest, plan_cascade
from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.kernels.tree_eval import ops
from repro_torch.core.forest import vote_counts
from repro_torch.kernels.tree_eval.quant import from_bits, to_bits
from repro_torch.kernels.tree_eval.ref import forest_eval_ref, tree_eval_ref

REPO = Path(__file__).resolve().parents[1]
MODES = [("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")]
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)
THR_STORAGES = ["bfloat16", "float16", "float32"]
INDEX_DTYPES = (torch.int8, torch.int16, torch.int32)


def _tree(depth: int, seed: int, balance: float = 1.0):
    if depth == 0:
        return breadth_first_encode(Node(class_val=3))
    return breadth_first_encode(
        random_tree(n_attrs=19, n_classes=7, max_depth=depth, seed=seed, balance=balance)
    )


def _quant_forest(thr_stored: str, depths=(0, 1, 3, 5, 7), device=None) -> QuantizedForest:
    """A universal quantized forest stored as ``thr_stored``; a tree of depth
    7 is perfect (N = 255, so ``child`` needs int16).  For a narrow storage
    the thresholds are first snapped to it (so every node round-trips); for
    f32 they are left as drawn (so nodes fall back)."""
    forest = EncodedForest([_tree(d, seed=d, balance=1.0 if d == 7 else 0.7) for d in depths])
    thr_dtype = "bfloat16" if thr_stored == "float32" else thr_stored
    if thr_stored != "float32":
        internal = forest.class_val == -1
        forest.threshold[internal] = from_bits(to_bits(forest.threshold[internal], thr_dtype), thr_dtype)
    q = QuantizedForest(forest, 19, thr_dtype=thr_dtype, device=device)
    assert q.thr_stored == thr_stored
    return q


def _records(m: int, seed: int = 3) -> np.ndarray:
    """(m, 19) records with exact ties, ±inf and NaN rows up front."""
    rec = np.random.default_rng(seed).normal(size=(max(m, 8), 19)).astype(np.float32)
    rec[0], rec[1], rec[2], rec[3] = 0.5, 0.0, np.inf, -np.inf
    rec[4, ::2], rec[4, 1::2] = np.inf, -np.inf
    rec[5], rec[6, ::3] = np.nan, np.nan
    rec[7, :4] = [np.nan, np.inf, -np.inf, 0.5]
    return rec[:m]


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "examples").glob("*_torch.py"))
             + [REPO / "tests" / f"test_torch_{n}.py" for n in ("device", "obs_perf", "obs_smoke", "examples")])
    assert len(files) > 10
    # the training path's modules (the data pipeline is a copy of a jax-free module) and the LM families'
    for name in ("utils/losses.py", "optim/adamw.py", "train/step.py", "train/loop.py", "ckpt/checkpoint.py",
                 "data/pipeline.py", "configs/shapes.py", "launch/train.py", "models/lm.py", "models/convert.py",
                 "models/layers/ssm.py", "models/layers/xlstm.py", "models/xlstm_lm.py", "models/encdec.py",
                 "models/layers/tree_head.py", "obs/perf.py", "obs/smoke.py", "configs/paper_segmentation.py"):
        assert REPO / "src" / "repro_torch" / name in files, name
    for name in ("quickstart", "segmentation_service", "serve_lm", "train_lm", "tree_router_moe"):
        assert REPO / "examples" / f"{name}_torch.py" in files, name
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN_IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_forbidden_import_pattern_catches_what_it_should():
    for line in ("import jax", "from jax.numpy import x", "import repro.core", "  from repro import a",
                 "import ml_dtypes", "from ml_dtypes import bfloat16"):
        assert FORBIDDEN_IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x", "import jaxlib_like_name_x"):
        assert not FORBIDDEN_IMPORT.search(line), line


def test_numpy_input_without_device_raises_without_a_card(monkeypatch):
    """No card and no device="cpu": the kernel entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc, rec = _tree(4, seed=1), _records(20)
    forest = EncodedForest([enc, _tree(2, seed=2)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.tree_eval(rec, enc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.forest_eval_fused(rec, forest)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.PackedTree(enc, 19)
    got = ops.tree_eval(rec, enc, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, ops.tree_eval(torch.from_numpy(rec), enc))


def test_tables_and_records_on_different_devices_are_refused():
    packed = ops.PackedTree(_tree(3, seed=1), 19, device="cpu")
    with pytest.raises(ValueError, match="tables are on cpu"):
        ops.tree_eval(torch.empty((4, 19), device="meta"), packed)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _jumps(max_depth: int) -> int:
    return max(1, int(np.ceil(np.log2(max(max_depth, 2)))))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 1000, 65_536])
@pytest.mark.parametrize("depth,balance", [(0, 1.0), (1, 1.0), (6, 0.7), (8, 1.0), (9, 0.6)])
def test_tree_kernels_equal_plain_on_card(cuda_device, m, depth, balance):
    raw = torch.from_numpy(_records(m)).to(cuda_device)
    clean = sanitize_records(raw)
    packed = ops.PackedTree(_tree(depth, seed=depth, balance=balance), 19, device=cuda_device)
    jumps = _jumps(packed.max_depth)
    for mode, rec in (("gather", raw), ("onehot", clean)):
        args = (rec, packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
        bm = ops.choose_block_m(packed.n_nodes, 19, jump_mode=mode)
        got = K.speculative(*args, total_jumps=jumps, jump_mode=mode, block_m=bm)
        assert torch.equal(got, K.speculative_plain(*args, total_jumps=jumps, jump_mode=mode)), mode
    args = (raw, packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    got = K.data_parallel(*args, max_depth=packed.max_depth, block_m=256)
    assert torch.equal(got, K.data_parallel_plain(*args, max_depth=packed.max_depth))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 65_536])
@pytest.mark.parametrize("block_m", [None, 1, 32])
def test_forest_kernels_equal_plain_on_card(cuda_device, m, block_m):
    raw = torch.from_numpy(_records(m)).to(cuda_device)
    clean = sanitize_records(raw)
    forest = EncodedForest([_tree(d, seed=d, balance=0.7) for d in (0, 1, 3, 5, 8)])
    packed = ops.PackedForest(forest, 19, device=cuda_device)
    jumps = _jumps(packed.max_depth)
    for mode, rec in (("gather", raw), ("onehot", clean)):
        args = (rec, packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
        bm = block_m or ops.choose_block_m(packed.n_nodes, 19, jump_mode=mode)
        got = K.fused_speculative(*args, total_jumps=jumps, jump_mode=mode, block_m=bm)
        assert torch.equal(got, K.fused_speculative_plain(*args, total_jumps=jumps, jump_mode=mode)), mode
    args = (raw, packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    got = K.fused_data_parallel(*args, max_depth=packed.max_depth, block_m=block_m or 256)
    assert torch.equal(got, K.fused_data_parallel_plain(*args, max_depth=packed.max_depth))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 65_536])
@pytest.mark.parametrize("block_m", [None, 1, 32])
@pytest.mark.parametrize("n_classes", [7, 3])
def test_vote_kernels_equal_plain_on_card(cuda_device, m, block_m, n_classes):
    """K5/K6; at C = 3 the forest's classes 3..6 cast no vote."""
    raw = torch.from_numpy(_records(m)).to(cuda_device)
    clean = sanitize_records(raw)
    forest = EncodedForest([_tree(d, seed=d, balance=0.7) for d in (0, 1, 3, 5, 8)])
    packed = ops.PackedForest(forest, 19, device=cuda_device)
    jumps = _jumps(packed.max_depth)
    for mode, rec in (("gather", raw), ("onehot", clean)):
        args = (rec, packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
        bm = block_m or ops.choose_block_m(packed.n_nodes, 19, jump_mode=mode, n_classes=n_classes)
        kw = dict(n_classes=n_classes, total_jumps=jumps, jump_mode=mode)
        got = K.fused_votes_speculative(*args, block_m=bm, **kw)
        assert torch.equal(got, K.fused_votes_speculative_plain(*args, **kw)), mode
    args = (raw, packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    kw = dict(n_classes=n_classes, max_depth=packed.max_depth)
    got = K.fused_votes_data_parallel(*args, block_m=block_m or 256, **kw)
    assert torch.equal(got, K.fused_votes_data_parallel_plain(*args, **kw))


@pytest.mark.gpu
def test_ops_on_card_launch_each_kernel_once_and_match_ref(cuda_device):
    rec = _records(500, seed=9)
    enc = _tree(6, seed=2, balance=0.8)
    forest = EncodedForest([_tree(d, seed=d, balance=0.7) for d in (1, 4, 6)])
    want_tree = tree_eval_ref(rec, *enc, max_depth=6, device="cpu")
    want_forest = forest_eval_ref(rec, forest.attr_idx, forest.threshold, forest.child,
                                  forest.class_val, max_depth=forest.max_depth, device="cpu")
    want_winner = majority_vote(want_forest, 7)
    quant = {s: _quant_forest(s, depths=(1, 4, 6), device=cuda_device) for s in THR_STORAGES}
    want_quant = {s: forest_eval_ref(rec, q.attr_idx.cpu(), q.threshold.float().cpu(), q.child.cpu(),
                                     q.class_val.cpu(), max_depth=q.max_depth, device="cpu")
                  for s, q in quant.items()}
    K.reset_launches()
    for algorithm, jump_mode in MODES:
        got = ops.tree_eval(rec, enc, algorithm=algorithm, jump_mode=jump_mode)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want_tree), (algorithm, jump_mode)
        got = ops.forest_eval_fused(rec, forest, algorithm=algorithm, jump_mode=jump_mode)
        assert torch.equal(got.cpu(), want_forest), (algorithm, jump_mode)
        votes = ops.forest_votes_fused(rec, forest, n_classes=7, algorithm=algorithm, jump_mode=jump_mode)
        assert votes.device.type == "cuda" and votes.shape == (500, 7)
        assert torch.equal(vote_winner(votes).cpu(), want_winner), (algorithm, jump_mode)
    for algorithm in ops.ALGORITHMS:
        for storage, q in quant.items():
            got = ops.forest_eval_fused_q(rec, q, algorithm=algorithm)
            assert torch.equal(got.cpu(), want_quant[storage]), (algorithm, storage)
    assert all(v == 1 for v in K.LAUNCHES.values()), K.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_cascade_on_card_equals_cascade_on_cpu(cuda_device, algorithm, jump_mode):
    rec = np.random.default_rng(4).normal(size=(3000, 19)).astype(np.float32)
    forest = EncodedForest([_tree(2 + i % 5, seed=i, balance=0.7) for i in range(12)])
    for stages, bound in ((2, 1.0), (3, 0.5), (3, None)):
        plan = plan_cascade(forest, rec, n_classes=7, stages=stages, bound=bound, device=cuda_device)
        assert plan == plan_cascade(forest, rec, n_classes=7, stages=stages, bound=bound, device="cpu")
        kw = dict(n_classes=7, bound=bound, algorithm=algorithm, jump_mode=jump_mode)
        card = CascadeEvaluator(forest, plan, device=cuda_device, **kw)
        assert card.engine == "cuda"
        K.reset_launches()
        got = card(rec)
        assert K.LAUNCHES[f"fused_votes_{algorithm}" + (f"/{jump_mode}" if algorithm == "speculative" else "")] \
            == got.stages_run
        want = CascadeEvaluator(forest, plan, device="cpu", engine="cuda", **kw)(rec)
        for field in ("classes", "margin", "trees_evaluated", "exit_stage", "confidence"):
            assert getattr(got, field).device.type == "cuda"
            assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), (stages, bound, field)
        assert (got.stages_run, got.stage_survivors) == (want.stages_run, want.stage_survivors)


def _bfs_forest(n_nodes: int, n_trees: int, seed: int, n_attrs: int = 19, n_classes: int = 7):
    """(T, N) int32/f32 tables of random breadth-first trees of exactly
    ``n_nodes`` nodes (unreachable self-looping leaves pad a tree that stops
    short), and the forest's depth.  Tree 0 splits every node it can (the
    deepest); the others stop at random.  Thresholds are multiples of 1/8
    (exact in bf16 and f16; 0.5 ties the adversarial records), and leaf
    classes are drawn from [0, n_classes], one past the vote kernels' C."""
    rng = np.random.default_rng(seed)
    attr = np.zeros((n_trees, n_nodes), np.int32)
    thr = np.full((n_trees, n_nodes), np.inf, np.float32)
    child = np.tile(np.arange(n_nodes, dtype=np.int32), (n_trees, 1))
    cls = rng.integers(0, n_classes + 1, (n_trees, n_nodes)).astype(np.int32)
    depth = 0
    for t in range(n_trees):
        level, queue, nxt = {0: 0}, [0], 1
        while queue and nxt + 2 <= n_nodes:
            node = queue.pop(0)
            if t and rng.random() < 0.2:
                continue                      # a leaf
            attr[t, node] = rng.integers(0, n_attrs)
            thr[t, node] = rng.integers(-16, 17) / 8
            child[t, node], cls[t, node] = nxt, BOTTOM
            for c in (nxt, nxt + 1):
                level[c] = level[node] + 1
                queue.append(c)
            nxt += 2
        depth = max(depth, max(level.values()))
    return attr, thr, child, cls, depth


def _select(attr: torch.Tensor, n_attrs: int) -> torch.Tensor:
    """The one-hot form's (T, A, N) attr_select of (T, N) attribute indices."""
    return torch.nn.functional.one_hot(attr.long(), n_attrs).transpose(-1, -2).float().contiguous()


def _narrowest(table: torch.Tensor) -> torch.Tensor:
    return next(table.to(dt) for dt in INDEX_DTYPES if int(table.max()) <= torch.iinfo(dt).max)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes", [1, 31, 32, 33, 63, 64, 65, 1023])
@pytest.mark.parametrize("n_trees", [1, 9, 16])
def test_speculative_kernels_across_cut_offs_on_card(cuda_device, n_nodes, n_trees):
    """K1 (T = 1), K3 and K5 in both forms and K7 in every threshold storage
    against their plain versions, on both sides of the register slots' cut-off
    (N 32) and of the register/shared one (N 64), for every jump count up to
    the forest's, M with full and partial tiles (the default tile and one of
    3 rows), and C ∈ {2, 7} with classes outside [0, C)."""
    attr, thr, child, cls, depth = _bfs_forest(n_nodes, n_trees, seed=n_nodes * 100 + n_trees)
    attr, thr, child, cls = (torch.from_numpy(x).to(cuda_device) for x in (attr, thr, child, cls))
    sel = _select(attr, 19)
    narrow = (_narrowest(attr), _narrowest(child), _narrowest(cls))
    for m in (1, 7, 1000, 65_536):
        raw = torch.from_numpy(_records(m)).to(cuda_device)
        for mode, rec in (("gather", raw), ("onehot", sanitize_records(raw))):
            args = (rec, attr, sel, thr, child, cls)
            for jumps in range(_jumps(depth) + 1):
                want = K.fused_speculative_plain(*args, total_jumps=jumps, jump_mode=mode)
                for tile in (None, 3):
                    key = (m, mode, jumps, tile)
                    bm = tile or ops.choose_block_m(n_nodes, 19, jump_mode=mode)
                    got = K.fused_speculative(*args, total_jumps=jumps, jump_mode=mode, block_m=bm)
                    assert torch.equal(got, want), ("K3", *key)
                    if n_trees == 1:
                        tree = (rec, *(x[0] for x in args[1:]))
                        got = K.speculative(*tree, total_jumps=jumps, jump_mode=mode, block_m=bm)
                        plain = K.speculative_plain(*tree, total_jumps=jumps, jump_mode=mode)
                        assert torch.equal(got, plain), ("K1", *key)
                    for c in (2, 7):
                        bm = tile or ops.choose_block_m(n_nodes, 19, jump_mode=mode, n_classes=c)
                        got = K.fused_votes_speculative(*args, n_classes=c, total_jumps=jumps,
                                                        jump_mode=mode, block_m=bm)
                        # K5's plain version is vote_counts of K3's
                        assert torch.equal(got, vote_counts(want, c)), ("K5", c, *key)
                    if mode == "gather":
                        bm = tile or ops.choose_block_m(n_nodes, 19)
                        for storage in THR_STORAGES:
                            q_thr = thr.to(getattr(torch, storage))
                            got = K.fused_speculative_q(raw, narrow[0], q_thr, *narrow[1:],
                                                        total_jumps=jumps, block_m=bm)
                            assert torch.equal(got, want), ("K7", storage, *key)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes", [1, 51, 1023])
@pytest.mark.parametrize("n_trees", [1, 5, 9, 16])
def test_data_parallel_kernels_across_chunks_and_chains_on_card(cuda_device, n_nodes, n_trees):
    """K2 (tree 0), K4, K6 and K8 in every threshold storage against their
    plain versions: a forest staged whole (N 51) and one in several chunks
    (N 1,023 × T 16), trees of depth 0 (N 1), T not a multiple of the four
    chains a thread walks, M with partial last tiles, block_m None, 1 and 32,
    C ∈ {2, 3, 7, 128} with classes outside [0, C), adversarial records."""
    attr, thr, child, cls, depth = _bfs_forest(n_nodes, n_trees, seed=n_nodes * 7 + n_trees)
    attr, thr, child, cls = (torch.from_numpy(x).to(cuda_device) for x in (attr, thr, child, cls))
    narrow = (_narrowest(attr), _narrowest(child), _narrowest(cls))
    for m in (1, 7, 1000, 65_536):
        rec = torch.from_numpy(_records(m)).to(cuda_device)
        want = K.fused_data_parallel_plain(rec, attr, thr, child, cls, max_depth=depth)
        tree = (rec, attr[0], thr[0], child[0], cls[0])
        want_tree = K.data_parallel_plain(*tree, max_depth=depth)
        for tile in (None, 1, 32):
            key = (m, tile)
            bm = tile or ops.choose_block_m(n_nodes, 19, algorithm="data_parallel")
            got = K.fused_data_parallel(rec, attr, thr, child, cls, max_depth=depth, block_m=bm)
            assert torch.equal(got, want), ("K4", *key)
            assert torch.equal(K.data_parallel(*tree, max_depth=depth, block_m=bm), want_tree), ("K2", *key)
            for storage in THR_STORAGES:
                got = K.fused_data_parallel_q(rec, narrow[0], thr.to(getattr(torch, storage)), *narrow[1:],
                                              max_depth=depth, block_m=bm)
                assert torch.equal(got, want), ("K8", storage, *key)
            for c in (2, 3, 7, 128):
                bm = tile or ops.choose_block_m(n_nodes, 19, algorithm="data_parallel", n_classes=c)
                got = K.fused_votes_data_parallel(rec, attr, thr, child, cls, n_classes=c, max_depth=depth,
                                                  block_m=bm)
                assert torch.equal(got, vote_counts(want, c)), ("K6", c, *key)


@pytest.mark.gpu
@pytest.mark.parametrize("n_attrs", [1, 2, 4, 19, 20])
def test_data_parallel_record_tile_strides_on_card(cuda_device, n_attrs):
    """The record tile at odd A (its rows as they lie) and even A (rows
    padded to an odd stride), from 16-byte aligned records and from a view
    that starts one record in (aligned only when 4 divides A)."""
    attr, thr, child, cls, depth = _bfs_forest(63, 9, seed=n_attrs, n_attrs=n_attrs)
    attr, thr, child, cls = (torch.from_numpy(x).to(cuda_device) for x in (attr, thr, child, cls))
    rec = np.random.default_rng(n_attrs).normal(size=(3001, n_attrs)).astype(np.float32)
    rec[1], rec[2, ::2], rec[3] = np.inf, -np.inf, np.nan
    rec = torch.from_numpy(rec).to(cuda_device)
    for view in (rec[:3000], rec[1:]):
        assert view.is_contiguous()
        want = K.fused_data_parallel_plain(view, attr, thr, child, cls, max_depth=depth)
        for bm in (None, 1, 5, 32):
            bm = bm or ops.choose_block_m(63, n_attrs, algorithm="data_parallel", n_classes=7)
            got = K.fused_data_parallel(view, attr, thr, child, cls, max_depth=depth, block_m=bm)
            assert torch.equal(got, want), (view.data_ptr() % 16, bm)
            got = K.fused_votes_data_parallel(view, attr, thr, child, cls, n_classes=7, max_depth=depth, block_m=bm)
            assert torch.equal(got, vote_counts(want, 7)), (view.data_ptr() % 16, bm)
            got = K.data_parallel(view, attr[0], thr[0], child[0], cls[0], max_depth=depth, block_m=bm)
            assert torch.equal(got, want[0]), (view.data_ptr() % 16, bm)


@pytest.mark.gpu
def test_data_parallel_grid_is_a_whole_wave_on_card(cuda_device):
    """A cascade's second stage (a few thousand survivors, 7 trees) spreads
    over more CTAs than ceil(M / block_m), one per 128 records, each taking
    an equal run; at 65,536 records the grid stays within what the card
    holds at once, and K2 gives each thread two records."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    bm = ops.choose_block_m(51, 19, algorithm="data_parallel", n_classes=7)
    grid, per_sm = K.launch_grid(6, 0, 7241, bm, 19, 51, n_classes=7, n_trees=7)
    assert per_sm >= 1 and grid == -(-7241 // K.dp_threads(bm)) > -(-7241 // bm)
    for kernel, variant in ((4, 0), (6, 0), (8, 0), (8, 1), (8, 2)):
        grid, per_sm = K.launch_grid(kernel, variant, 65_536, 256, 19, 51, n_classes=7 * (kernel == 6), n_trees=16)
        assert 1 <= grid <= sms * per_sm and grid <= 65_536 // K.dp_threads(256)
    grid, _ = K.launch_grid(2, 0, 65_536, 256, 19, 75)
    assert grid <= 65_536 // 256


@pytest.mark.gpu
@pytest.mark.parametrize("n_attrs", [1, 20, 21, 40, 41])
@pytest.mark.parametrize("n_nodes", [32, 51, 64])
def test_onehot_select_register_cut_off_on_card(cuda_device, n_attrs, n_nodes):
    """The one-hot form keeps a lane's attr_select columns in registers while
    A·slots ≤ 40 and takes the shared path beyond; both sides equal the plain
    version (sanitized records with ±inf and NaN rows, 5 trees)."""
    attr, thr, child, cls, depth = _bfs_forest(n_nodes, 5, seed=n_attrs + n_nodes, n_attrs=n_attrs)
    attr, thr, child, cls = (torch.from_numpy(x).to(cuda_device) for x in (attr, thr, child, cls))
    rec = np.random.default_rng(n_attrs).normal(size=(3000, n_attrs)).astype(np.float32)
    rec[0], rec[1, ::2], rec[2] = np.inf, -np.inf, np.nan
    rec = sanitize_records(torch.from_numpy(rec).to(cuda_device))
    args = (rec, attr, _select(attr, n_attrs), thr, child, cls)
    for jumps in range(_jumps(depth) + 1):
        want = K.fused_speculative_plain(*args, total_jumps=jumps, jump_mode="onehot")
        bm = ops.choose_block_m(n_nodes, n_attrs, jump_mode="onehot")
        got = K.fused_speculative(*args, total_jumps=jumps, jump_mode="onehot", block_m=bm)
        assert torch.equal(got, want), (jumps, K.jump_slots(n_nodes, n_attrs, "onehot"))


@pytest.mark.gpu
def test_bad_tiles_and_tables_raise_on_card(cuda_device):
    packed = ops.PackedTree(_tree(8, seed=5), 19, device=cuda_device)
    rec = torch.zeros((10, 19), device=cuda_device)
    args = (rec, packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
    with pytest.raises(ValueError, match="shared memory"):
        K.speculative(*args, total_jumps=3, jump_mode="onehot", block_m=4096)
    with pytest.raises(ValueError, match="attr_idx must be contiguous"):
        K.speculative(rec, packed.attr_idx.double(), *args[2:], total_jumps=3, jump_mode="gather", block_m=4)
    with pytest.raises(ValueError, match="block_m=2048"):
        K.data_parallel(rec, packed.attr_idx, packed.threshold, packed.child, packed.class_val,
                        max_depth=3, block_m=2048)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 65_536])
@pytest.mark.parametrize("block_m", [None, 1, 32])
@pytest.mark.parametrize("thr_stored", THR_STORAGES)
def test_quantized_kernels_equal_plain_on_card(cuda_device, m, block_m, thr_stored):
    """K7/K8 on every index width the tables fit in, in each threshold storage."""
    raw = torch.from_numpy(_records(m)).to(cuda_device)
    q = _quant_forest(thr_stored, device=cuda_device)
    jumps = _jumps(q.max_depth)
    spec_want = K.fused_speculative_q_plain(raw, q.attr_idx, q.threshold, q.child, q.class_val,
                                            total_jumps=jumps)
    dp_want = K.fused_data_parallel_q_plain(raw, q.attr_idx, q.threshold, q.child, q.class_val,
                                            max_depth=q.max_depth)
    widths = [[t.to(dt) for dt in INDEX_DTYPES if int(t.max()) <= torch.iinfo(dt).max]
              for t in (q.attr_idx, q.child, q.class_val)]
    for attr in widths[0]:
        for child in widths[1]:
            for cls in widths[2]:
                key = (attr.dtype, child.dtype, cls.dtype)
                bm = block_m or ops.choose_block_m(q.n_nodes, 19, algorithm="speculative")
                got = K.fused_speculative_q(raw, attr, q.threshold, child, cls, total_jumps=jumps, block_m=bm)
                assert torch.equal(got, spec_want), key
                got = K.fused_data_parallel_q(raw, attr, q.threshold, child, cls, max_depth=q.max_depth,
                                              block_m=block_m or 256)
                assert torch.equal(got, dp_want), key


@pytest.mark.gpu
def test_quantized_kernels_refuse_bad_tables_on_card(cuda_device):
    q = _quant_forest("bfloat16", device=cuda_device)
    rec = torch.zeros((10, 19), device=cuda_device)
    with pytest.raises(ValueError, match="threshold must be contiguous"):
        K.fused_speculative_q(rec, q.attr_idx, q.threshold.double(), q.child, q.class_val,
                              total_jumps=3, block_m=8)
    with pytest.raises(ValueError, match="child must be contiguous"):
        K.fused_data_parallel_q(rec, q.attr_idx, q.threshold, q.child.long(), q.class_val,
                                max_depth=3, block_m=32)
    with pytest.raises(ValueError, match="block_m=2048"):
        K.fused_data_parallel_q(rec, q.attr_idx, q.threshold, q.child, q.class_val,
                                max_depth=3, block_m=2048)


# ---------------------------------------------------------------------------
# subnormals, the profiler, the tuner and the serve engine on the card
# ---------------------------------------------------------------------------

SUBNORMALS = np.array([1e-45, -1e-45, 1e-40, -1e-40, 2.0**-140, -(2.0**-140), 0.0, -0.0], np.float32)


@pytest.mark.gpu
def test_kernels_keep_subnormals_on_card(cuda_device):
    """K1–K8 compare subnormals as IEEE does (the build has no -ftz): equal to
    their plain versions and to the serial descent on the host."""
    from repro_torch.core import eval_serial

    rng = np.random.default_rng(11)
    forest = EncodedForest([_tree(d, seed=d, balance=0.7) for d in (1, 3, 5, 7)])
    split = forest.class_val == BOTTOM
    forest.threshold[split] = rng.choice(SUBNORMALS, int(split.sum()))
    rec_np = rng.choice(SUBNORMALS, size=(3000, 19)).astype(np.float32)
    rec = torch.from_numpy(rec_np).to(cuda_device)
    serial = np.stack([eval_serial(forest.tree(t), rec_np) for t in range(forest.n_trees)])
    for algorithm, jump_mode in MODES:
        for t in range(forest.n_trees):
            got = ops.tree_eval(rec, forest.tree(t), algorithm=algorithm, jump_mode=jump_mode)
            assert np.array_equal(got.cpu().numpy(), serial[t]), (algorithm, jump_mode, t)
        got = ops.forest_eval_fused(rec, forest, algorithm=algorithm, jump_mode=jump_mode)
        assert np.array_equal(got.cpu().numpy(), serial), (algorithm, jump_mode)
        votes = ops.forest_votes_fused(rec, forest, n_classes=7, algorithm=algorithm, jump_mode=jump_mode)
        assert np.array_equal(votes.cpu().numpy(), (serial[..., None] == np.arange(7)).sum(0))
    for thr_stored in THR_STORAGES:
        q = QuantizedForest(forest, 19, thr_dtype="bfloat16" if thr_stored == "float32" else thr_stored,
                            device=cuda_device)
        for algorithm in ops.ALGORITHMS:
            got = ops.forest_eval_fused_q(rec, q, algorithm=algorithm)
            assert np.array_equal(got.cpu().numpy(), serial), (algorithm, thr_stored, q.thr_stored)


@pytest.mark.gpu
def test_profile_on_card_equals_profile_on_cpu(cuda_device):
    from repro_torch.kernels.tree_eval import profile_forest_eval, profile_tree_eval

    rec = _records(5000, seed=12)
    enc = _tree(7, seed=3, balance=0.7)
    forest = EncodedForest([_tree(d, seed=d, balance=0.7) for d in (2, 5, 7)])
    for card, host in ((profile_tree_eval(rec, enc), profile_tree_eval(rec, enc, device="cpu")),
                       (profile_forest_eval(rec, forest), profile_forest_eval(rec, forest, device="cpu"))):
        for field, got, want in zip(card._fields, card, host):
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want), field
        assert card.d_mu() == host.d_mu()


@pytest.mark.gpu
def test_default_space_on_card_holds_only_kernels(cuda_device):
    from repro_torch.kernels.tree_eval.cascade import MAJORITY_FAMILY, get_cascade_variant
    from repro_torch.tune import ForestShape, WorkloadShape, cascade_search_space, forest_search_space
    from repro_torch.tune import search_space

    shape = WorkloadShape(m=65_536, n_nodes=75, n_attrs=19, depth=12)
    tree = list(search_space(shape))
    assert tree and all(ops.get_variant(c.variant).engine == "cuda" for c in tree)
    fshape = ForestShape(t=16, m=65_536, n_nodes=51, n_attrs=19, depth_min=5, depth_max=8)
    forest = [c for c in forest_search_space(fshape, layouts=("f32", "quant")) if c.variant != ops.PER_TREE_FAMILY]
    assert forest and all(ops.get_forest_variant(c.variant).engine == "cuda" for c in forest)
    classes = [c for c in cascade_search_space(fshape, 7) if c.variant != MAJORITY_FAMILY]
    assert classes and all(get_cascade_variant(c.variant).engine == "cuda" for c in classes)


@pytest.mark.gpu
def test_each_measured_candidate_launches_its_kernel_on_card(cuda_device, tmp_path):
    from repro_torch.tune import TuneCache, tune_workload

    enc = _tree(6, seed=4, balance=0.8)
    entry, measurements = tune_workload(_records(3000, seed=13), enc, cache=TuneCache(tmp_path / "c.json"),
                                        warmup=1, iters=2)
    assert entry.variant.startswith("cuda_")
    for m in measurements:
        spec = ops.get_variant(m.candidate.variant)
        key = spec.algorithm + (f"/{spec.jump_mode}" if spec.algorithm == "speculative" else "")
        assert not m.failed and m.launches == {key: 3}, (m.candidate, m.launches)


@pytest.mark.gpu
def test_kernel_faults_propagate_out_of_the_tuner_on_card(cuda_device, tmp_path, monkeypatch):
    """A failed build or launch is a fault, never an infinitely slow candidate."""
    from repro_torch.tune import Candidate, TuneCache, TunedEvaluator, measure_candidate, tune_workload

    enc, rec = _tree(5, seed=6, balance=0.8), _records(2000, seed=14)

    def broken_build():
        raise RuntimeError("nvcc failed (forced)")

    monkeypatch.setattr(K, "_library", broken_build)
    padded = torch.from_numpy(rec).to(cuda_device)
    with pytest.raises(RuntimeError, match="forced"):
        measure_candidate(Candidate.make("cuda_data_parallel", block_m=64), padded, enc, max_depth=5)
    with pytest.raises(RuntimeError, match="forced"):
        tune_workload(rec, enc, cache=TuneCache(tmp_path / "a.json"), warmup=1, iters=1)
    with pytest.raises(RuntimeError, match="forced"):
        TunedEvaluator(enc, cache=TuneCache(tmp_path / "b.json"), autotune=True,
                       measure_kw={"warmup": 1, "iters": 1})(rec)
    monkeypatch.undo()

    real = K._launch

    def failing_launch(c_name, *args):
        if c_name == "k1_speculative":
            raise RuntimeError("k1_speculative launch failed: CUDA error 719 (forced)")
        return real(c_name, *args)

    monkeypatch.setattr(K, "_launch", failing_launch)
    with pytest.raises(RuntimeError, match="forced"):
        tune_workload(rec, enc, cache=TuneCache(tmp_path / "c.json"), warmup=1, iters=1)
    monkeypatch.undo()

    # a tile that does not fit the card is the one refusal scored as ∞
    m = measure_candidate(Candidate.make("cuda_speculative_onehot", block_m=128),
                          torch.zeros((64, 4000), device=cuda_device), _tree(9, seed=1), max_depth=9)
    assert m.failed and m.median_ms == float("inf")


@pytest.mark.gpu
def test_tree_serve_engine_on_card_equals_eval_serial(cuda_device, tmp_path):
    from repro_torch import obs
    from repro_torch.core import eval_serial
    from repro_torch.serve import RetunePolicy, TreeRequest, TreeServeEngine
    from repro_torch.tune import TuneCache

    enc = _tree(8, seed=7, balance=0.7)
    rng = np.random.default_rng(15)
    eng = TreeServeEngine(enc, max_batch=8192, cache=TuneCache(tmp_path / "c.json"),
                          retune=RetunePolicy(hot_waves=2, warmup=1, iters=2),
                          profile=obs.ProfilePolicy(sample_every=2), flight=obs.FlightPolicy(out_dir=str(tmp_path)))
    assert eng.device.type == "cuda"
    for round_ in range(3):
        reqs = [TreeRequest(uid=i, records=_records(int(rng.integers(1, 3000)), seed=100 * round_ + i))
                for i in range(12)]
        eng.run(reqs)
        for r in reqs:
            assert np.array_equal(r.out, eval_serial(enc, r.records)), (round_, r.uid)
        eng.retuner.drain(timeout=120)
    eng.profiler.drain()
    assert eng.retuner.errors == [] and eng.stats.retunes >= 1
    counters = obs.snapshot(eng.obs)["counters"]
    assert not counters.get("prof.errors") and counters["prof.sampled"] >= 1
    assert all(ops.get_variant(m.candidate.variant).engine == "cuda" for s in eng.sweeps.values() for m in s)


# ---------------------------------------------------------------------------
# the dist slice on the card: chunker, executor, windowed, the tuner's repair
# ---------------------------------------------------------------------------


def _dist_forest():
    return EncodedForest([_tree(d, seed=d, balance=0.8) for d in (2, 4, 5, 6, 7, 8)])


def _stacked_serial(forest, rec):
    from repro_torch.core import eval_serial

    return np.stack([eval_serial(forest.tree(i), rec) for i in range(forest.n_trees)])


@pytest.mark.gpu
@pytest.mark.parametrize("inflight", [1, 2, 3])
@pytest.mark.parametrize("chunk", [1000, 4096, 7777])
def test_pinned_chunker_equals_monolithic_on_card(cuda_device, tmp_path, inflight, chunk):
    """Pinned double buffering on a copy stream: every chunk size (none divides
    M) and depth of the pipeline gives the monolithic call's classes, also
    when the pinned slots are reused many times."""
    from repro_torch.core import eval_forest_tuned
    from repro_torch.dist import ShardedForestEvaluator, StreamingChunker
    from repro_torch.tune import TuneCache

    forest = _dist_forest()
    rec = _records(30_001, seed=21)
    cache = TuneCache(tmp_path / "c.json")
    mono = eval_forest_tuned(forest, rec, cache=cache).cpu().numpy()
    ck = StreamingChunker(ShardedForestEvaluator(forest, devices=(cuda_device,), cache=cache),
                          chunk_records=chunk, inflight=inflight, auto_coalesce=False)
    for _ in range(3):
        assert np.array_equal(ck.eval(rec), mono)
    assert np.array_equal(mono[:, :3000], _stacked_serial(forest, rec[:3000]))
    assert ck.stats.chunks == 3 * -(-rec.shape[0] // chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("r,g", [(4, 1), (1, 4), (2, 2)])
def test_executor_on_one_card_repeated_equals_tuned(cuda_device, tmp_path, r, g):
    """Four logical shards of one card: each launches its kernel once, and
    the gathered (T, M) equals ``eval_forest_tuned``, padding included."""
    from repro_torch.core import eval_forest_tuned
    from repro_torch.dist import ShardedForestEvaluator
    from repro_torch.parallel.sharding import forest_mesh
    from repro_torch.tune import TuneCache

    forest = _dist_forest()
    rec = _records(10_000, seed=22)
    cache = TuneCache(tmp_path / "c.json")
    ref = eval_forest_tuned(forest, rec, cache=cache).cpu().numpy()
    ev = ShardedForestEvaluator(forest, mesh=forest_mesh(r, g, devices=("cuda:0",) * 4), cache=cache)
    for m in (10_000, 7, 3, 2):
        with K.thread_launches() as launches:
            out = ev(rec[:m])
        assert out.device.type == "cuda" and sum(launches.values()) == r * g, launches
        assert np.array_equal(out.cpu().numpy(), ref[:, :m]), m


@pytest.mark.gpu
def test_windowed_on_a_tree_every_kernel_refuses_on_card(cuda_device):
    from repro_torch.core import eval_serial, eval_windowed, perfect_tree

    big = breadth_first_encode(perfect_tree(14, 19, 7, seed=5))   # N 32,767 at A 19
    rec = _records(4096, seed=23)
    for algorithm, jump_mode in MODES:
        with pytest.raises(K.TileError):
            ops.tree_eval(torch.from_numpy(rec).to(cuda_device), big, algorithm=algorithm, jump_mode=jump_mode)
    out = eval_windowed(big, torch.from_numpy(rec).to(cuda_device), window_levels=4)
    assert out.device.type == "cuda"
    assert np.array_equal(out.cpu().numpy(), eval_serial(big, rec))
    chunked = eval_windowed(big, torch.from_numpy(rec).to(cuda_device), window_levels=3, chunk_records=1000)
    assert np.array_equal(chunked.cpu().numpy(), eval_serial(big, rec))


SCORE_FACTOR = 4.0   # how far a candidate's score may move when waves are served beside the sweep


@pytest.mark.gpu
def test_sweep_under_serving_load_picks_the_same_algorithm_on_card(cuda_device, tmp_path):
    """The tuner's repair: the paper tree's M 65,536 bucket swept on a worker
    thread and stream, once alone and once while another thread serves waves
    through a ``TreeServeEngine``: the winner's algorithm is the same, and no
    candidate's score moves by more than ``SCORE_FACTOR``."""
    import threading

    from repro_torch.core import paper_tree
    from repro_torch.serve import RetunePolicy, TreeRequest, TreeServeEngine
    from repro_torch.tune import TuneCache, tune_workload

    enc = breadth_first_encode(paper_tree())
    batch = np.random.default_rng(24).normal(size=(65_536, 19)).astype(np.float32)
    eng = TreeServeEngine(enc, max_batch=65_536, cache=TuneCache(tmp_path / "c.json"),
                          retune=RetunePolicy(hot_waves=10**9))

    def sweep(loaded: bool):
        stop, out = threading.Event(), {}

        def serve():
            while not stop.is_set():
                eng.run([TreeRequest(uid=i, records=batch[i * 16_384:(i + 1) * 16_384]) for i in range(4)])

        def measure():
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                out["sweep"] = tune_workload(batch, enc, cache=None, warmup=1, iters=3)

        server = threading.Thread(target=serve)
        if loaded:
            server.start()
        worker = threading.Thread(target=measure)
        worker.start()
        worker.join()
        stop.set()
        if loaded:
            server.join()
        return out["sweep"]

    quiet, q_sweep = sweep(False)
    loaded, l_sweep = sweep(True)
    eng.profiler.drain()
    assert ops.get_variant(quiet.variant).algorithm == ops.get_variant(loaded.variant).algorithm, (quiet, loaded)
    q_by = {m.candidate: m for m in q_sweep}
    for m in l_sweep:
        q = q_by[m.candidate]
        assert not m.failed and m.score_ms >= m.median_ms > 0
        assert 1 / SCORE_FACTOR <= m.score_ms / q.score_ms <= SCORE_FACTOR, (m.candidate, q.score_ms, m.score_ms)


@pytest.mark.gpu
def test_grid_query_and_launch_cost_on_the_tensors_device(cuda_device):
    """The occupancy query and SM count are taken under the device they are
    asked for, and one launch's host cost is measured once a device."""
    here = torch.device("cuda", torch.cuda.current_device())
    assert K.launch_grid(4, 0, 65_536, 256, 19, 51, n_trees=16, device=here) == \
        K.launch_grid(4, 0, 65_536, 256, 19, 51, n_trees=16)
    cost = K.launch_cost_ms(here)
    assert 0 < cost < 1 and K.launch_cost_ms("cuda") == cost


@pytest.mark.gpu
def test_executor_and_engine_across_distinct_cards_on_card(cuda_device, tmp_path):
    """On a node of several cards, every decomposition over distinct cards
    (records copied across, each shard on its own card, the output gathered
    on the first) and a forest engine over all of them equal the one-card
    results."""
    from repro_torch.core import eval_forest_tuned
    from repro_torch.dist import ShardedForestEvaluator, StreamingChunker
    from repro_torch.parallel.sharding import forest_mesh, node_devices
    from repro_torch.serve import ForestServeEngine, TreeRequest
    from repro_torch.tune import TuneCache

    cards = node_devices()
    if len(cards) < 2:
        pytest.skip("needs two or more cards")
    forest = _dist_forest()
    rec = _records(20_001, seed=25)
    cache = TuneCache(tmp_path / "c.json")
    ref = eval_forest_tuned(forest, rec, cache=cache).cpu().numpy()
    d = len(cards)
    for r, g in ((d, 1), (1, d), (d // 2, 2)) if d % 2 == 0 else ((d, 1), (1, d)):
        ev = ShardedForestEvaluator(forest, mesh=forest_mesh(r, g, devices=cards), cache=cache)
        for m in (20_001, 7, 2):
            out = ev(rec[:m])
            assert out.device == cards[0]
            assert np.array_equal(out.cpu().numpy(), ref[:, :m]), (r, g, m)
        assert np.array_equal(StreamingChunker(ev, chunk_records=4096).eval(rec), ref)
    eng = ForestServeEngine(forest, max_batch=8192, chunk_records=2048, n_classes=7, cache=cache,
                            decomposition="records", retune=None)
    assert eng._eval.devices == cards
    reqs = eng.run([TreeRequest(uid=i, records=rec[i * 5000:(i + 1) * 5000]) for i in range(4)])
    eng.profiler.drain()
    assert eng.plan.decomposition == "records" and eng.plan.n_devices > 1
    want = majority_vote(torch.from_numpy(ref[:, :20_000]), 7).numpy()
    assert np.array_equal(np.concatenate([r.out for r in reqs]), want)


# ---------------------------------------------------------------------------
# the LM serving path: the tree router on K1 onehot
# ---------------------------------------------------------------------------


def _lm_smoke(depth: int = 3):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("granite-moe")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_tree_depth=depth))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [3, 4, 6])          # N 15, 31, 127
@pytest.mark.parametrize("tokens", [4, 512])
def test_tree_router_launches_k1_onehot_equal_to_plain_on_card(cuda_device, depth, tokens):
    from repro_torch.models.layers import moe as moel

    cfg = _lm_smoke(depth)
    n_int = 2**depth - 1
    g = torch.Generator(device=cuda_device).manual_seed(depth)
    proj = torch.randn((cfg.d_model, n_int), generator=g, device=cuda_device) * 0.2
    thr = torch.randn((n_int,), generator=g, device=cuda_device) * 0.1
    x = torch.randn((1, tokens, cfg.d_model), generator=g, device=cuda_device).to(torch.bfloat16)
    router = moel.TreeRouter(cfg)
    router.pack(thr)
    assert router.packed.n_nodes == 2 ** (depth + 1) - 1
    K.reset_launches()
    got = router(x, proj)
    torch.cuda.synchronize()
    assert K.LAUNCHES["speculative/onehot"] == 1 and sum(K.LAUNCHES.values()) == 1
    z = moel.router_features(x, proj).reshape(-1, n_int)
    p = router.packed
    want = K.speculative_plain(sanitize_records(z), p.attr_idx, p.attr_select, p.threshold, p.child,
                               p.class_val, total_jumps=_jumps(depth), jump_mode="onehot")
    assert got.shape == (1, tokens) and torch.equal(got.reshape(-1), want)
    assert int(got.min()) >= 0 and int(got.max()) < cfg.moe.n_experts


@pytest.mark.gpu
def test_smoke_model_routes_alike_on_card_and_on_cpu(cuda_device):
    """The same weights on the CPU (K1's plain version) and on the card (K1):
    the same experts for every token of every layer, logits within 1e-4 (f32
    on both; cuBLAS and the CPU sum in different orders, a few ulps of
    logits of magnitude ~4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("granite-moe")
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    card.pack_routers()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, size=(4, 33)).astype(np.int32))
    routes = {"cpu": [], "cuda": []}
    for name, model in (("cpu", cpu), ("cuda", card)):
        hooks = [r.register_forward_hook(lambda m, a, out, n=name: routes[n].append(out.cpu()))
                 for r in model.tree_routers()]
        with torch.no_grad():
            logits, _ = model({"tokens": toks.to(model.device)}, serve_hard_tree=True)
        for h in hooks:
            h.remove()
        routes[name].append(logits.cpu())
    *r_cpu, l_cpu = routes["cpu"]
    *r_card, l_card = routes["cuda"]
    assert len(r_cpu) == len(r_card) == cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(r_cpu, r_card))
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_lm_engine_on_card_raises_and_never_falls_back(cuda_device, monkeypatch):
    """A CUDA model whose router is not packed is refused; a K1 launch that
    fails raises out of ServeEngine.run (no plain-version fallback)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    model = build_model(get_smoke_config("granite-moe"), device=cuda_device)
    with pytest.raises(RuntimeError, match="not packed"):
        ServeEngine(model, max_batch=2, max_len=16)
    model.init(torch.Generator(device=cuda_device).manual_seed(0))
    eng = ServeEngine(model, max_batch=2, max_len=16)
    reqs = [Request(uid=i, prompt=np.arange(8, dtype=np.int32) + i, max_new_tokens=3) for i in range(2)]
    K.reset_launches()
    eng.run(reqs)
    assert K.LAUNCHES["speculative/onehot"] == model.cfg.n_layers * 3     # prefill + 2 decode steps

    class FailingLibrary:
        def __getattr__(self, name):
            if name == "tree_eval_error_string":
                return lambda err: b"injected failure"
            return lambda *args: 700       # cudaErrorIllegalAddress

    monkeypatch.setattr(K, "_library", lambda: FailingLibrary())
    with pytest.raises(RuntimeError, match="k1_speculative launch failed"):
        eng.run([Request(uid=9, prompt=np.arange(8, dtype=np.int32), max_new_tokens=2)])


@pytest.mark.gpu
@pytest.mark.parametrize("classes,frames", [(7, 6000), (7, 5), (16, 512)])
def test_tree_head_launches_k1_onehot_equal_to_plain_on_card(cuda_device, classes, frames):
    """The tree head's serving path: one K1 onehot launch a call, every class
    equal to K1's plain version on the same ``z``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import moe as moel
    from repro_torch.models.layers import tree_head as th

    cfg = dataclasses.replace(get_smoke_config("whisper"), tree_head_classes=classes)
    depth = th.tree_head_depth(classes)
    g = torch.Generator(device=cuda_device).manual_seed(classes)
    params = {"proj": torch.randn((cfg.d_model, 2**depth - 1), generator=g, device=cuda_device) * 0.2,
              "thr": torch.randn((2**depth - 1,), generator=g, device=cuda_device) * 0.1}
    x = torch.randn((2, frames, cfg.d_model), generator=g, device=cuda_device)
    K.reset_launches()
    got = th.tree_head_classify(params, x, cfg=cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["speculative/onehot"] == 1 and sum(K.LAUNCHES.values()) == 1
    z = moel.router_features(x, params["proj"]).reshape(-1, 2**depth - 1)
    packed = th.pack_tree_head(cfg, params["thr"])
    want = K.speculative_plain(sanitize_records(z), packed.attr_idx, packed.attr_select, packed.threshold,
                               packed.child, packed.class_val, total_jumps=_jumps(depth), jump_mode="onehot")
    assert got.shape == (2, frames) and torch.equal(got.reshape(-1), want)
    assert int(got.min()) >= 0 and int(got.max()) < classes


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba", "xlstm", "whisper"])
def test_new_families_on_card_equal_cpu(cuda_device, arch):
    """The same f32 smoke weights on the CPU and on the card: forward,
    prefill and one decode step within 1e-4 (cuBLAS and the CPU sum in
    other orders: a few ulps of logits of magnitude ~4), no kernel of ours
    launched (these families route nothing)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32))}
    if cfg.family == "audio":
        batch["embeds"] = torch.from_numpy((rng.normal(size=(2, cfg.encoder.n_frames, cfg.d_model)) * 0.02)
                                           .astype(np.float32))
    outs = {}
    K.reset_launches()
    for name, model in (("cpu", cpu), ("cuda", card)):
        b = {k: v.to(model.device) for k, v in batch.items()}
        with torch.no_grad():
            full, _ = model(b)
        lp, cache = model.prefill({k: (v[:, :16] if k == "tokens" else v) for k, v in b.items()}, max_len=24)
        ld, _ = model.decode_step(cache, {"tokens": b["tokens"][:, 16:17]})
        outs[name] = [t.cpu() for t in (full, lp, ld)]
    assert sum(K.LAUNCHES.values()) == 0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the LM training path on the card
# ---------------------------------------------------------------------------


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / (|want| + max |want|), the CPU parity tests' measure."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((got - want).abs() / (want.abs() + want.abs().max() + 1e-30)).max())


def _smoke_train(device, start=None, steps: int = 1, arch: str = "granite-moe", remat: str = "full"):
    from repro_torch.configs import ParallelConfig, ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import device_batch, make_train_step

    cfg = get_smoke_config(arch)
    model = build_model(cfg, device=device, parallel=ParallelConfig(remat=remat))
    if start is None:
        model.init(torch.Generator(device=device).manual_seed(0))
    else:
        model.load_state_dict(start)
    start = {k: v.detach().clone().cpu() for k, v in model.state_dict().items()}
    opt = adamw_init(model)
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    pipe = pipeline_for(cfg, ShapeConfig("train", 32, 2, "train"), seed=0)
    metrics = None
    for i in range(steps):
        model, opt, metrics = step(model, opt, device_batch(pipe(i), device))
    return model, opt, metrics, start


@pytest.mark.gpu
def test_smoke_train_step_on_card_equals_cpu(cuda_device):
    """One f32 train step of the granite smoke model on the card and on the
    CPU from the same weights: metrics, parameters and moments within 1e-5
    relative to each tensor's scale (cuBLAS and the CPU sum in other orders)."""
    cm, co, cmet, start = _smoke_train("cpu")
    gm, go, gmet, _ = _smoke_train(cuda_device, start)
    assert all(v.device.type == "cuda" and v.dim() == 0 for v in gmet.values())
    for k in cmet:
        assert _rel(gmet[k], cmet[k]) <= 1e-5, k
    named = dict(cm.named_parameters())
    for n, p in gm.named_parameters():
        assert p.device.type == "cuda" and go.m[n].device.type == "cuda"
        assert _rel(p, named[n]) <= 1e-5, n
        assert _rel(go.m[n], co.m[n]) <= 1e-5 and _rel(go.v[n], co.v[n]) <= 1e-5, n
    assert go.count.device.type == "cuda" and int(go.count) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba", "xlstm", "whisper"])
def test_family_smoke_train_step_on_card_equals_cpu(arch, cuda_device):
    """The hybrid, xLSTM and encoder-decoder smoke models: one f32 step of
    ``make_train_step`` on the card against the CPU from the same weights and
    batch, compared by ``chip_smoke.py``'s ``train_step_card_vs_cpu`` (phase
    2g runs the same comparison): the step's metrics and the gradients it
    hands AdamW, then AdamW applied on both sides to the card's gradients
    (parameters and moments), each within 1e-5 relative to each tensor's
    scale.  The whole step's parameters are not held to 1e-5: AdamW's first
    update, g / (|g| + eps), magnifies the last bits in which the two sides'
    gradients differ wherever |g| is near eps (ROADMAP §3)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    errs, _ = smoke.train_step_card_vs_cpu(cuda_device, arch)
    assert {"loss", "nll", "aux", "grad_norm", "lr", "grads", "params", "m", "v"} <= set(errs)
    for part, (err, where) in errs.items():
        assert err <= 1e-5, f"{part}{where}: {err}"


@pytest.mark.gpu
def test_offload_smoke_train_step_on_card_equals_full(cuda_device):
    """remat "offload" on the card (each block's saved input through pinned
    host memory) against "full" from the same weights and batch: metrics,
    parameters and moments after one step within 1e-6 by :func:`_rel`,
    since the card's scatter-adds may sum in another order from run to run
    (on the CPU the two are bit-equal, ``tests/test_torch_train.py``)."""
    fm, fo, fmet, start = _smoke_train(cuda_device)
    om, oo, omet, _ = _smoke_train(cuda_device, start, remat="offload")
    assert om.parallel.remat == "offload"
    for k in fmet:
        assert _rel(omet[k], fmet[k]) <= 1e-6, k
    named = dict(fm.named_parameters())
    for n, p in om.named_parameters():
        assert p.device.type == "cuda" and _rel(p, named[n]) <= 1e-6, n
        assert _rel(oo.m[n], fo.m[n]) <= 1e-6 and _rel(oo.v[n], fo.v[n]) <= 1e-6, n


@pytest.mark.gpu
def test_trained_router_on_card_routes_like_a_fresh_pack(cuda_device):
    from repro_torch.models.layers import moe as moel

    model, _, _, _ = _smoke_train(cuda_device, steps=2)
    assert all(r.stale for r in model.tree_routers())
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(4, 33)).astype(np.int32)).to(cuda_device)
    with torch.no_grad(), pytest.raises(RuntimeError, match="pack_routers"):
        model({"tokens": toks}, serve_hard_tree=True)
    model.pack_routers()
    routes = []
    hooks = [r.register_forward_hook(lambda m, a, out: routes.append((a, out))) for r in model.tree_routers()]
    K.reset_launches()
    with torch.no_grad():
        model({"tokens": toks}, serve_hard_tree=True)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert K.LAUNCHES["speculative/onehot"] == model.cfg.n_layers
    for layer, (args, out) in zip(model.layers, routes):
        fresh = moel.pack_router(model.cfg, layer.moe.router_thr.detach().clone())
        want = moel.hard_tree_route({"router_proj": args[1]}, args[0], cfg=model.cfg,
                                    e_pad=moel.padded_experts(model.cfg.moe), packed=fresh)
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_checkpoint_restore_onto_card_round_trips(cuda_device, tmp_path):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.optim.adamw import adamw_init

    model, opt, _, _ = _smoke_train(cuda_device)
    ckpt.save(str(tmp_path), 1, {"params": model, "opt": opt})
    other, _, _, _ = _smoke_train(cuda_device, steps=0)
    other_opt = adamw_init(other)
    ckpt.restore(str(tmp_path), 1, {"params": other, "opt": other_opt})
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b), n
    for n in opt.m:
        assert torch.equal(opt.m[n], other_opt.m[n]) and torch.equal(opt.v[n], other_opt.v[n])
    assert other_opt.count.device.type == "cuda" and int(other_opt.count) == 1
    assert not any(r.stale for r in other.tree_routers())
