"""The port's kernel wrappers (``kernels/tree_eval``) against the JAX package.

On the CPU the wrappers run their kernels' plain versions; they are held
against the JAX package's Pallas kernels run in interpret mode, as the JAX
tests run them, at M ∈ {1, 7, 100}, with a 511-node tree, explicit
``block_m`` and bf16 records.  The CUDA kernels themselves are held against
their plain versions on the card by ``test_torch_device.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import breadth_first_encode, random_tree
from repro.core.forest import EncodedForest as JaxForest
from repro.kernels.tree_eval import ops as jax_ops
from repro.kernels.tree_eval.ref import forest_eval_ref as jax_forest_ref
from repro.kernels.tree_eval.ref import tree_eval_ref as jax_tree_ref
from repro_torch.core import EncodedForest, EncodedTree, sanitize_records
from repro_torch.kernels import _build
from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.kernels.tree_eval import ops

from torch_parity import (
    FOREST,
    PORT_FOREST,
    PORT_TREES,
    RECORDS,
    TREES,
    adversarial_records,
    assert_same,
    cpu,
)

MODES = [("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather")]


def _tree(depth: int, seed: int, balance: float = 1.0, attrs: int = 19):
    return breadth_first_encode(
        random_tree(n_attrs=attrs, n_classes=7, max_depth=depth, seed=seed, balance=balance)
    )


def _forest(depths, attrs: int = 19) -> JaxForest:
    return JaxForest([_tree(d, seed=d, balance=0.7, attrs=attrs) for d in depths])


def _port_forest(jf: JaxForest) -> EncodedForest:
    return EncodedForest.from_arrays(jf.attr_idx, jf.threshold, jf.child, jf.class_val)


DEPTH6 = _tree(6, seed=2, balance=0.8)
TREE511 = _tree(8, seed=5)                  # perfect: 511 nodes
FOREST19 = _forest([1, 4, 6])


# ---------------------------------------------------------------------------
# ops against the JAX package's ops (Pallas in interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("m", [1, 7, 100])
def test_tree_eval_matches_jax(algorithm, jump_mode, m):
    rec = adversarial_records(m, 19, seed=m)
    want = jax_ops.tree_eval(rec, DEPTH6, algorithm=algorithm, jump_mode=jump_mode)
    got = ops.tree_eval(rec, EncodedTree.from_arrays(*DEPTH6), algorithm=algorithm,
                        jump_mode=jump_mode, device="cpu")
    assert got.dtype == torch.int32
    assert_same(got, want, f"{algorithm}/{jump_mode}/M={m}")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_tree_eval_511_nodes_explicit_block_m_matches_jax(algorithm, jump_mode):
    assert TREE511.n_nodes == 511
    rec = adversarial_records(40, 19, seed=11)
    want = jax_ops.tree_eval(rec, TREE511, algorithm=algorithm, jump_mode=jump_mode, block_m=8)
    packed = ops.PackedTree(EncodedTree.from_arrays(*TREE511), 19, device="cpu")
    got = ops.tree_eval(rec, packed, algorithm=algorithm, jump_mode=jump_mode, block_m=8, device="cpu")
    assert_same(got, want, f"511/{algorithm}/{jump_mode}")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_tree_eval_bf16_gives_f32_answer(algorithm, jump_mode):
    base = np.random.default_rng(0).normal(size=(64, 19)).astype(np.float32)
    jax_rec = jnp.asarray(base, dtype=jnp.bfloat16)
    port_rec = torch.from_numpy(base).to(torch.bfloat16)
    want = jax_ops.tree_eval(jax_rec, DEPTH6, algorithm=algorithm, jump_mode=jump_mode)
    got = ops.tree_eval(port_rec, EncodedTree.from_arrays(*DEPTH6), algorithm=algorithm, jump_mode=jump_mode)
    assert_same(got, want, "bf16")
    f32 = np.asarray(jax_rec, np.float32)
    assert_same(got, jax_tree_ref(jnp.asarray(f32), *map(jnp.asarray, DEPTH6), max_depth=6), "bf16 vs f32 ref")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("m", [1, 7, 100])
def test_forest_eval_fused_matches_jax(algorithm, jump_mode, m):
    rec = adversarial_records(m, 19, seed=m + 1)
    want = jax_ops.forest_eval_fused(rec, FOREST19, algorithm=algorithm, jump_mode=jump_mode)
    got = ops.forest_eval_fused(rec, _port_forest(FOREST19), algorithm=algorithm,
                                jump_mode=jump_mode, device="cpu")
    assert got.dtype == torch.int32
    assert_same(got, want, f"{algorithm}/{jump_mode}/M={m}")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_forest_eval_fused_fixtures_match_jax(algorithm, jump_mode):
    """The conformance forest (single leaf, phantom padding) with explicit block_m."""
    want = jax_ops.forest_eval_fused(RECORDS, FOREST, algorithm=algorithm, jump_mode=jump_mode, block_m=16)
    packed = ops.PackedForest(PORT_FOREST, RECORDS.shape[1], device="cpu")
    got = ops.forest_eval_fused(cpu(RECORDS), packed, algorithm=algorithm, jump_mode=jump_mode, block_m=16)
    assert_same(got, want, f"fixtures/{algorithm}/{jump_mode}")


def test_forest_eval_stacks_tree_eval():
    packed = [ops.PackedTree(enc, RECORDS.shape[1], device="cpu") for enc in PORT_TREES.values()]
    got = ops.forest_eval(cpu(RECORDS), packed, algorithm="speculative")
    for row, enc in zip(got, TREES.values()):
        assert_same(row, jax_ops.tree_eval(RECORDS, enc, algorithm="speculative"), "forest_eval")


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(ops.VARIANTS))
def test_tree_variants_conform(variant):
    spec = ops.get_variant(variant)
    for name, enc in TREES.items():
        depth = max(int(jax_ops.tree_depth(enc)), 1)
        want = jax_tree_ref(jnp.asarray(RECORDS), *map(jnp.asarray, enc), max_depth=depth)
        assert_same(spec.fn(cpu(RECORDS), PORT_TREES[name], max_depth=depth), want, f"{variant}/{name}")


@pytest.mark.parametrize("variant", sorted(ops.FOREST_VARIANTS))
def test_forest_variants_conform(variant):
    spec = ops.get_forest_variant(variant)
    depth = max(int(FOREST.max_depth), 1)
    want = jax_forest_ref(jnp.asarray(RECORDS), *map(jnp.asarray, (
        FOREST.attr_idx, FOREST.threshold, FOREST.child, FOREST.class_val)), max_depth=depth)
    assert_same(spec.fn(cpu(RECORDS), PORT_FOREST, max_depth=depth), want, variant)


def test_registries_mirror_jax_families():
    assert {s.engine for s in ops.list_variants()} == {"cuda", "torch"}
    assert [s.name for s in ops.list_variants(engine="cuda")] == [
        "cuda_data_parallel", "cuda_speculative_gather", "cuda_speculative_onehot"]
    assert len(ops.list_variants(algorithm="speculative")) == 4
    assert {s.family for s in ops.list_forest_variants()} == {"fused", "batched"}
    assert len(ops.list_forest_variants(engine="cuda", family="fused")) == 5
    assert sorted(s.name for s in ops.list_forest_variants() if s.layout == "quant") == [
        "forest_fused_data_parallel_q", "forest_fused_speculative_q"]
    with pytest.raises(KeyError, match="unknown variant"):
        ops.get_variant("pallas_speculative_gather")
    with pytest.raises(KeyError, match="unknown forest variant"):
        ops.get_forest_variant("forest_vmap_data_parallel")
    with pytest.raises(ValueError, match="already registered"):
        ops.register_variant(ops.get_variant("cuda_data_parallel"))
    with pytest.raises(ValueError, match="already registered"):
        ops.register_forest_variant(ops.get_forest_variant("forest_fused_data_parallel"))


# ---------------------------------------------------------------------------
# tile sizing, checks, build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
@pytest.mark.parametrize("n_nodes", [1, 31, 75, 511, 1023, 2047])
def test_choose_block_m_fits_shared_memory(algorithm, jump_mode, n_nodes):
    """For the class kernels (C = 0) and the vote kernels' tile (C = 7, 128)."""
    for c in (0, 7, 128):
        bm = ops.choose_block_m(n_nodes, 19, algorithm=algorithm, jump_mode=jump_mode, n_classes=c)
        assert bm >= 1 and bm & (bm - 1) == 0
        need = K.smem_bytes(algorithm, bm, 19, n_nodes, jump_mode, c)
        assert need <= K.SMEM_MAX
        budget = ops.SMEM_TARGET if need <= ops.SMEM_TARGET else K.SMEM_MAX
        cap = ops.DATA_PARALLEL_BM_MAX if algorithm == "data_parallel" else ops.SPECULATIVE_BM_MAX
        if bm < cap:   # the next larger tile must not fit the budget that was used
            assert K.smem_bytes(algorithm, 2 * bm, 19, n_nodes, jump_mode, c) > budget
        # a whole forest's tables go in chunks that keep the tile in the same budget
        assert K.smem_bytes(algorithm, bm, 19, n_nodes, jump_mode, c, n_trees=16) <= budget


def test_choose_block_m_raises_when_no_tile_fits():
    with pytest.raises(ValueError, match="no speculative/onehot record tile fits"):
        ops.choose_block_m(20_000, 19, algorithm="speculative", jump_mode="onehot")
    with pytest.raises(ValueError, match="no data_parallel"):
        ops.choose_block_m(100_000, 19, algorithm="data_parallel")


@pytest.mark.parametrize("algorithm,jump_mode", MODES)
def test_launch_shared_memory_is_the_checked_footprint(algorithm, jump_mode):
    """The byte count handed to a launch is ``smem_bytes`` of a tile that fits."""
    bm = ops.choose_block_m(511, 19, algorithm=algorithm, jump_mode=jump_mode)
    assert K._tile_smem(algorithm, bm, 19, 511, jump_mode) == K.smem_bytes(algorithm, bm, 19, 511, jump_mode)
    # the vote kernels' (block_m, C) int32 tile is the one term C adds
    for c in (1, 7, 128):
        bm = ops.choose_block_m(511, 19, algorithm=algorithm, jump_mode=jump_mode, n_classes=c)
        need = K._tile_smem(algorithm, bm, 19, 511, jump_mode, c)
        assert need == K.smem_bytes(algorithm, bm, 19, 511, jump_mode, c)
        assert need == K.smem_bytes(algorithm, bm, 19, 511, jump_mode) + 4 * bm * c
    with pytest.raises(ValueError, match="C=60000"):
        K._tile_smem(algorithm, 1, 19, 511, jump_mode, 60_000)
    with pytest.raises(ValueError, match="negative"):
        K._tile_smem(algorithm, 1, 19, 511, jump_mode, -1)
    too_many = 1
    while K.smem_bytes(algorithm, 1, 19, too_many, jump_mode) <= K.SMEM_MAX:
        too_many *= 2
    with pytest.raises(ValueError, match="B of shared memory"):
        K._tile_smem(algorithm, 1, 19, too_many, jump_mode)
    with pytest.raises(ValueError, match="not a valid"):
        K._tile_smem(algorithm, 0, 19, 511, jump_mode)
    with pytest.raises(ValueError, match="unknown jump_mode"):
        K._tile_smem(algorithm, bm, 19, 511, "scan")
    # a forest: either tile holds the tables of ``table_chunk`` trees (the
    # data-parallel one an 8-byte node and a class, 3 words, a node)
    for n in (51, 511):
        bm = ops.choose_block_m(n, 19, algorithm=algorithm, jump_mode=jump_mode)
        for t in (1, 9, 16):
            need = K._tile_smem(algorithm, bm, 19, n, jump_mode, 0, t)
            assert need == K.smem_bytes(algorithm, bm, 19, n, jump_mode, 0, t)
            if algorithm == "data_parallel":
                words = 3 * n
            else:
                words = n * (3 + (19 if jump_mode == "onehot" else 1))
            chunk = K.table_chunk(bm, 19, n, jump_mode, 0, t, algorithm)
            assert need == K.smem_bytes(algorithm, bm, 19, n, jump_mode) + 4 * (chunk - 1) * words


@pytest.mark.parametrize("n_nodes,n_attrs,jump_mode,slots", [
    (1, 19, "gather", 1), (31, 19, "gather", 1), (32, 19, "gather", 1), (33, 19, "gather", 2),
    (51, 19, "gather", 2), (63, 19, "gather", 2), (64, 19, "gather", 2), (65, 19, "gather", 0),
    (75, 19, "gather", 0), (1023, 19, "gather", 0), (51, 19, "onehot", 2), (32, 40, "onehot", 1),
    (32, 41, "onehot", 0), (64, 20, "onehot", 2), (64, 21, "onehot", 0), (65, 1, "onehot", 0),
])
def test_jump_slots_cut_offs(n_nodes, n_attrs, jump_mode, slots):
    """A lane holds node n in slot n // 32: registers up to 2 slots (and, one-hot,
    A·slots ≤ 40 attr_select floats), else the warp's paths in shared memory,
    which alone add two double-buffered N-int paths per warp to the tile."""
    assert K.jump_slots(n_nodes, n_attrs, jump_mode) == slots
    a4 = -(-n_attrs // 4) * 4
    tree = n_nodes * (3 + (n_attrs if jump_mode == "onehot" else 1))
    for bm in (1, 3, 8, 64):
        paths = 0 if slots else 4 * n_nodes * min(bm, K.SPEC_WARPS)
        assert K.smem_bytes("speculative", bm, n_attrs, n_nodes, jump_mode) == 4 * (bm * a4 + paths + tree)


def test_table_chunk_stages_the_forest_once_or_in_equal_chunks():
    """The paper's 16-tree forest (N 51, A 19): the gather form stages all its
    tables once per CTA; the one-hot form's attr_select makes a tree 51·22
    words, so they go in the fewest equal chunks that fit ``SMEM_TARGET``."""
    bm = ops.choose_block_m(51, 19)
    assert bm == ops.SPECULATIVE_BM_MAX == 128
    assert K.table_chunk(bm, 19, 51, "gather", 0, 16) == 16
    assert K.smem_bytes("speculative", bm, 19, 51, "gather", 0, 16) == 4 * (128 * 20 + 16 * 51 * 4)
    assert K.table_chunk(bm, 19, 51, "onehot", 0, 16) == 8
    assert K.table_chunk(bm, 19, 51, "onehot", 7, 9) == 5     # chunks of 5 and 4, not 8 and 1
    for mode in ("gather", "onehot"):
        for c in (0, 7):
            fixed, tree = K._tile_words("speculative", bm, 19, 51, mode, c)
            for t in (1, 2, 9, 16, 100):
                chunk = K.table_chunk(bm, 19, 51, mode, c, t)
                n_chunks = -(-t // chunk)
                assert 1 <= chunk <= t and chunk == -(-t // n_chunks)            # equal chunks
                assert K.smem_bytes("speculative", bm, 19, 51, mode, c, t) == 4 * (fixed + chunk * tree)
                assert 4 * (fixed + chunk * tree) <= ops.SMEM_TARGET
                if n_chunks > 1:   # one chunk fewer would not fit
                    assert 4 * (fixed + -(-t // (n_chunks - 1)) * tree) > ops.SMEM_TARGET
    # a tree too big for SMEM_TARGET is staged alone, in what a CTA may opt into
    assert K.table_chunk(1, 19, 2047, "onehot", 0, 16) == 1
    assert ops.SMEM_TARGET < K.smem_bytes("speculative", 1, 19, 2047, "onehot", 0, 16) <= K.SMEM_MAX


def test_data_parallel_tile_stages_the_forest_once_or_in_equal_chunks():
    """The paper's 16-tree forest (N 51, A 19) is staged whole in the
    data-parallel tile: 256 rows of 19 floats (an odd stride) and 51·16
    nodes of 12 bytes.  N 1,023 goes in the fewest equal chunks that keep
    the tile in ``SMEM_TARGET``, for the class and the vote kernels."""
    bm = ops.choose_block_m(51, 19, algorithm="data_parallel")
    assert bm == ops.DATA_PARALLEL_BM_MAX == 256 and K.dp_threads(bm) == 128
    assert K.table_chunk(bm, 19, 51, "gather", 0, 16, "data_parallel") == 16
    assert K.smem_bytes("data_parallel", bm, 19, 51, "gather", 0, 16) == 4 * (256 * 19 + 16 * 51 * 3)
    for c in (0, 7, 128):
        bm = ops.choose_block_m(1023, 19, algorithm="data_parallel", n_classes=c)
        fixed, tree = K._tile_words("data_parallel", bm, 19, 1023, "gather", c)
        assert fixed == -(-bm * 19 // 4) * 4 + bm * c and tree == 3 * 1023
        for t in (1, 5, 9, 16, 100):
            chunk = K.table_chunk(bm, 19, 1023, "gather", c, t, "data_parallel")
            n_chunks = -(-t // chunk)
            assert 1 <= chunk <= t and chunk == -(-t // n_chunks)              # equal chunks
            need = K.smem_bytes("data_parallel", bm, 19, 1023, "gather", c, t)
            assert need == 4 * (fixed + chunk * tree) <= ops.SMEM_TARGET
            if n_chunks > 1:   # one chunk fewer would not fit
                assert 4 * (fixed + -(-t // (n_chunks - 1)) * tree) > ops.SMEM_TARGET
        assert K.table_chunk(bm, 19, 1023, "gather", c, 16, "data_parallel") < 16    # several chunks
    # an even A gets a padded, odd row stride
    assert K._tile_words("data_parallel", 3, 20, 7, "gather", 0) == (64, 21)


@pytest.mark.parametrize("block_m,threads", [(1, 1), (2, 1), (3, 2), (32, 16), (256, 128), (1024, 512)])
def test_data_parallel_threads_own_two_rows(block_m, threads):
    """A data-parallel CTA has one thread per two rows of its tile; a tile
    above ``DP_TILE_MAX`` rows (512 threads) is refused."""
    assert K.dp_threads(block_m) == threads
    assert K._tile_smem("data_parallel", block_m, 19, 51, "gather") == K.smem_bytes("data_parallel", block_m, 19, 51)
    with pytest.raises(ValueError, match=f"block_m={K.DP_TILE_MAX + 1} is not a valid"):
        K._tile_smem("data_parallel", K.DP_TILE_MAX + 1, 19, 51, "gather")


def test_packing_rejects_out_of_range_indices():
    enc = PORT_TREES["deep"]
    with pytest.raises(ValueError, match="attr_idx outside"):
        ops.PackedTree(enc, 3, device="cpu")
    bad = enc._replace(child=enc.child.copy())
    bad.child[0] = enc.n_nodes - 1          # internal node: right child off the end
    with pytest.raises(ValueError, match="child index outside"):
        ops.PackedTree(bad, 7, device="cpu")
    with pytest.raises(ValueError, match="child index outside"):
        ops.PackedForest(type("F", (), dict(vars(PORT_FOREST), child=PORT_FOREST.child - 1))(), 7, device="cpu")


def test_wrappers_reject_bad_arguments():
    enc = PORT_TREES["deep"]
    with pytest.raises(ValueError, match="unknown algorithm"):
        ops.tree_eval(cpu(RECORDS), enc, algorithm="serial")
    with pytest.raises(ValueError, match="unknown jump_mode"):
        ops.forest_eval_fused(cpu(RECORDS), PORT_FOREST, jump_mode="scan")
    with pytest.raises(ValueError, match="records must be"):
        ops.tree_eval(cpu(RECORDS[:, :5]), ops.PackedTree(enc, 7, device="cpu"))


def test_kernel_wrapper_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device is checked
    for a kernel launch and refused here (a meta tensor stands in for one)."""
    enc = PORT_TREES["deep"]
    packed = ops.PackedTree(enc, 7, device="cpu")
    rec = torch.empty((5, 7), device="meta")
    args = (packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    with pytest.raises(ValueError, match="kernels take CPU or CUDA tensors"):
        K.data_parallel(rec, *args, max_depth=3, block_m=32)
    with pytest.raises(ValueError, match="kernels take CPU or CUDA tensors"):
        K.speculative(rec, packed.attr_idx, packed.attr_select, *args[1:], total_jumps=3,
                      jump_mode="gather", block_m=8)
    forest = ops.PackedForest(PORT_FOREST, 7, device="cpu")
    tabs = (forest.attr_idx, forest.threshold, forest.child, forest.class_val)
    with pytest.raises(ValueError, match="kernels take CPU or CUDA tensors"):
        K.fused_votes_data_parallel(rec, *tabs, n_classes=5, max_depth=3, block_m=32)
    for mode in ("gather", "onehot"):
        with pytest.raises(ValueError, match="kernels take CPU or CUDA tensors"):
            K.fused_votes_speculative(rec, forest.attr_idx, forest.attr_select, *tabs[1:], n_classes=5,
                                      total_jumps=3, jump_mode=mode, block_m=8)
    with pytest.raises(ValueError, match="tables are on cpu"):
        ops.forest_votes_fused(rec, forest, n_classes=5)


def test_cpu_wrappers_equal_plain_versions():
    packed = ops.PackedForest(PORT_FOREST, 7, device="cpu")
    rec = sanitize_records(cpu(RECORDS))
    tabs = (packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
    for mode in ("gather", "onehot"):
        full = K.fused_speculative(rec, *tabs, total_jumps=3, jump_mode=mode, block_m=4)
        assert_same(full, K.fused_speculative_plain(rec, *tabs, total_jumps=3, jump_mode=mode), mode)
        for t in range(packed.n_trees):
            one = K.speculative(rec, *(x[t] for x in tabs), total_jumps=3, jump_mode=mode, block_m=4)
            assert_same(one, full[t], f"{mode} tree {t}")
    dp_tabs = (packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    full = K.fused_data_parallel(rec, *dp_tabs, max_depth=packed.max_depth, block_m=32)
    for t in range(packed.n_trees):
        one = K.data_parallel(rec, *(x[t] for x in dp_tabs), max_depth=packed.max_depth, block_m=32)
        assert_same(one, full[t], f"data_parallel tree {t}")
    assert all(v == 0 for v in K.LAUNCHES.values())   # CPU tensors launch nothing


@pytest.mark.parametrize("n_classes", [0, 1, 3, 5, 9])
def test_cpu_vote_wrappers_equal_plain_versions(n_classes):
    """K5/K6 on CPU tensors: their plain versions, the one-hot sum of K3/K4's
    classes in which a class outside [0, C) casts no vote."""
    packed = ops.PackedForest(PORT_FOREST, 7, device="cpu")
    rec = sanitize_records(cpu(RECORDS))
    tabs = (packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
    dp_tabs = (packed.attr_idx, packed.threshold, packed.child, packed.class_val)
    classes = torch.arange(max(n_classes, 1))
    for mode in ("gather", "onehot"):
        got = K.fused_votes_speculative(rec, *tabs, n_classes=n_classes, total_jumps=3, jump_mode=mode, block_m=4)
        want = K.fused_votes_speculative_plain(rec, *tabs, n_classes=n_classes, total_jumps=3, jump_mode=mode)
        assert got.shape == (rec.shape[0], n_classes) and got.dtype == torch.int32
        assert_same(got, want, mode)
        per_tree = K.fused_speculative(rec, *tabs, total_jumps=3, jump_mode=mode, block_m=4)
        cast = ((per_tree[..., None] == classes) & (classes < n_classes)).sum(0)[:, :n_classes]
        assert_same(got, cast, f"{mode} one-hot sum")
    got = K.fused_votes_data_parallel(rec, *dp_tabs, n_classes=n_classes, max_depth=packed.max_depth, block_m=32)
    assert_same(got, K.fused_votes_data_parallel_plain(rec, *dp_tabs, n_classes=n_classes,
                                                       max_depth=packed.max_depth), "data_parallel")
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "missing-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(K.SOURCE)
    assert not (tmp_path / "build").exists()


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*refused"):
        _build.build(K.SOURCE)
    assert list((tmp_path / "build").iterdir()) == []
