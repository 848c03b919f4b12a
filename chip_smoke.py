"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and power limit; no CUDA device is an error;
2. build — compile ``csrc/tree_eval.cu`` for sm_90a with nvcc, print the
   ``-Xptxas -v`` report;
3. kernels against plain versions — K1 (gather, onehot), K2, K3 (gather,
   onehot) and K4 on adversarial records (ties, ±inf, NaN) and trees of depth
   0–9 (one with N > 128), M ∈ {1, 7, 65,536}; K5 (gather, onehot) and K6 on
   the same records and forest at C = 7 and at C = 3 (so that classes outside
   [0, C) occur); K7 and K8 on the same records, on the quantized layouts of
   that forest (N 1,023, so ``child`` is int16 at least) and of its trees with
   N ≤ 128 (int8 ``child``), in each threshold storage (bf16, f16, f32) and
   every index width the tables fit in; all compared with ``torch.equal``;
3s. subnormals — K1–K8 (every instantiation) on 4,096 records of subnormals
   and signed zeros, the fixture trees' thresholds drawn from them: equal to
   their plain versions and to ``eval_serial`` (no flush to zero);
4. tree service — the paper's configuration: CART on the segmentation twin,
   five 256×256 images (65,536 records each) classified by ``ops.tree_eval``
   in all three modes, each equal to ``eval_serial``;
5. forest service — a 16-tree bagged CART forest, the same images through
   ``ops.forest_eval_fused`` (all three modes) and ``majority_vote``, per-tree
   classes equal to stacked ``eval_serial``;
5q. quantized forest service — the same forest in six quantized layouts
   ((a) universal bf16 and f16, which store f32; (b) calibrated on the 4,409
   train+test rows the images are tiled from, bf16 and f16, stored f32; (c)
   its thresholds snapped to bf16, and to f16, then universal, which store
   bf16 and f16), the same images through ``ops.forest_eval_fused_q`` (K7,
   K8) and ``majority_vote``: per-tree classes equal to stacked
   ``eval_serial`` of the forest each layout encodes (for (a) and (b) also of
   the forest itself), votes equal to the host vote; each layout's bytes
   beside ``PackedForest.nbytes``; per-image latency beside
   ``forest_eval_fused``, timed in turns;
6. cascade — the same forest planned by ``plan_cascade`` (trees ranked by K4
   on 512 records), then ``CascadeEvaluator`` (engine "cuda": K5/K6 stages,
   on-device compaction) in all three modes, 2 and 3 stages, bounds None, 1.0
   and 0.5, on the five images and a skewed 90/10 mix of image 0 with noise;
   every result field equal to the host oracle ``cascade_ref_from_classes``
   over the stacked ``eval_serial`` classes, classes equal to the majority
   vote for the exact bounds, ``deadline_ms=0`` stopping after stage 0;
   per-image latency beside ``forest_eval_fused`` + ``majority_vote``, timed
   in turns, survivors per stage and mean trees evaluated;
6s. serve — the served path at the same sizes, through the entry points a
   user calls: ``TreeServeEngine`` (65,536-record waves, background re-tune
   after 2 waves of a bucket with warmup 1 and 3 timed calls, synchronous
   shadow profiling of every wave's first 4,096 records, a flight recorder)
   on the five images as one stream cut into requests of seeded sizes
   1–16,384, served twice (before and after the promotion), every request's
   classes equal to ``eval_serial``; per bucket the heuristic's pick, every
   measured candidate's median (CUDA events) and launches, the winner,
   per-wave ms, the profiler's d_µ against the host's on the same records;
   a flight bundle read back; then the forest through ``eval_forest_tuned``
   (autotune, layouts f32 and quant) and ``ForestTunedEvaluator.predict``
   (autotune: majority vote against the cascades) against the host oracles,
   with every candidate's median and the winners.  No failed candidate, no
   retuner or profiler failure.  The repaired tuner: the M 65,536 bucket
   swept on a worker thread and stream with no wave in flight and while
   another thread serves waves without pause, every candidate's score
   (spin-hidden device time + launches × the ctypes launch cost) and raw
   samples printed, the winners' algorithms equal.  (Phase 7 times the tree
   kernel at each tile of the tuner's grid, outside the counted window);
6f. forest-serve — the forest served through ``repro_torch.dist``:
   ``ForestServeEngine`` (65,536-record waves in chunks of 8,192 through the
   pinned, double-buffered ``StreamingChunker``, background re-tune after 2
   waves of a bucket at the chunk shape with layouts f32 and quant,
   synchronous shadow profiling, a flight recorder) on the same 45 requests
   twice, every request equal to the host vote of stacked ``eval_serial``;
   every re-tune candidate's score and samples; per-chunk and per-wave ms
   and the overlap ratio; one wave under the profiler (device time by kind
   and stream, idle share, how long the pinned copy-in overlapped a
   kernel, the host spans); the anytime cascade (``AnytimePolicy``, K5
   gather/onehot and K6) under a deadline no wave reaches (classes equal
   the host vote) and at ``slo_ms=0`` (every wave truncated, records that
   exited equal the host vote); ``ShardedForestEvaluator`` over four
   logical shards of one card, records 4×1 (a K3 winner stored at the
   shard shape), trees 1×4 (K4 by the heuristic), hybrid 2×2 (stored K8 and
   K7 winners), each equal to ``eval_forest_tuned`` on image 0 and at M 7,
   3, 2, each shard one launch; ``StreamingChunker`` alone equal to the
   monolithic call, its steady-state eval free of synchronizing operations
   under ``torch.cuda.set_sync_debug_mode``; ``eval_windowed`` on a
   16,383-node perfect tree at A 19 (which ``ops.tree_eval`` refuses with
   ``TileError``) over 65,536 records equal to ``eval_serial``, its time and
   peak memory;
7. timing — where one image's service time goes (host wall, device busy by
   kernel) on the tree, forest and cascade paths; then each kernel on the
   main path's own tree, forest, cascade stage and image, checked equal to
   its plain version there and timed (device time from the profiler, record
   buffers rotated past the 50 MB L2), its plain version (CUDA events), and
   its bound; K7 and K8 in each threshold storage on the layouts of phase 5q
   that store it, beside K3 gather and K4; K5 and K6 also at the whole forest
   and at the cascade's second stage (the records of image 0 that its first
   stage leaves); each row names its CTA, table chunk and grid, and each
   speculative row the jump path it took (registers or shared memory); then
   K3 at N on both sides of the path cut-offs (32, 64) on random forests;
8. the ``kernels`` JSON line, the card line, and the ``ok`` line.

    python3 chip_smoke.py --parent DIR [DIR ...]

also times the kernels of each checkout DIR (an unpacked earlier commit) in
turns with this tree's, on phase 7's inputs: parent, this, this, parent;
their outputs must be equal.  K1/K3/K5 in both forms, K7 and K8 in each
threshold storage, K2, K4, and K6 at the cascade's first stage, at the whole
forest and at its second stage; each at its own checkout's tile
(``choose_block_m``), the data-parallel rows with both grids.

Kernel launches are counted from zero over phases 4–6 (5q included), where
every kernel must launch, again from zero over phase 6s, where the kernel
of every candidate the tuner measured must launch (each measured kernel
candidate also counts its own launches on its thread), and again from zero
over phase 6f, where K3 gather, K4, K5 in both forms, K6, and K7/K8 must
launch (the phase prints them by part: served waves, re-tune candidates,
anytime stages, shard bodies, the chunker).  The ``kernels`` line's
``launches`` is the sum of the three windows.  Any mismatch, missing launch
or exception exits non-zero.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    BOTTOM,
    CartConfig,
    EncodedForest,
    Node,
    breadth_first_encode,
    eval_serial,
    majority_vote,
    random_tree,
    sanitize_records,
    train_cart,
    tree_depth,
)
from repro_torch import obs  # noqa: E402
from repro_torch.core.analysis import mean_traversal_depth, observed_depths  # noqa: E402
from repro_torch.data import make_segmentation, replicated_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.tree_eval import (  # noqa: E402
    CascadeEvaluator,
    QuantizedForest,
    cascade_ref_from_classes,
    kernel as K,
    ops,
    plan_cascade,
)
from repro_torch.kernels.tree_eval.quant import from_bits, to_bits  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

N_ATTRS, N_CLASSES, M_IMAGE, N_IMAGES, N_TREES = 19, 7, 65_536, 5, 16
MODES = (("speculative", "gather"), ("speculative", "onehot"), ("data_parallel", "gather"))
CASCADE_STAGES = (2, 3)
CASCADE_BOUNDS = (None, 1.0, 0.5)
CASCADE_FIELDS = ("classes", "margin", "exit_stage", "trees_evaluated", "confidence")
THR_STORAGES = ("bfloat16", "float16", "float32")
INDEX_DTYPES = (torch.int8, torch.int16, torch.int32)
L2_BYTES = 50 * 2**20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def adversarial_records(m: int) -> np.ndarray:
    """(m, 19) records with the conformance suite's adversarial rows up front."""
    rng = np.random.default_rng(2026)
    rec = rng.normal(size=(max(m, 8), N_ATTRS)).astype(np.float32)
    rec[0, :] = 0.5                      # ties with the shared 0.5 threshold
    rec[1, :] = 0.0
    rec[2, :] = np.inf
    rec[3, :] = -np.inf
    rec[4, ::2], rec[4, 1::2] = np.inf, -np.inf
    rec[5, :] = np.nan
    rec[6, ::3] = np.nan
    rec[7, :4] = [np.nan, np.inf, -np.inf, 0.5]
    return rec[:m]


def duplicate_threshold_tree() -> Node:
    def split(attr, left, right):
        return Node(attr=attr, threshold=0.5, left=left, right=right)

    def leaf(c):
        return Node(class_val=c)

    return split(0, split(1, split(2, leaf(0), leaf(1)), split(3, leaf(2), leaf(3))),
                 split(2, split(4, leaf(4), leaf(0)), split(1, leaf(1), leaf(2))))


def fixture_trees():
    trees = [Node(class_val=3), duplicate_threshold_tree()]
    for depth in range(1, 10):
        balance = 1.0 if depth >= 8 else 0.6   # perfect at 8 and 9: N = 511, 1023
        trees.append(random_tree(n_attrs=N_ATTRS, n_classes=N_CLASSES, max_depth=depth,
                                 min_depth=min(depth, 2), seed=depth, balance=balance))
    return [breadth_first_encode(t) for t in trees]


def run_speculative(fused: bool, rec, tabs, jump_mode: str, block_m: int | None = None):
    """K1 (or K3 if ``fused``) on ``tabs``; its plain version when ``block_m`` is None."""
    args = (rec, tabs.attr_idx, tabs.attr_select, tabs.threshold, tabs.child, tabs.class_val)
    kw = dict(total_jumps=ops._total_jumps(tabs.max_depth), jump_mode=jump_mode)
    if block_m is None:
        plain = K.fused_speculative_plain if fused else K.speculative_plain
        return plain(*args, **kw)
    kernel = K.fused_speculative if fused else K.speculative
    return kernel(*args, block_m=block_m, **kw)


def run_data_parallel(fused: bool, rec, tabs, block_m: int | None = None):
    """K2 (or K4 if ``fused``) on ``tabs``; its plain version when ``block_m`` is None."""
    args = (rec, tabs.attr_idx, tabs.threshold, tabs.child, tabs.class_val)
    if block_m is None:
        plain = K.fused_data_parallel_plain if fused else K.data_parallel_plain
        return plain(*args, max_depth=tabs.max_depth)
    kernel = K.fused_data_parallel if fused else K.data_parallel
    return kernel(*args, max_depth=tabs.max_depth, block_m=block_m)


def run_votes(algorithm: str, jump_mode: str, rec, tabs, n_classes: int, block_m: int | None = None):
    """K5 (or K6 for data-parallel) on ``tabs``; its plain version when ``block_m`` is None."""
    if algorithm == "speculative":
        args = (rec, tabs.attr_idx, tabs.attr_select, tabs.threshold, tabs.child, tabs.class_val)
        kw = dict(n_classes=n_classes, total_jumps=ops._total_jumps(tabs.max_depth), jump_mode=jump_mode)
        if block_m is None:
            return K.fused_votes_speculative_plain(*args, **kw)
        return K.fused_votes_speculative(*args, block_m=block_m, **kw)
    args = (rec, tabs.attr_idx, tabs.threshold, tabs.child, tabs.class_val)
    kw = dict(n_classes=n_classes, max_depth=tabs.max_depth)
    if block_m is None:
        return K.fused_votes_data_parallel_plain(*args, **kw)
    return K.fused_votes_data_parallel(*args, block_m=block_m, **kw)


def kernel_vs_plain(fused: bool, algorithm: str, jump_mode: str, rec, tabs, block_m: int):
    """Run one kernel and its plain version on the same inputs; returns both."""
    if algorithm == "speculative":
        return (run_speculative(fused, rec, tabs, jump_mode, block_m),
                run_speculative(fused, rec, tabs, jump_mode))
    return run_data_parallel(fused, rec, tabs, block_m), run_data_parallel(fused, rec, tabs)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


KERNEL_IDS = {"speculative": 1, "data_parallel": 2, "fused_speculative": 3, "fused_data_parallel": 4,
              "fused_votes_speculative": 5, "fused_votes_data_parallel": 6, "fused_speculative_q": 7,
              "fused_data_parallel_q": 8}


def kernel_id(name: str) -> tuple[int, int, str]:
    """(kernel number, variant, jump_mode) of the LAUNCHES key ``name``, as
    ``kernel.launch_grid`` takes them."""
    wrapper, _, form = name.partition("/")
    jump_mode = "onehot" if form == "onehot" else "gather"
    variant = K.THR_CODES[getattr(torch, form)][1] if wrapper.endswith("_q") else int(form == "onehot")
    return KERNEL_IDS[wrapper], variant, jump_mode


def launch_shape(name: str, m: int, n: int, a: int, block_m: int, n_classes: int = 0, n_trees: int = 1) -> str:
    """The CTA, table chunk and grid of the launch ``name``; for a speculative
    kernel also its jump path."""
    kernel, variant, jump_mode = kernel_id(name)
    algorithm = "speculative" if kernel % 2 else "data_parallel"
    if algorithm == "speculative":
        slots = K.jump_slots(n, a, jump_mode)
        path = f"registers ({slots} slot{'s' * (slots > 1)} a lane)" if slots else "shared memory"
        cta = f"path {path}, {K.spec_warps(block_m)} warps"
    else:
        cta = f"{K.dp_threads(block_m)} threads"
    chunk = K.table_chunk(block_m, a, n, jump_mode, n_classes, n_trees, algorithm)
    grid, per_sm = K.launch_grid(kernel, variant, m, block_m, a, n, jump_mode, n_classes, n_trees)
    return f"{cta}, tables {chunk} of {n_trees} trees a chunk, grid {grid} CTAs ({per_sm} a SM)"


def phase_kernels(dev) -> dict:
    """K1–K6 against their plain versions; returns the largest error per kernel."""
    errs: dict[str, int] = {}
    trees = fixture_trees()
    forest = ops.PackedForest(EncodedForest(trees), N_ATTRS, device=dev)
    print(f"[kernels] {len(trees)} trees, N = {[t.n_nodes for t in trees]}, "
          f"depths {[tree_depth(t) for t in trees]}; forest N = {forest.n_nodes}")
    for m in (1, 7, M_IMAGE):
        raw = torch.from_numpy(adversarial_records(m)).to(dev)
        clean = sanitize_records(raw)
        for algorithm, jump_mode in MODES:
            # The gather and data-parallel kernels see the raw adversarial
            # records; the one-hot form is defined on sanitized records, which
            # is what ops hands every speculative launch.
            rec = clean if jump_mode == "onehot" else raw
            name = kernel_name(False, algorithm, jump_mode)
            for enc in trees:
                tabs = ops.PackedTree(enc, N_ATTRS, device=dev)
                bm = ops.choose_block_m(tabs.n_nodes, N_ATTRS, algorithm=algorithm, jump_mode=jump_mode)
                got, want = kernel_vs_plain(False, algorithm, jump_mode, rec, tabs, bm)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{name} != plain at M={m}, N={enc.n_nodes}, block_m={bm}")
                errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
            fname = kernel_name(True, algorithm, jump_mode)
            bm = ops.choose_block_m(forest.n_nodes, N_ATTRS, algorithm=algorithm, jump_mode=jump_mode)
            for block_m in sorted({bm, 1 if algorithm == "speculative" else 32}):
                got, want = kernel_vs_plain(True, algorithm, jump_mode, rec, forest, block_m)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"{fname} != plain at M={m}, block_m={block_m}")
                errs[fname] = max(errs.get(fname, 0), max_abs_err(got, want))
            vname = votes_name(algorithm, jump_mode)
            for c in (N_CLASSES, 3):
                want = run_votes(algorithm, jump_mode, rec, forest, c)
                bm = ops.choose_block_m(forest.n_nodes, N_ATTRS, algorithm=algorithm,
                                        jump_mode=jump_mode, n_classes=c)
                for block_m in sorted({bm, 1 if algorithm == "speculative" else 32}):
                    got = run_votes(algorithm, jump_mode, rec, forest, c, block_m)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"{vname} != plain at M={m}, C={c}, block_m={block_m}")
                    errs[vname] = max(errs.get(vname, 0), max_abs_err(got, want))
        print(f"[kernels] M={m}: K1 gather/onehot, K2, K3 gather/onehot, K4, "
              f"K5 gather/onehot and K6 (C = {N_CLASSES}, 3) equal to plain")
    return errs


def snapped(forest: EncodedForest, thr_dtype: str) -> EncodedForest:
    """``forest`` with its split thresholds rounded to ``thr_dtype`` and back,
    so that a universal quantized layout stores them narrow."""
    thr = forest.threshold.copy()
    split = forest.class_val == BOTTOM
    thr[split] = from_bits(to_bits(thr[split], thr_dtype), thr_dtype)
    return EncodedForest.from_arrays(forest.attr_idx, thr, forest.child, forest.class_val)


def stored_as(forest: EncodedForest, storage: str, dev) -> QuantizedForest:
    """A universal layout of ``forest`` whose thresholds are stored as ``storage``:
    snapped to a narrow type, or left as they are (they then fall back to f32)."""
    if storage == "float32":
        q = QuantizedForest(forest, N_ATTRS, device=dev)
    else:
        q = QuantizedForest(snapped(forest, storage), N_ATTRS, thr_dtype=storage, device=dev)
    check(q.thr_stored == storage, f"layout stores {q.thr_stored}, not {storage}")
    return q


def widths(table: torch.Tensor) -> list[torch.Tensor]:
    """``table`` cast to every index dtype that holds its values."""
    return [table.to(dt) for dt in INDEX_DTYPES if int(table.max()) <= torch.iinfo(dt).max]


def quant_name(algorithm: str, storage: str) -> str:
    """LAUNCHES key of K7/K8 for ``algorithm`` and a threshold storage."""
    return f"fused_{algorithm}_q/{storage}"


def run_quant(algorithm: str, rec, q, tables=None, block_m: int | None = None):
    """K7 (speculative) or K8 on ``q``'s tables, or on ``tables`` (attr_idx,
    child, class_val) cast to other widths; the plain version when ``block_m``
    is None."""
    attr, child, cls = tables or (q.attr_idx, q.child, q.class_val)
    args = (rec, attr, q.threshold, child, cls)
    if algorithm == "speculative":
        kw = dict(total_jumps=ops._total_jumps(q.max_depth))
        if block_m is None:
            return K.fused_speculative_q_plain(*args, **kw)
        return K.fused_speculative_q(*args, block_m=block_m, **kw)
    kw = dict(max_depth=q.max_depth)
    if block_m is None:
        return K.fused_data_parallel_q_plain(*args, **kw)
    return K.fused_data_parallel_q(*args, block_m=block_m, **kw)


def phase_quant_kernels(dev) -> dict:
    """K7/K8 against their plain versions in every storage and index width."""
    errs: dict[str, int] = {}
    trees = fixture_trees()
    forests = {"N 1,023": EncodedForest(trees),
               "N <= 128": EncodedForest([t for t in trees if t.n_nodes <= 128])}
    layouts = [(label, stored_as(f, storage, dev)) for label, f in forests.items() for storage in THR_STORAGES]
    for label, q in layouts[::3]:
        print(f"[kernels] quantized fixture forest {label}: N = {q.n_nodes}, tables "
              f"{ {k: v['dtype'] for k, v in q.bytes_report()['tables'].items()} } (narrowest)")
    for m in (1, 7, M_IMAGE):
        raw = torch.from_numpy(adversarial_records(m)).to(dev)
        combos = 0
        for label, q in layouts:
            for algorithm in ops.ALGORITHMS:
                name = quant_name(algorithm, q.thr_stored)
                want = run_quant(algorithm, raw, q)
                bm = ops.choose_block_m(q.n_nodes, N_ATTRS, algorithm=algorithm)
                for attr in widths(q.attr_idx):
                    for child in widths(q.child):
                        for cls in widths(q.class_val):
                            for block_m in sorted({bm, 1 if algorithm == "speculative" else 32}):
                                got = run_quant(algorithm, raw, q, (attr, child, cls), block_m)
                                torch.cuda.synchronize()
                                check(torch.equal(got, want),
                                      f"{name} != plain at M={m}, {label}, tables {attr.dtype}/"
                                      f"{child.dtype}/{cls.dtype}, block_m={block_m}")
                                errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
                                combos += 1
        print(f"[kernels] M={m}: K7 and K8 equal to plain in {combos} launches "
              f"(2 forests x 3 storages x index widths x 2 tiles)")
    return errs


SUBNORMALS = np.array([1e-45, -1e-45, 1e-40, -1e-40, 2.0**-140, -(2.0**-140), 0.0, -0.0], np.float32)


def subnormal_forest() -> EncodedForest:
    """The fixture trees with every split threshold drawn from ``SUBNORMALS``."""
    forest = EncodedForest(fixture_trees())
    rng = np.random.default_rng(45)
    split = forest.class_val == BOTTOM
    forest.threshold[split] = rng.choice(SUBNORMALS, int(split.sum()))
    return forest


def phase_subnormal(dev) -> dict:
    """K1–K8 on subnormal and signed-zero records and thresholds: each equal
    to its plain version and to ``eval_serial`` (IEEE compares: no flush to
    zero; the CUDA build has no ``-ftz``)."""
    errs: dict[str, int] = {}
    forest = subnormal_forest()
    rec_np = np.random.default_rng(46).choice(SUBNORMALS, size=(4096, N_ATTRS)).astype(np.float32)
    rec = torch.from_numpy(rec_np).to(dev)
    serial = np.stack([eval_serial(forest.tree(t), rec_np) for t in range(forest.n_trees)])
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    for algorithm, jump_mode in MODES:
        for t in range(forest.n_trees):
            tabs = ops.PackedTree(forest.tree(t), N_ATTRS, device=dev)
            bm = ops.choose_block_m(tabs.n_nodes, N_ATTRS, algorithm=algorithm, jump_mode=jump_mode)
            got, want = kernel_vs_plain(False, algorithm, jump_mode, rec, tabs, bm)
            name = kernel_name(False, algorithm, jump_mode)
            check(torch.equal(got, want) and np.array_equal(got.cpu().numpy(), serial[t]),
                  f"{name} != plain or eval_serial on subnormal inputs, tree {t}")
            errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
        bm = ops.choose_block_m(packed.n_nodes, N_ATTRS, algorithm=algorithm, jump_mode=jump_mode)
        got, want = kernel_vs_plain(True, algorithm, jump_mode, rec, packed, bm)
        name = kernel_name(True, algorithm, jump_mode)
        check(torch.equal(got, want) and np.array_equal(got.cpu().numpy(), serial),
              f"{name} != plain or eval_serial on subnormal inputs")
        errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
        bm = ops.choose_block_m(packed.n_nodes, N_ATTRS, algorithm=algorithm, jump_mode=jump_mode,
                                n_classes=N_CLASSES)
        got = run_votes(algorithm, jump_mode, rec, packed, N_CLASSES, bm)
        want = run_votes(algorithm, jump_mode, rec, packed, N_CLASSES)
        name = votes_name(algorithm, jump_mode)
        host = (serial[..., None] == np.arange(N_CLASSES)).sum(0)
        check(torch.equal(got, want) and np.array_equal(got.cpu().numpy(), host),
              f"{name} != plain or the host tally on subnormal inputs")
        errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
    for storage in THR_STORAGES:
        q = stored_as(forest, storage, dev)
        tables = EncodedForest.from_arrays(*host_tables(q))
        q_serial = np.stack([eval_serial(tables.tree(t), rec_np) for t in range(q.n_trees)])
        for algorithm in ops.ALGORITHMS:
            bm = ops.choose_block_m(q.n_nodes, N_ATTRS, algorithm=algorithm)
            got, want = run_quant(algorithm, rec, q, block_m=bm), run_quant(algorithm, rec, q)
            name = quant_name(algorithm, q.thr_stored)
            check(torch.equal(got, want) and np.array_equal(got.cpu().numpy(), q_serial),
                  f"{name} != plain or eval_serial on subnormal inputs")
            errs[name] = max(errs.get(name, 0), max_abs_err(got, want))
    print(f"[subnormal] {len(errs)} kernel instantiations (K1–K8) on {rec_np.shape[0]} records of "
          f"subnormals and signed zeros, thresholds drawn from them: equal to plain and to eval_serial")
    return errs


# ---------------------------------------------------------------------------
# phases 4–5: the main path
# ---------------------------------------------------------------------------


def kernel_name(fused: bool, algorithm: str, jump_mode: str) -> str:
    """LAUNCHES key of the wrapper that serves (fused, algorithm, jump_mode)."""
    base = ("fused_" if fused else "") + algorithm
    return f"{base}/{jump_mode}" if algorithm == "speculative" else base


def votes_name(algorithm: str, jump_mode: str) -> str:
    """LAUNCHES key of the vote kernel (K5/K6) that serves (algorithm, jump_mode)."""
    return "fused_votes_" + kernel_name(False, algorithm, jump_mode)


def bagged_forest(data) -> EncodedForest:
    """The 16-tree bagged CART forest of the JAX package's cascade bench."""
    rng = np.random.default_rng(0)
    trees = []
    for _ in range(N_TREES):
        idx = rng.integers(0, data.x_train.shape[0], data.x_train.shape[0])
        root = train_cart(data.x_train[idx], data.y_train[idx], N_CLASSES,
                          CartConfig(max_depth=8, min_samples_split=16, min_gain=4e-3))
        trees.append(breadth_first_encode(root))
    return EncodedForest(trees)


def host_vote(per_tree: np.ndarray) -> np.ndarray:
    votes = (per_tree[..., None] == np.arange(N_CLASSES)).sum(0)
    return votes.argmax(-1).astype(np.int32)      # first maximum: lowest class


def timed(fn):
    """Host-clock milliseconds of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_service(dev, images, labels, enc, forest):
    """Returns the per-image latencies and each image's stacked ``eval_serial`` classes."""
    tree = ops.PackedTree(enc, N_ATTRS, device=dev)
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    lat = {f"tree/{a}/{j}": [] for a, j in MODES} | {f"forest/{a}/{j}": [] for a, j in MODES}
    per_trees = []
    for i, img in enumerate(images):
        want = eval_serial(enc, img)
        for algorithm, jump_mode in MODES:
            out, ms = timed(lambda: ops.tree_eval(
                torch.from_numpy(img).to(dev), tree, algorithm=algorithm, jump_mode=jump_mode).cpu())
            check(np.array_equal(out.numpy(), want), f"tree {algorithm}/{jump_mode} != eval_serial, image {i}")
            lat[f"tree/{algorithm}/{jump_mode}"].append(ms)
        acc = float((want == labels[i]).mean())
        per_tree = np.stack([eval_serial(forest.tree(t), img) for t in range(forest.n_trees)])
        per_trees.append(per_tree)
        want_vote = host_vote(per_tree)
        for algorithm, jump_mode in MODES:
            def classify():
                rec = torch.from_numpy(img).to(dev)
                classes = ops.forest_eval_fused(rec, packed, algorithm=algorithm, jump_mode=jump_mode)
                return classes.cpu(), majority_vote(classes, N_CLASSES).cpu()
            (classes, vote), ms = timed(classify)
            check(np.array_equal(classes.numpy(), per_tree),
                  f"forest {algorithm}/{jump_mode} != stacked eval_serial, image {i}")
            check(np.array_equal(vote.numpy(), want_vote), f"majority_vote differs, image {i}")
            lat[f"forest/{algorithm}/{jump_mode}"].append(ms)
        print(f"[service] image {i}: tree acc {acc:.4f}, forest vote acc "
              f"{float((want_vote == labels[i]).mean()):.4f}; classes equal eval_serial in all modes")
    return lat, per_trees


# ---------------------------------------------------------------------------
# phase 5q: the quantized forest service
# ---------------------------------------------------------------------------


def quant_layouts(forest: EncodedForest, rows: np.ndarray, dev) -> dict[str, QuantizedForest]:
    layouts = {}
    for thr_dtype in ("bfloat16", "float16"):
        layouts[f"(a) universal {thr_dtype}"] = QuantizedForest(forest, N_ATTRS, thr_dtype=thr_dtype, device=dev)
        layouts[f"(b) calibrated {thr_dtype}"] = QuantizedForest(
            forest, N_ATTRS, thr_dtype=thr_dtype, calibration=rows, device=dev)
        layouts[f"(c) snapped {thr_dtype}"] = stored_as(forest, thr_dtype, dev)
    return layouts


def host_tables(q: QuantizedForest) -> tuple[np.ndarray, ...]:
    """The f32/int32 tables a quantized layout encodes, on the host."""
    return (q.attr_idx.int().cpu().numpy(), q.threshold.float().cpu().numpy(),
            q.child.int().cpu().numpy(), q.class_val.int().cpu().numpy())


def serial_stack(job) -> np.ndarray:
    """Stacked ``eval_serial`` classes of the forest ``tables`` on ``image``."""
    tables, image = job
    forest = EncodedForest.from_arrays(*tables)
    return np.stack([eval_serial(forest.tree(t), image) for t in range(forest.n_trees)])


def quant_oracle(layouts, forest, images, per_trees) -> dict[str, list[np.ndarray]]:
    """Per layout and image, stacked ``eval_serial`` of the forest it encodes.

    A layout whose tables are the forest's own reuses ``per_trees``; the
    others are evaluated in worker processes (``eval_serial`` is a Python
    loop, 0.5 s per tree and image), which the pool stops on exit.
    """
    own = (forest.attr_idx, forest.threshold, forest.child, forest.class_val)
    tables = {name: host_tables(q) for name, q in layouts.items()}
    todo = [name for name, t in tables.items() if not all(np.array_equal(a, b) for a, b in zip(t, own))]
    jobs = [(tables[name], img) for name in todo for img in images]
    workers = min(len(jobs), os.cpu_count() or 1) or 1
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(serial_stack, jobs))
    out = {name: list(per_trees) for name in tables}
    for k, name in enumerate(todo):
        out[name] = done[k * len(images):(k + 1) * len(images)]
    return out


def phase_quant_service(dev, images, forest, rows, per_trees, layouts) -> None:
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    t0 = time.perf_counter()
    oracle = quant_oracle(layouts, forest, images, per_trees)
    print(f"[quant] stacked eval_serial of each layout's forest on {len(images)} images "
          f"({time.perf_counter() - t0:.1f} s on host)")
    for name, q in layouts.items():
        r = q.bytes_report()
        print(f"[quant] {name}: thr_stored {q.thr_stored}, fallback_nodes {q.fallback_nodes} of "
              f"{int((forest.class_val == BOTTOM).sum())}, nbytes {q.nbytes} "
              f"({packed.nbytes / q.nbytes:.1f}x smaller than PackedForest.nbytes {packed.nbytes}); "
              f"{ {k: (v['dtype'], v['bytes']) for k, v in r['tables'].items()} }")
        for i, img in enumerate(images):
            want = oracle[name][i]
            if name.startswith("(b)"):   # calibrated on every row the images are tiled from
                check(np.array_equal(want, per_trees[i]), f"{name} changed the routing of image {i}")
            for algorithm in ops.ALGORITHMS:
                classes = ops.forest_eval_fused_q(torch.from_numpy(img).to(dev), q, algorithm=algorithm)
                vote = majority_vote(classes, N_CLASSES).cpu().numpy()
                check(np.array_equal(classes.cpu().numpy(), want),
                      f"quantized {name} {algorithm} != stacked eval_serial, image {i}")
                check(np.array_equal(vote, host_vote(want)), f"quantized {name} {algorithm}: vote differs, image {i}")
    print(f"[quant] {len(layouts)} layouts x 2 algorithms x {len(images)} images: per-tree classes equal "
          f"stacked eval_serial, votes equal the host vote")


def timed_layouts(layouts) -> dict[str, QuantizedForest]:
    """One layout per threshold storage: f32 from (a), bf16 and f16 from (c)."""
    return {"float32": layouts["(a) universal bfloat16"], "bfloat16": layouts["(c) snapped bfloat16"],
            "float16": layouts["(c) snapped float16"]}


def phase_quant_latency(dev, images, forest, layouts, card) -> None:
    """Per-image latency of ``forest_eval_fused_q`` + vote beside
    ``forest_eval_fused`` (gather) + vote, in turns: fused, quant, quant, fused."""
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    for algorithm in ops.ALGORITHMS:
        for storage, q in timed_layouts(layouts).items():
            def quant(img, q=q, algorithm=algorithm):
                classes = ops.forest_eval_fused_q(torch.from_numpy(img).to(dev), q, algorithm=algorithm)
                return majority_vote(classes, N_CLASSES).cpu()

            def fused(img, algorithm=algorithm):
                classes = ops.forest_eval_fused(torch.from_numpy(img).to(dev), packed, algorithm=algorithm)
                return majority_vote(classes, N_CLASSES).cpu()

            quant(images[0]), fused(images[0])               # warm up
            calls = {"quant": quant, "fused": fused}
            lat = {"quant": [], "fused": []}
            for img in images:
                for label in ("fused", "quant", "quant", "fused"):
                    _, ms = timed(lambda: calls[label](img))
                    lat[label].append(ms)
            print(f"[quant] {card}: {algorithm} per-image ms (H2D + eval + vote + D2H, host clock, in turns, "
                  f"{len(images)} images): forest_eval_fused_q ({storage} thresholds) mean "
                  f"{np.mean(lat['quant']):.3f} min {min(lat['quant']):.3f}; forest_eval_fused mean "
                  f"{np.mean(lat['fused']):.3f} min {min(lat['fused']):.3f}")


# ---------------------------------------------------------------------------
# phase 6: the cascade
# ---------------------------------------------------------------------------


def skewed_mix(image: np.ndarray, seed: int = 1) -> np.ndarray:
    """``image`` with 10% of its rows replaced by noise drawn from its
    per-attribute mean and std — the 90/10 mix of the JAX package's cascade
    bench (``benchmarks/cascade_sweep.py``)."""
    m = image.shape[0]
    rng = np.random.default_rng(seed)
    hard = rng.normal(loc=image.mean(0), scale=image.std(0) + 1e-6, size=image.shape).astype(np.float32)
    n_hard = m // 10
    skew = image.copy()
    skew[rng.permutation(m)[:n_hard]] = hard[:n_hard]
    return skew


def cascade_plan(dev, forest, calibration, stages: int, bound):
    return plan_cascade(forest, calibration[:512], n_classes=N_CLASSES, stages=stages, bound=bound,
                        device=dev)


def cascade_evaluator(dev, forest, plan, bound, algorithm: str, jump_mode: str) -> CascadeEvaluator:
    return CascadeEvaluator(forest, plan, n_classes=N_CLASSES, bound=bound, engine="cuda",
                            algorithm=algorithm, jump_mode=jump_mode, device=dev)


def phase_cascade(dev, inputs, per_trees, forest, card) -> None:
    """Every cascade configuration on every input against the host oracle."""
    names = [f"image {i}" for i in range(len(inputs) - 1)] + ["skewed 90/10"]
    calibration = inputs[0]
    for stages in CASCADE_STAGES:
        for bound in CASCADE_BOUNDS:
            plan = cascade_plan(dev, forest, calibration, stages, bound)
            refs = [cascade_ref_from_classes(pt, order=plan.order, stage_sizes=plan.stage_sizes,
                                             n_classes=N_CLASSES, bound=bound) for pt in per_trees]
            survivors, trees = {}, {}
            for algorithm, jump_mode in MODES:
                ev = cascade_evaluator(dev, forest, plan, bound, algorithm, jump_mode)
                for img, pt, ref, name in zip(inputs, per_trees, refs, names):
                    res = ev(torch.from_numpy(img).to(dev))
                    for field in CASCADE_FIELDS:
                        check(np.array_equal(getattr(res, field).cpu().numpy(), getattr(ref, field)),
                              f"cascade {algorithm}/{jump_mode} stages={stages} bound={bound}: "
                              f"{field} != host reference on {name}")
                    if bound in (None, 1.0):
                        check(np.array_equal(res.classes.cpu().numpy(), host_vote(pt)),
                              f"cascade bound={bound} classes != majority vote on {name}")
                    survivors[name] = res.stage_survivors
                    trees[name] = float(ref.trees_evaluated.mean())
            print(f"[cascade] {card}: stages={stages} bound={bound} plan {plan.stage_sizes}: "
                  f"3 modes x {len(inputs)} inputs equal the host reference; survivors per stage "
                  f"{survivors[names[0]]} (image 0), {survivors[names[-1]]} (skewed); mean trees "
                  f"evaluated {trees[names[0]]:.3f} (image 0), {trees[names[-1]]:.3f} (skewed), "
                  f"{np.mean([trees[n] for n in names[:-1]]):.3f} (5 images)")
    plan = cascade_plan(dev, forest, calibration, 2, None)
    res = cascade_evaluator(dev, forest, plan, None, "speculative", "gather")(
        torch.from_numpy(inputs[0]).to(dev), deadline_ms=0)
    check(res.stages_run == 1, f"deadline_ms=0 ran {res.stages_run} stages, not 1")
    print(f"[cascade] deadline_ms=0: stages_run {res.stages_run}, survivors {res.stage_survivors}")


def phase_cascade_latency(dev, inputs, forest, card) -> None:
    """Per-input latency of the cascade (2 stages, bound 1.0) and of the fused
    forest + majority vote, timed in turns: forest, cascade, cascade, forest."""
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    plan = cascade_plan(dev, forest, inputs[0], 2, 1.0)
    for algorithm, jump_mode in MODES:
        ev = cascade_evaluator(dev, forest, plan, 1.0, algorithm, jump_mode)

        def cascade(img):
            return ev(torch.from_numpy(img).to(dev)).classes.cpu()

        def fused(img):
            rec = torch.from_numpy(img).to(dev)
            per_tree = ops.forest_eval_fused(rec, packed, algorithm=algorithm, jump_mode=jump_mode)
            return majority_vote(per_tree, N_CLASSES).cpu()

        cascade(inputs[0]), fused(inputs[0])                # warm up
        calls = {"cascade": cascade, "fused": fused}
        lat = {"cascade": [], "fused": []}
        for img in inputs:
            for label in ("fused", "cascade", "cascade", "fused"):
                _, ms = timed(lambda: calls[label](img))
                lat[label].append(ms)
        c, f = np.array(lat["cascade"]).reshape(-1, 2), np.array(lat["fused"]).reshape(-1, 2)
        print(f"[cascade] {card}: {algorithm}/{jump_mode} per-input ms (H2D + eval + D2H, host clock, "
              f"in turns): cascade 2 stages bound 1.0 mean {c[:-1].mean():.3f} on the 5 images, "
              f"{c[-1].mean():.3f} on the skewed mix; forest_eval_fused + majority_vote "
              f"{f[:-1].mean():.3f} and {f[-1].mean():.3f}")


# ---------------------------------------------------------------------------
# phase 6s: the served path (profiler → tuner → TreeServeEngine)
# ---------------------------------------------------------------------------


SERVE_MAX_BATCH = 65_536
SERVE_REQUEST_MAX = 16_384
SERVE_SEED = 17   # its stream's last wave (18,243 records) falls into the M 32,768 bucket


def variant_launch_key(variant: str, params: dict, stored: dict) -> str | None:
    """``kernel.LAUNCHES`` key of the kernel a tuner candidate launches (None
    for the torch engine, the per-tree family and the majority vote);
    ``stored`` maps a quantized candidate's ``thr_dtype`` to the storage its
    universal layout of the forest keeps."""
    jump_mode = "onehot" if variant.endswith("onehot") else "gather"
    algorithm = "data_parallel" if "data_parallel" in variant else "speculative"
    if variant.startswith("cuda_"):
        return kernel_name(False, algorithm, jump_mode)
    if variant.startswith("forest_fused_") and variant.endswith("_q"):
        return quant_name(algorithm, stored[params["thr_dtype"]])
    if variant.startswith("forest_fused_"):
        return kernel_name(True, algorithm, jump_mode)
    if variant.startswith("forest_cascade_fused_"):
        return votes_name(algorithm, jump_mode)
    return None


def serve_requests(images, seed: int = SERVE_SEED):
    """The five images as one stream cut into requests of seeded sizes in
    [1, SERVE_REQUEST_MAX]."""
    from repro_torch.serve import TreeRequest

    stream = np.concatenate(images)
    rng = np.random.default_rng(seed)
    reqs, off = [], 0
    while off < stream.shape[0]:
        m = int(rng.integers(1, SERVE_REQUEST_MAX + 1))
        reqs.append(TreeRequest(uid=len(reqs), records=stream[off:off + m]))
        off += m
    return reqs


def candidate_medians(registry, level: str) -> list[tuple[str, float]]:
    """(variant and params, median ms) of each candidate a sweep at ``level``
    measured, from the tuner's ``tune.candidate_median_ms`` gauge."""
    gauge = registry.get("tune.candidate_median_ms")
    rows = [] if gauge is None else [(f"{labels[1]} {labels[2]}", series.value)
                                     for labels, series in gauge.series() if labels[0] == level]
    return sorted(rows, key=lambda r: r[1])


def serve_breakdown(eng, requests, key: str, card) -> None:
    """Where one served wave's time goes: ``eng.run`` of one wave's
    ``requests`` under the profiler (host wall, device busy by kernel: the
    records' copy in, the padding to the bucket, the winner's kernel, the
    classes' copy out, the shadow pass on its own stream), the engine's
    spans of that wave, and — timed apart, on the host clock — the
    resolution a bucket's first wave pays."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import TreeRequest
    from repro_torch.tune import TunedEvaluator, TuneCache

    wave = [TreeRequest(uid=r.uid, records=r.records) for r in requests]
    eng.tracer.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(wave)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    groups: dict = {}
    for e in events:
        group = ("copy in" if e.key.startswith("Memcpy HtoD") else "copy out" if e.key.startswith("Memcpy DtoH")
                 else "tree kernel" if "_kernel" in e.key and "at::" not in e.key else "torch ops")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3, n + e.count)
    parts = "; ".join(f"{g} {ms:.4f} ms x{n}" for g, (ms, n) in sorted(groups.items()))
    ours = "; ".join(f"{e.key.split('(')[0][-40:]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}"
                     for e in events if "_kernel" in e.key and "at::" not in e.key)
    spans = "; ".join(f"{e.name} {e.dur_us / 1e3:.3f} ms" for e in eng.tracer.events() if e.ph == "X")
    batch = np.concatenate([r.records for r in wave])
    fresh = TunedEvaluator(eng.tree, cache=TuneCache(Path(eng._eval.cache.path).with_name("fresh.json")),
                           device=eng.device)
    t0 = time.perf_counter()
    fresh.resolve(batch)
    resolve_ms = (time.perf_counter() - t0) * 1e3
    print(f"[serve] {card}: one wave of {key} ({len(wave)} requests, {len(batch)} records) under the profiler: "
          f"host wall {wall:.3f} ms, device busy {busy:.4f} ms, idle share {1 - busy / wall:.1%}; device by kind: "
          f"{parts} (torch ops: the padding and the shadow pass); tree kernel: {ours}; spans: {spans}; "
          f"a first wave's resolution (heuristic, 256-record d_mu sample) "
          f"{resolve_ms:.3f} ms more (host clock)")


def sample_line(m) -> str:
    """A measured candidate's score, median and raw samples."""
    return (f"score {m.score_ms:.4f} ms = median {m.median_ms:.4f} ms + launch price "
            f"{m.score_ms - m.median_ms:.4f} ms; samples (device ms, host enqueue hidden) "
            + "[" + ", ".join(f"{x:.4f}" for x in m.samples_ms) + "]")


def loaded_vs_quiet(eng, batch, wave, key: str, dev, card) -> None:
    """The tuner's repair, held on the card: the bucket ``key``'s sweep on a
    worker thread and stream of its own, once with no wave in flight and
    once while another thread serves ``wave`` through the engine without
    pause; the winners' algorithms must agree.  Every candidate's score and
    samples are printed, and each score's ratio under load."""
    import threading

    from repro_torch.serve import TreeRequest
    from repro_torch.tune import tune_workload

    def sweep(loaded: bool):
        stop, served, out = threading.Event(), [0], {}

        def serve():
            while not stop.is_set():
                eng.run([TreeRequest(uid=r.uid, records=r.records) for r in wave])
                served[0] += 1

        def measure():
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                out["sweep"] = tune_workload(batch, eng.tree, cache=None, warmup=1, iters=3, device=dev)

        server = threading.Thread(target=serve) if loaded else None
        if server is not None:
            server.start()
            while served[0] < 1:
                time.sleep(0.001)
        worker = threading.Thread(target=measure)
        t0 = time.perf_counter()
        worker.start()
        worker.join()
        secs = time.perf_counter() - t0
        stop.set()
        if server is not None:
            server.join()
        check("sweep" in out, "the sweep raised on its worker thread")
        return out["sweep"], served[0], secs

    (quiet, q_sweep), _, q_s = sweep(False)
    (loaded, l_sweep), n_served, l_s = sweep(True)
    q_alg, l_alg = (ops.get_variant(e.variant).algorithm for e in (quiet, loaded))
    q_by = {(m.candidate.variant, repr(m.candidate.param_dict)): m for m in q_sweep}
    print(f"[serve] {card}: bucket {key}, the repaired sweep (spin-hidden device time + launches x "
          f"{K.launch_cost_ms(dev) * 1e3:.2f} us a launch), no wave in flight ({q_s:.2f} s) against while "
          f"{n_served} waves were served on another thread ({l_s:.2f} s): winner {quiet.variant} "
          f"{quiet.params} against {loaded.variant} {loaded.params}")
    for m in sorted(l_sweep, key=lambda m: m.score_ms):
        q = q_by[(m.candidate.variant, repr(m.candidate.param_dict))]
        print(f"[serve]   {m.candidate.variant} {m.candidate.param_dict}: quiet {sample_line(q)}; "
              f"loaded {sample_line(m)}; score ratio {m.score_ms / q.score_ms:.2f}")
    check(q_alg == l_alg,
          f"the sweep under load picks {loaded.variant}, without load {quiet.variant}")
    check(n_served >= 1, "no wave was served during the loaded sweep")


def serve_tile_timing(dev, image, enc, card) -> None:
    """K1 gather and K2 on the paper's tree at each tile the tuner's grid
    holds (sized at the bucket's upper N and A, 128) beside the tile
    ``ops.choose_block_m`` gives at the tree's own N and A: device time
    (profiler, 100 launches each, record buffers rotated past L2)."""
    rec = torch.from_numpy(image).to(dev)
    n_bufs = L2_BYTES // rec.nbytes + 2
    raw = [rec.clone() for _ in range(n_bufs)]
    tree = ops.PackedTree(enc, N_ATTRS, device=dev)
    runs = []
    for algorithm in ("speculative", "data_parallel"):
        own = ops.choose_block_m(enc.n_nodes, N_ATTRS, algorithm=algorithm)
        grid = {own} | {c.param_dict["block_m"] for c in _tree_grid(algorithm)}
        for bm in sorted(grid):
            if algorithm == "speculative":
                fn = lambda i, bm=bm: run_speculative(False, raw[i], tree, "gather", bm)  # noqa: E731
            else:
                fn = lambda i, bm=bm: run_data_parallel(False, raw[i], tree, bm)  # noqa: E731
            runs.append(((algorithm, bm, bm == own), fn))
    times = profiled_ms(runs, n_bufs, iters=100)
    print(f"[timing] {card}: the tree kernel at each tile of the tuner's grid (M {rec.shape[0]}, N {enc.n_nodes}, A {N_ATTRS}; "
          f"profiler device time): " + "; ".join(
              f"{'K1 gather' if a == 'speculative' else 'K2'} block_m {bm}{' (own N, A)' if own else ''} "
              f"{times[(a, bm, own)][0]:.4f} ms" for (a, bm, own), _ in runs))


def _tree_grid(algorithm: str):
    """The tuner's gather-form candidates of ``algorithm`` at the paper's tree's bucket."""
    from repro_torch.tune import WorkloadShape, search_space

    shape = WorkloadShape(m=M_IMAGE, n_nodes=75, n_attrs=N_ATTRS, depth=12)
    return [c for c in search_space(shape, engines=("cuda",))
            if ops.get_variant(c.variant).algorithm == algorithm and ops.get_variant(c.variant).jump_mode == "gather"]


def phase_serve(dev, images, enc, forest, per_trees, card) -> set:
    """The served path at the paper's sizes: the CART tree behind a
    ``TreeServeEngine`` (background re-tune, shadow profiler, flight
    recorder) on the five images cut into requests, twice; the 16-tree
    forest through ``eval_forest_tuned`` (autotuned, quantized layouts
    opted in) and ``ForestTunedEvaluator.predict`` (majority vote against
    the cascades).  Returns the ``LAUNCHES`` keys the tuner's candidates
    launch, each of which must launch in this phase."""
    import tempfile
    from collections import deque

    from repro_torch.core import eval_forest_tuned
    from repro_torch.serve import RetunePolicy, TreeRequest, TreeServeEngine
    from repro_torch.serve.engine import _next_wave
    from repro_torch.tune import (
        ForestShape, ForestTunedEvaluator, TuneCache, WorkloadShape, backend_tag,
        heuristic_candidate, measured_d_mu,
    )

    t_phase = time.perf_counter()
    tag = backend_tag(dev)
    want_keys: set = set()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        cache = TuneCache(Path(tmp) / "tune.json")
        policy = obs.ProfilePolicy(sample_every=1, sample_records=4096, synchronous=True)
        eng = TreeServeEngine(enc, max_batch=SERVE_MAX_BATCH, cache=cache,
                              retune=RetunePolicy(hot_waves=2, warmup=1, iters=3), profile=policy,
                              flight=obs.FlightPolicy(out_dir=str(Path(tmp) / "flight")), tracer=obs.Tracer(),
                              device=dev)
        reqs = serve_requests(images)
        want = np.concatenate([eval_serial(enc, img) for img in images])
        waves, wave_reqs, queue = [], [], deque(reqs)
        while queue:
            wave, _ = _next_wave(queue, SERVE_MAX_BATCH)
            wave_reqs.append(wave)
            waves.append(np.concatenate([r.records for r in wave]))
        keys = [eng._key(w) for w in waves]
        print(f"[serve] {len(reqs)} requests of 1–{SERVE_REQUEST_MAX} records ({sum(len(w) for w in waves)} "
              f"records) in {len(waves)} waves of at most {SERVE_MAX_BATCH}; buckets {sorted(set(keys))}")
        check(len(set(keys)) >= 2, f"waves fall into {len(set(keys))} M bucket(s), not at least 2")

        for label in ("first pass", "second pass"):
            batch = [TreeRequest(uid=r.uid, records=r.records) for r in reqs]
            t0 = time.perf_counter()
            eng.run(batch)
            ms = (time.perf_counter() - t0) * 1e3
            got = np.concatenate([r.out for r in batch])
            check(np.array_equal(got, want), f"served classes != eval_serial ({label})")
            t1 = time.perf_counter()
            eng.retuner.drain(timeout=120)
            drain_s = time.perf_counter() - t1
            check(not any(t.is_alive() for t in eng.retuner._threads), "the retuner is still measuring")
            check(not eng.retuner.errors, f"retuner failures: {eng.retuner.errors}")
            check(eng.stats.retunes >= 1, "no bucket was re-tuned")
            print(f"[serve] {card}: {label}: {len(batch)} requests classified equal to eval_serial in "
                  f"{ms:.1f} ms host wall; retuner drained in {drain_s:.2f} s, {eng.stats.retunes} "
                  f"retune(s) so far, 0 failures")
        counters = obs.snapshot(eng.obs)["counters"]
        failed = {k: v for k, v in counters.items() if k.startswith("tune.failed_candidates") and v}
        check(not failed, f"failed candidates in the serve engine's sweeps: {failed}")
        check(not counters.get("prof.errors"), f"{counters.get('prof.errors')} shadow passes raised")
        check(eng.stats.waves == 2 * len(waves), f"{eng.stats.waves} waves, not {2 * len(waves)}")

        flight_waves = eng.flight.waves()
        for key in sorted(set(keys)):
            batches = [w for w, k in zip(waves, keys) if k == key]
            shape = WorkloadShape.of(batches[0], enc)
            d_sampled = measured_d_mu(enc, batches[0])
            d_prof = eng.profiler.d_mu(key)
            d_host = mean_traversal_depth(observed_depths(enc, batches[-1][:policy.sample_records]))
            check(d_prof == d_host, f"{key}: profiler d_mu {d_prof} != host d_mu {d_host} on its records")
            pick = heuristic_candidate(shape, d_mu=d_sampled, device=dev)
            pick_prof = heuristic_candidate(shape, d_mu=d_prof, device=dev)
            wave_ms = [w["latency_ms"] for w in flight_waves if w.get("bucket") == key]
            print(f"[serve] {card}: bucket {key}: {len(batches)} wave(s) a pass; heuristic pick "
                  f"{pick.variant} {pick.param_dict} (at the first wave's sampled d_mu {d_sampled:.4f}; at the "
                  f"profiler's {pick_prof.variant} {pick_prof.param_dict}); profiler d_mu {d_prof:.6f} == host "
                  f"mean_traversal_depth {d_host:.6f} on the same {min(len(batches[-1]), policy.sample_records)} "
                  f"records; per-wave ms (host clock, H2D + pad + kernel + D2H, {len(wave_ms)} waves) "
                  f"mean {np.mean(wave_ms):.3f} min {min(wave_ms):.3f} max {max(wave_ms):.3f}")
            sweep = eng.sweeps.get(key)
            if sweep is None:
                print(f"[serve]   not re-tuned: {len(batches)} wave(s) a pass")
                continue
            entry = cache.lookup(key)
            resolved, source = eng._eval._resolved[key]
            check(source == "retune" and resolved.variant == entry.variant,
                  f"{key}: the served winner is {resolved} ({source}), not the measured {entry.variant}")
            for m in sorted(sweep, key=lambda m: m.score_ms):
                launch_key = variant_launch_key(m.candidate.variant, m.candidate.param_dict, {})
                if launch_key is not None:
                    want_keys.add(launch_key)
                    check(m.launches.get(launch_key, 0) > 0,
                          f"{m.candidate} launched {m.launches}, not {launch_key}")
                print(f"[serve]   candidate {m.candidate.variant} {m.candidate.param_dict}: {sample_line(m)}, "
                      f"bucket-padded M {shape.bucket().m}, launches {m.launches}")
            print(f"[serve]   measured winner {entry.variant} {entry.params} (median {entry.median_ms:.4f} ms); "
                  f"heuristic pick {'agrees' if pick.variant == entry.variant else 'differs'}")
        big = max(set(keys), key=lambda k: WorkloadShape.of(waves[keys.index(k)], enc).bucket().m)
        loaded_vs_quiet(eng, waves[keys.index(big)], wave_reqs[keys.index(big)], big, dev, card)
        for key in sorted(set(keys)):
            serve_breakdown(eng, wave_reqs[keys.index(key)], key, card)
        bundle = eng.dump_flight("chip_smoke")
        loaded = json.loads((bundle / "flight.json").read_text())
        json.loads((bundle / "trace.json").read_text())
        check(loaded["engine"] == "tree" and loaded["waves"], "flight bundle without waves")
        print(f"[serve] flight bundle {bundle.name}: flight.json ({len(loaded['waves'])} ring entries) and "
              f"trace.json read back as JSON")

        reg = obs.default_registry()
        t0 = time.perf_counter()
        per_tree = eval_forest_tuned(forest, images[0], cache=cache, autotune=True,
                                     layouts=("f32", "quant")).cpu().numpy()
        check(np.array_equal(per_tree, per_trees[0]), "eval_forest_tuned != stacked eval_serial")
        fshape = ForestShape.of(images[0], forest)
        medians = candidate_medians(reg, "forest")
        # a layout-opted-in sweep keeps its winner out of the cache (the JAX
        # package's rule for restricted sweeps): the winner is its least median
        print(f"[serve] {card}: eval_forest_tuned (autotune, layouts f32 + quant) on image 0: per-tree classes "
              f"equal stacked eval_serial ({time.perf_counter() - t0:.2f} s with the sweep); winner "
              f"{medians[0][0]} {medians[0][1]:.4f} ms")
        for name, ms in medians:
            print(f"[serve]   forest candidate {name}: median {ms:.4f} ms (CUDA events)")
        t0 = time.perf_counter()
        fte = ForestTunedEvaluator(forest, cache=cache, autotune=True)
        classes = fte.predict(images[0], N_CLASSES).cpu().numpy()
        check(np.array_equal(classes, host_vote(per_trees[0])), "predict != the host majority vote")
        centry = cache.lookup(fshape.classes_key(N_CLASSES, tag))
        print(f"[serve] {card}: ForestTunedEvaluator.predict (autotune) on image 0: classes equal the host "
              f"majority vote ({time.perf_counter() - t0:.2f} s with the sweep); classes-level winner "
              f"{centry.variant} {centry.params} {centry.median_ms:.4f} ms")
        for name, ms in candidate_medians(reg, "classes"):
            print(f"[serve]   classes candidate {name}: median {ms:.4f} ms (CUDA events)")
        counters = obs.snapshot(reg)["counters"]
        failed = {k: v for k, v in counters.items() if k.startswith("tune.failed_candidates") and v}
        check(not failed, f"failed candidates in the forest sweeps: {failed}")
        stored = {td: QuantizedForest(forest, N_ATTRS, thr_dtype=td, device=dev).thr_stored
                  for td in ("bfloat16", "float16")}
        gauge = reg.get("tune.candidate_median_ms")
        for labels, _ in gauge.series():
            key = variant_launch_key(labels[1], ast.literal_eval(labels[2]), stored)
            if key is not None:
                want_keys.add(key)
    print(f"[serve] phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return want_keys


# ---------------------------------------------------------------------------
# phase 6f: sharded and streamed forest serving (dist → ForestServeEngine)
# ---------------------------------------------------------------------------


FOREST_CHUNK = 8_192
WINDOW_DEPTH = 13          # a perfect tree of 16,383 nodes: speculative K1 refuses it on the card
FOREST_PATH = ("fused_speculative/gather", "fused_data_parallel", "fused_votes_speculative/gather",
               "fused_votes_speculative/onehot", "fused_votes_data_parallel",
               "fused_speculative_q/float32", "fused_data_parallel_q/float32")


def device_intervals(prof, tmp: Path) -> list[tuple[str, float, float, int]]:
    """(name, start µs, end µs, stream) of every device event of a profile,
    read from its Chrome trace."""
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), int(e.get("args", {}).get("stream", -1)))
            for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def union_length(spans) -> float:
    """Length covered by a set of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def overlap_length(a, b) -> float:
    """Length covered by both interval sets."""
    return union_length(a) + union_length(b) - union_length(list(a) + list(b))


SPIN_MARKER = 100_000   # clock cycles of the torch.cuda._sleep kernel that ends each profiled run


def profiled_device(runs, card, tmp: Path) -> None:
    """Each ``(label, run, tracer)`` of ``runs`` under one profiler session
    (a process's later sessions can lose kernels; phase 7 needs many), the
    runs told apart by a spin kernel after each: host wall, device busy and
    idle share, device time by kind and stream, how long the pinned copies
    in overlapped a kernel, and the host spans ``tracer`` saw."""
    from torch.profiler import ProfilerActivity, profile

    walls, hosts = [], []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, run, tracer in runs:
            tracer.clear()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            host: dict = {}
            for e in tracer.events():
                if e.ph == "X":
                    host[e.name] = host.get(e.name, 0.0) + e.dur_us / 1e3
            hosts.append(host)
            torch.cuda._sleep(SPIN_MARKER)
            torch.cuda.synchronize()
    blocks, block = [], []
    for span in sorted(device_intervals(prof, tmp), key=lambda x: x[1]):
        if "spin_kernel" in span[0]:
            blocks.append(block)
            block = []
        else:
            block.append(span)
    check(len(blocks) == len(runs) and all(blocks),
          f"the profiler saw {[len(b) for b in blocks]} device events between markers for {len(runs)} runs")
    for (label, _, _), spans, wall, host in zip(runs, blocks, walls, hosts):
        kinds: dict = {}
        for name, a, b, stream in spans:
            kind = ("copy in (pinned)" if "HtoD" in name and "Pinned" in name else "copy in (pageable)" if "HtoD" in name
                    else "copy out" if "DtoH" in name else "copy d2d" if "Memcpy" in name
                    else "forest kernel" if "_kernel" in name and "at::" not in name else "torch ops")
            ms, n, streams = kinds.get(kind, (0.0, 0, set()))
            kinds[kind] = (ms + (b - a) / 1e3, n + 1, streams | {stream})
        busy = union_length([(a, b) for _, a, b, _ in spans]) / 1e3
        pinned = [(a, b) for name, a, b, _ in spans if "HtoD" in name and "Pinned" in name]
        kern = [(a, b) for name, a, b, _ in spans if "Memcpy" not in name and "Memset" not in name]
        ours = [(a, b) for name, a, b, _ in spans if "_kernel" in name and "at::" not in name]
        parts = "; ".join(f"{k} {ms:.4f} ms x{n} (stream {sorted(st)})" for k, (ms, n, st) in sorted(kinds.items()))
        print(f"[forest-serve] {card}: {label} under the profiler: host wall {wall:.3f} ms, device busy {busy:.4f} ms, "
              f"idle share {1 - busy / wall:.1%}; device by kind: {parts}; the pinned copies in overlapped by any "
              f"kernel {overlap_length(pinned, kern) / 1e3:.4f} ms of {union_length(pinned) / 1e3:.4f} ms, by a forest "
              f"kernel {overlap_length(pinned, ours) / 1e3:.4f} ms; host spans (sums): "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(host.items(), key=lambda kv: -kv[1])))


def phase_forest_serve(dev, images, forest, per_trees, card) -> dict:
    """The forest served through ``repro_torch.dist`` at the paper's sizes:
    ``ForestServeEngine`` streaming the 45 requests twice (background
    re-tune, shadow profiler), the anytime cascade under a loose and a
    cutting deadline, ``ShardedForestEvaluator`` over four logical shards
    of one card, the chunker alone, and the windowed evaluator on a tree the
    speculative kernels refuse.  Returns the launches of each part."""
    import tempfile
    import warnings

    from repro_torch.core import eval_forest_tuned, eval_windowed, perfect_tree
    from repro_torch.dist import ShardedForestEvaluator, StreamingChunker
    from repro_torch.parallel.sharding import forest_mesh
    from repro_torch.serve import AnytimePolicy, ForestServeEngine, RetunePolicy, TreeRequest
    from repro_torch.serve.engine import _next_wave
    from repro_torch.tune import ForestShape, TuneCache, TuneEntry, backend_tag

    t_phase = time.perf_counter()
    parts: dict = {}
    reqs = serve_requests(images)
    want = host_vote(np.concatenate(per_trees, axis=1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_forest_") as tmp:
        tmp = Path(tmp)
        # -- streamed waves ----------------------------------------------------
        cache = TuneCache(tmp / "tune.json")
        policy = obs.ProfilePolicy(sample_every=1, sample_records=4096, synchronous=True)
        eng = ForestServeEngine(forest, max_batch=SERVE_MAX_BATCH, chunk_records=FOREST_CHUNK,
                                n_classes=N_CLASSES, cache=cache, layouts=("f32", "quant"),
                                retune=RetunePolicy(hot_waves=2, warmup=1, iters=3), profile=policy,
                                flight=obs.FlightPolicy(out_dir=str(tmp / "flight")), tracer=obs.Tracer(),
                                devices=(dev,))
        with K.thread_launches() as waves_l:
            for label in ("first pass", "second pass"):
                batch = [TreeRequest(uid=r.uid, records=r.records) for r in reqs]
                t0 = time.perf_counter()
                eng.run(batch)
                ms = (time.perf_counter() - t0) * 1e3
                check(np.array_equal(np.concatenate([r.out for r in batch]), want),
                      f"streamed forest waves != the host vote of stacked eval_serial ({label})")
                eng.retuner.drain(timeout=300)
                check(not any(t.is_alive() for t in eng.retuner._threads), "the forest retuner is still measuring")
                check(not eng.retuner.errors, f"forest retuner failures: {eng.retuner.errors}")
                print(f"[forest-serve] {card}: {label}: {len(batch)} requests, majority vote equal to the host vote "
                      f"of stacked eval_serial, in {ms:.1f} ms host wall; {eng.stats.retunes} retune(s) so far")
        parts["served waves"] = waves_l
        check(eng.stats.retunes >= 1, "no forest bucket was re-tuned")
        counters = obs.snapshot(eng.obs)["counters"]
        failed = {k: v for k, v in counters.items() if k.startswith("tune.failed_candidates") and v}
        check(not failed, f"failed candidates in the forest engine's sweeps: {failed}")
        check(not counters.get("prof.errors"), f"{counters.get('prof.errors')} forest shadow passes raised")
        retune_l: dict = {}
        for key, sweep in eng.sweeps.items():
            print(f"[forest-serve]   retune of {key} at the chunk size ({len(sweep)} candidates, CUDA events "
                  f"on the retuner's stream):")
            for m in sorted(sweep, key=lambda m: m.score_ms):
                for k, n in m.launches.items():
                    retune_l[k] = retune_l.get(k, 0) + n
                print(f"[forest-serve]     {m.candidate.variant} {m.candidate.param_dict}: {sample_line(m)}, "
                      f"launches {m.launches}")
        parts["retune candidates"] = retune_l
        chunk_ms, overlap = eng.stats.chunk_ms, eng._chunker.stats.overlap_ratio
        wave_ms = [w["latency_ms"] for w in eng.flight.waves()]
        print(f"[forest-serve] {card}: plan {eng.plan}; {eng.stats.waves} waves, {eng.stats.chunks} chunks "
              f"(configured {FOREST_CHUNK}, effective now {eng._chunker.effective_chunk_records}); per-chunk ms "
              f"(submit to drained, host clock) mean {np.mean(chunk_ms):.3f} min {min(chunk_ms):.3f} max "
              f"{max(chunk_ms):.3f}; overlap ratio mean {np.mean(overlap):.3f} max {max(overlap):.3f}; per-wave ms "
              f"(chunked eval + vote, host clock, {len(wave_ms)} waves in the flight ring) mean {np.mean(wave_ms):.3f} "
              f"min {min(wave_ms):.3f} max {max(wave_ms):.3f}")
        queue = deque(reqs)
        first_wave, _ = _next_wave(queue, SERVE_MAX_BATCH)
        size = eng._chunker.effective_chunk_records
        profile_runs = [(f"one served wave ({len(first_wave)} requests, {sum(len(r.records) for r in first_wave)} "
                         f"records, chunks of {size} as the chunker has coalesced them)",
                         lambda: eng.run([TreeRequest(uid=r.uid, records=r.records) for r in first_wave]),
                         eng.tracer)]

        # -- anytime -----------------------------------------------------------
        anytime_l: dict = {}
        for algorithm, jump_mode, slo in (("speculative", "gather", 1e6), ("speculative", "gather", 0.0),
                                          ("speculative", "onehot", 0.0), ("data_parallel", "gather", 0.0)):
            a_eng = ForestServeEngine(forest, max_batch=SERVE_MAX_BATCH, n_classes=N_CLASSES, cache=cache,
                                      retune=None, profile=None, devices=(dev,),
                                      anytime=AnytimePolicy(slo_ms=slo, algorithm=algorithm, jump_mode=jump_mode))
            batch = [TreeRequest(uid=r.uid, records=r.records) for r in reqs]
            with K.thread_launches() as l:
                t0 = time.perf_counter()
                a_eng.run(batch)
                ms = (time.perf_counter() - t0) * 1e3
            for k, n in l.items():
                anytime_l[k] = anytime_l.get(k, 0) + n
            got = np.concatenate([r.out for r in batch])
            exit_stage = np.concatenate([r.exit_stage for r in batch])
            conf = np.concatenate([r.confidence for r in batch])
            exited = exit_stage >= 0
            n_conf = a_eng.stats.m_anytime_confidence.count
            check(n_conf == len(got), f"{n_conf} confidences recorded for {len(got)} records")
            if slo >= 1e6:
                check(np.array_equal(got, want), "anytime classes under a deadline no wave reaches != the host vote")
                check(a_eng.stats.anytime_truncations == 0, "a wave was truncated under a deadline it never reaches")
            else:
                check(a_eng.stats.anytime_truncations >= 1, f"no wave truncated at slo_ms={slo}")
                check(np.array_equal(got[exited], want[exited]),
                      "anytime classes of records that cleared the bound != the host vote")
            print(f"[forest-serve] {card}: anytime {algorithm}/{jump_mode} slo_ms={slo:g}: {a_eng.stats.waves} waves in "
                  f"{ms:.1f} ms host wall, stages run {a_eng.stats.anytime_stages}, truncations "
                  f"{a_eng.stats.anytime_truncations}, {int(exited.sum())} of {len(got)} records exited at a stage "
                  f"and equal the host vote ({'all' if slo >= 1e6 else 'the rest carry confidence'} "
                  f"{float(conf.mean()):.4f} mean); launches {dict(l)}")
        parts["anytime stages"] = anytime_l

        # -- sharded lowering on one card --------------------------------------
        ref = eval_forest_tuned(forest, images[0], cache=TuneCache(tmp / "mono.json"), device=dev).cpu().numpy()
        check(np.array_equal(ref, per_trees[0]), "eval_forest_tuned != stacked eval_serial on image 0")
        shard_l: dict = {}
        tag = backend_tag(dev)
        for i, (deco, r, g, variant, params) in enumerate((
                ("records", 4, 1, "forest_fused_speculative_gather", {"block_m": 32}),
                ("trees", 1, 4, None, None),
                ("hybrid", 2, 2, "forest_fused_data_parallel_q", {"thr_dtype": "bfloat16"}),
                ("hybrid", 2, 2, "forest_fused_speculative_q", {"thr_dtype": "float16"}))):
            s_cache = TuneCache(tmp / f"shard{i}.json")
            ev = ShardedForestEvaluator(forest, mesh=forest_mesh(r, g, devices=(dev,) * 4), cache=s_cache,
                                        layouts=("f32", "quant"))
            fev = ev._forest_evaluator()
            if variant is not None:   # a winner stored at the shard shape is what the shards run
                fshape = ForestShape(t=-(-forest.n_trees // g), m=M_IMAGE // r, n_nodes=forest.n_nodes,
                                     n_attrs=N_ATTRS, depth_min=fev.depth_min, depth_max=fev.depth_max)
                s_cache.store(fshape.key(tag), TuneEntry(variant=variant, params=params, median_ms=0.0))
            with K.thread_launches() as l:
                out = ev(images[0]).cpu().numpy()
            check(np.array_equal(out, ref), f"{deco} {r}x{g} != eval_forest_tuned")
            check(ev.plan.decomposition == deco, f"plan {ev.plan} is not {deco}")
            check(sum(l.values()) == r * g, f"{deco} {r}x{g}: shards launched {dict(l)}, not {r * g} kernels")
            if variant is not None:
                check(ev.resolved[1] == "cache" and ev.resolved[0].variant == variant,
                      f"the shards resolved {ev.resolved}, not the stored {variant}")
            line = (f"[forest-serve] {card}: sharded {deco} {r}x{g} on ('{ev.devices[0]}',) x 4 (four logical shards on one "
                    f"card: measures nothing about several cards): resolved {ev.resolved[0].variant} "
                    f"{ev.resolved[0].param_dict} ({ev.resolved[1]}), shards launch {ev.shard_variant}; image 0 "
                    f"equal to eval_forest_tuned, each shard launched its kernel once: {dict(l)}")
            for m in (7, 3, 2):
                with K.thread_launches() as lm:
                    got = ev(images[0][:m]).cpu().numpy()
                check(np.array_equal(got, ref[:, :m]), f"{deco} {r}x{g} at M {m} != eval_forest_tuned")
                check(sum(lm.values()) == r * g, f"{deco} {r}x{g} at M {m}: launched {dict(lm)}")
                l = {k: l.get(k, 0) + lm.get(k, 0) for k in set(l) | set(lm)}
            for k, n in l.items():
                shard_l[k] = shard_l.get(k, 0) + n
            print(line + "; M 7, 3, 2 (padded to the record shards) equal too")
        parts["shard bodies"] = shard_l

        # -- the chunker alone ---------------------------------------------------
        ck_cache = TuneCache(tmp / "chunk.json")
        ev = ShardedForestEvaluator(forest, devices=(dev,), cache=ck_cache)
        mono = eval_forest_tuned(forest, images[0], cache=ck_cache, device=dev).cpu().numpy()
        ck = StreamingChunker(ev, chunk_records=FOREST_CHUNK, inflight=2)
        with K.thread_launches() as l:
            first = ck.eval(images[0])
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    steady = ck.eval(images[0])
                    ms = (time.perf_counter() - t0) * 1e3
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        parts["chunker"] = l
        tracer = obs.Tracer()
        fixed = StreamingChunker(ev, chunk_records=FOREST_CHUNK, inflight=2, auto_coalesce=False, tracer=tracer)
        fixed.eval(images[0])
        profile_runs.append((f"StreamingChunker on image 0 in chunks of {FOREST_CHUNK}, inflight 2, no coalescing",
                             lambda: fixed.eval(images[0]), tracer))
        profiled_device(profile_runs, card, tmp)
        eng.profiler.drain()
        syncs = [str(w.message) for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
        check(np.array_equal(first, mono) and np.array_equal(steady, mono), "the chunker != the monolithic call")
        check(not syncs, f"a steady-state eval synchronized the host: {syncs[:3]}")
        print(f"[forest-serve] {card}: StreamingChunker on image 0 ({ck.stats.chunks // 2} chunks of {FOREST_CHUNK}, "
              f"inflight 2, pinned slots on a copy stream) equal to the monolithic eval_forest_tuned; the steady-state "
              f"eval ({ms:.3f} ms host wall) raised no synchronizing-operation warning under "
              f"torch.cuda.set_sync_debug_mode: its only host waits are the drains' event waits; launches {dict(l)}")

        # -- windowed ------------------------------------------------------------
        big = breadth_first_encode(perfect_tree(WINDOW_DEPTH, N_ATTRS, N_CLASSES, seed=3))
        check(big.n_nodes == 16_383, f"the windowed tree has {big.n_nodes} nodes")
        rec = torch.from_numpy(images[0]).to(dev)
        for jump_mode in ("gather", "onehot"):
            try:
                ops.tree_eval(rec, big, jump_mode=jump_mode)
            except K.TileError as e:
                refusal = str(e)
            else:
                fail(f"ops.tree_eval ran the {big.n_nodes}-node tree ({jump_mode}) on the card")
        t0 = time.perf_counter()
        want_big = eval_serial(big, images[0])
        serial_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out, ms = timed(lambda: eval_windowed(big, rec, window_levels=4))
        peak = torch.cuda.max_memory_allocated(dev) - base
        check(np.array_equal(out.cpu().numpy(), want_big), "eval_windowed != eval_serial on the 16,383-node tree")
        print(f"[forest-serve] {card}: eval_windowed (window 4 levels, widest band 12,288 nodes) on the {big.n_nodes}-node "
              f"perfect tree at A {N_ATTRS} over {rec.shape[0]} records equal to eval_serial ({serial_s:.1f} s on the host) "
              f"in {ms:.3f} ms (host clock, first call), peak memory {peak / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held; ops.tree_eval refuses the tree: {refusal}")
    print(f"[forest-serve] phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return parts


# ---------------------------------------------------------------------------
# phase 7: timing at the main-path shapes
# ---------------------------------------------------------------------------


def event_ms(fn, n_bufs: int, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(i)`` over ``iters`` calls."""
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(runs, n_bufs: int, iters: int) -> dict[str, tuple[float, int]]:
    """Mean device time of the kernel that each ``fn(i)`` of ``runs`` launches, by label.

    ``runs`` is a list of (label, fn); a label may come back (turns), and each
    call launches one kernel.  A fill of a one-element tensor follows each
    run as a marker, so the device's kernels, in the order they ran, split
    into the runs in the order they were made (two labels may launch
    kernels of one name, and a kernel the profiler loses shortens its run
    only).  Timed with the profiler because a wrapper call costs the host
    more than these kernels cost the card, so events around back-to-back
    calls would time the host; in one profiler session, because a process's
    later sessions can lose kernels.  Returns {label: (mean ms, kernels
    seen)}; fails the run unless every run and marker was seen, and unless
    each run is kernels of one name, at most ``iters`` of them and more than
    half (the profiler loses a few: 2 of 200 once on the H100), so that the
    mean per kernel is the mean per call: a second kernel a call (a copy, a
    memset, a second launch) would otherwise divide it unseen.
    """
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    for _, fn in runs:
        for i in range(3):
            fn(i % n_bufs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, fn in runs:
            for i in range(iters):
                fn(i % n_bufs)
            marker.fill_(0)
        torch.cuda.synchronize()
    blocks, block = [], []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "Fill" in e.key:
            blocks.append(block)
            block = []
        else:
            block.append(e)
    check(len(blocks) == len(runs) and all(blocks),
          f"the profiler saw {[len(b) for b in blocks]} kernels between markers for {len(runs)} runs")
    for (label, _), block in zip(runs, blocks):
        names = {e.key for e in block}
        check(len(names) == 1 and iters // 2 < len(block) <= iters,
              f"{label}: {len(block)} kernels named {sorted(names)} for {iters} calls of one kernel each")
    total: dict = {}
    for (label, _), block in zip(runs, blocks):
        us, n = total.get(label, (0.0, 0))
        total[label] = (us + sum(e.time_range.elapsed_us() for e in block), n + len(block))
    return {label: (us / 1e3 / n, n) for label, (us, n) in total.items()}


def bound(m: int, a: int, t: int, n: int, compares: int, out_bytes: int | None = None,
          table_bytes: int | None = None) -> tuple[float, str]:
    """Least time the card could take to classify ``m`` records by ``t`` trees.

    Every mode of one shape computes the same function, so each gets the same
    bound: ``launch.roofline.tree_eval_cost`` (records and the four node
    tables read once, the output written once — the (t, m) classes, or
    ``out_bytes``, the vote kernels' (m, C) counts — and the ``compares``
    this run's records need, one per level each descends) over the H100's
    peaks (``roofline.bound_ms``), the formula the tuner prices candidates
    with.  ``table_bytes`` counts the four tables at their stored widths
    (K7/K8); default 4 bytes a node each.
    """
    cost = roofline.tree_eval_cost(m, a, t, n, compares, out_bytes=out_bytes, table_bytes=table_bytes)
    return roofline.bound_ms(cost["bytes"], cost["ops"])


def phase_timing(dev, image, enc, forest, depth_sum_tree, depth_sum_forest, card):
    rec = torch.from_numpy(image).to(dev)
    # Enough distinct record buffers to overflow L2, so each launch reads
    # its records from device memory as a fresh image would be.
    n_bufs = L2_BYTES // rec.nbytes + 2
    raw = [rec.clone() for _ in range(n_bufs)]
    clean = [sanitize_records(r) for r in raw]
    tree = ops.PackedTree(enc, N_ATTRS, device=dev)
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    m, a = rec.shape
    rows, runs = [], []
    for fused, tabs, depth_sum in ((False, tree, depth_sum_tree), (True, packed, depth_sum_forest)):
        t = packed.n_trees if fused else 1
        n = tabs.n_nodes
        for algorithm, jump_mode in MODES:
            bufs = clean if algorithm == "speculative" else raw
            bm = ops.choose_block_m(n, a, algorithm=algorithm, jump_mode=jump_mode)
            if algorithm == "speculative":
                def run(i, bm=bm, bufs=bufs, jump_mode=jump_mode, fused=fused, tabs=tabs):
                    return run_speculative(fused, bufs[i], tabs, jump_mode, bm)

                def plain(i, bufs=bufs, jump_mode=jump_mode, fused=fused, tabs=tabs):
                    return run_speculative(fused, bufs[i], tabs, jump_mode)
            else:
                def run(i, bm=bm, bufs=bufs, fused=fused, tabs=tabs):
                    return run_data_parallel(fused, bufs[i], tabs, bm)

                def plain(i, bufs=bufs, fused=fused, tabs=tabs):
                    return run_data_parallel(fused, bufs[i], tabs)
            name = kernel_name(fused, algorithm, jump_mode)
            got, want = run(0), plain(0)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} != plain on the main-path inputs")
            bound_ms, bound_by = bound(m, a, t, n, depth_sum)
            how = f"; {launch_shape(name, m, n, a, bm, 0, t)}"
            runs.append((name, run))
            rows.append(dict(name=name, call_ms=event_ms(run, n_bufs, iters=200),
                             plain_ms=event_ms(plain, n_bufs, iters=10, warmup=1), bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=max_abs_err(got, want),
                             shape=f"M={m} N={n} T={t} block_m={bm}", how=how))
    times = profiled_ms(runs, n_bufs, iters=200)
    for row in rows:
        row["ms"], n_events = times[row["name"]]
        print(f"[timing] {card}: {row['name']:25s} {row.pop('shape')}: kernel {row['ms']:.4f} ms "
              f"(profiler, {n_events} launches; {row.pop('call_ms'):.4f} ms per wrapper call by events), "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"kernel at {row['bound_ms'] / row['ms']:.1%} of bound{row.pop('how')}")
    return rows


def phase_vote_timing(dev, image, forest, plan, depth_sums, second, card):
    """K5 and K6 at the cascade's first-stage shape, at the whole forest, and
    at its second stage (``second``: the records that survive the first)."""
    rows = []
    for label, img, ids in (("first stage", image, plan.stage_trees(0)),
                            ("whole forest", image, tuple(range(forest.n_trees))),
                            ("second stage", second, plan.stage_trees(1))):
        rec = torch.from_numpy(img).to(dev)
        n_bufs = L2_BYTES // rec.nbytes + 2
        raw = [rec.clone() for _ in range(n_bufs)]
        clean = [sanitize_records(r) for r in raw]
        m, a = rec.shape
        sums = depth_sums if img is image else {i: int(observed_depths(forest.tree(i), img).sum()) for i in ids}
        # The cascade packs a stage with the whole forest's depth, as here.
        tabs = ops.PackedForest(EncodedForest([forest.tree(i) for i in ids]), N_ATTRS,
                                max_depth=forest.max_depth, device=dev)
        t, n = tabs.n_trees, tabs.n_nodes
        runs, lines = [], []
        for algorithm, jump_mode in MODES:
            bufs = clean if algorithm == "speculative" else raw
            bm = ops.choose_block_m(n, a, algorithm=algorithm, jump_mode=jump_mode, n_classes=N_CLASSES)

            def run(i, bm=bm, bufs=bufs, algorithm=algorithm, jump_mode=jump_mode):
                return run_votes(algorithm, jump_mode, bufs[i], tabs, N_CLASSES, bm)

            def plain(i, bufs=bufs, algorithm=algorithm, jump_mode=jump_mode):
                return run_votes(algorithm, jump_mode, bufs[i], tabs, N_CLASSES)

            name = votes_name(algorithm, jump_mode)
            got, want = run(0), plain(0)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} != plain on the {label} inputs")
            bound_ms, bound_by = bound(m, a, t, n, sum(sums[i] for i in ids), out_bytes=m * N_CLASSES * 4)
            how = f"; {launch_shape(name, m, n, a, bm, N_CLASSES, t)}"
            runs.append((name, run))
            lines.append(dict(name=name, plain_ms=event_ms(plain, n_bufs, iters=10, warmup=1),
                              bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs_err(got, want),
                              shape=f"M={m} N={n} T={t} C={N_CLASSES} block_m={bm}", how=how))
        times = profiled_ms(runs, n_bufs, iters=200)
        for row in lines:
            row["ms"], n_events = times[row["name"]]
            print(f"[timing] {card}: {row['name']:32s} {label}: {row.pop('shape')}: kernel {row['ms']:.4f} ms "
                  f"(profiler, {n_events} launches), plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}), kernel at {row['bound_ms'] / row['ms']:.1%} "
                  f"of bound{row.pop('how')}")
        if label == "first stage":
            rows += lines
    return rows


def phase_quant_timing(dev, image, layouts, rows, card):
    """K7 and K8 at the main-path shape in each threshold storage, beside
    K3 gather and K4 (``rows``, timed on the same forest earlier in this run)."""
    rec = torch.from_numpy(image).to(dev)
    n_bufs = L2_BYTES // rec.nbytes + 2
    raw = [rec.clone() for _ in range(n_bufs)]
    m, a = rec.shape
    beside = {r["name"]: r["ms"] for r in rows}
    out, runs = [], []
    for storage, q in timed_layouts(layouts).items():
        tree_depths = [int(observed_depths(EncodedForest.from_arrays(*host_tables(q)).tree(t), image).sum())
                       for t in range(q.n_trees)]
        table_bytes = sum(x.numel() * x.element_size() for x in (q.attr_idx, q.threshold, q.child, q.class_val))
        for algorithm, yardstick in (("speculative", "fused_speculative/gather"),
                                     ("data_parallel", "fused_data_parallel")):
            bm = ops.choose_block_m(q.n_nodes, a, algorithm=algorithm)

            def run(i, bm=bm, q=q, algorithm=algorithm):
                return run_quant(algorithm, raw[i], q, block_m=bm)

            def plain(i, q=q, algorithm=algorithm):
                return run_quant(algorithm, raw[i], q)

            name = quant_name(algorithm, storage)
            got, want = run(0), plain(0)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{name} != plain on the main-path inputs")
            bound_ms, bound_by = bound(m, a, q.n_trees, q.n_nodes, sum(tree_depths), table_bytes=table_bytes)
            how = f"; {launch_shape(name, m, q.n_nodes, a, bm, 0, q.n_trees)}"
            runs.append((name, run))
            out.append(dict(name=name, plain_ms=event_ms(plain, n_bufs, iters=10, warmup=1), bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=max_abs_err(got, want), yardstick=yardstick,
                            shape=f"M={m} N={q.n_nodes} T={q.n_trees} block_m={bm} tables {table_bytes} B",
                            how=how))
    times = profiled_ms(runs, n_bufs, iters=200)
    for row in out:
        row["ms"], n_events = times[row["name"]]
        yardstick = row.pop("yardstick")
        print(f"[timing] {card}: {row['name']:30s} {row.pop('shape')}: kernel {row['ms']:.4f} ms (profiler, "
              f"{n_events} launches; {yardstick} {beside[yardstick]:.4f} ms in this run), plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), kernel at "
              f"{row['bound_ms'] / row['ms']:.1%} of bound{row.pop('how')}")
    return out


def bfs_forest(n_nodes: int, n_trees: int, seed: int) -> EncodedForest:
    """Random breadth-first trees of exactly ``n_nodes`` nodes (unreachable
    self-looping leaves pad one that stops short; tree 0 splits every node)."""
    rng = np.random.default_rng(seed)
    attr = np.zeros((n_trees, n_nodes), np.int32)
    thr = np.full((n_trees, n_nodes), np.inf, np.float32)
    child = np.tile(np.arange(n_nodes, dtype=np.int32), (n_trees, 1))
    cls = rng.integers(0, N_CLASSES, (n_trees, n_nodes)).astype(np.int32)
    for t in range(n_trees):
        queue, nxt = [0], 1
        while queue and nxt + 2 <= n_nodes:
            node = queue.pop(0)
            if t and rng.random() < 0.2:
                continue
            attr[t, node], thr[t, node] = rng.integers(0, N_ATTRS), rng.normal()
            child[t, node], cls[t, node] = nxt, BOTTOM
            queue += [nxt, nxt + 1]
            nxt += 2
    return EncodedForest.from_arrays(attr, thr, child, cls)


def phase_cutoff(dev, image, card) -> None:
    """K3 at M 65,536 and T 16 on random forests of N on both sides of the jump
    paths' cut-offs: device time per (record, tree) and per node slot a lane.
    One profiler session per group of N whose instantiations differ."""
    rec = torch.from_numpy(image).to(dev)
    n_bufs = L2_BYTES // rec.nbytes + 2
    raw = [rec.clone() for _ in range(n_bufs)]
    clean = [sanitize_records(r) for r in raw]
    m, a = rec.shape
    for group in ((32, 33, 65), (64, 96), (128,)):
        runs, lines = [], []
        for n in group:
            tabs = ops.PackedForest(bfs_forest(n, N_TREES, seed=n), N_ATTRS, device=dev)
            for jump_mode, bufs in (("gather", raw), ("onehot", clean)):
                bm = ops.choose_block_m(n, a, jump_mode=jump_mode)

                def run(i, bm=bm, bufs=bufs, jump_mode=jump_mode, tabs=tabs):
                    return run_speculative(True, bufs[i], tabs, jump_mode, bm)

                name = f"fused_speculative/{jump_mode}"
                check(torch.equal(run(0), run_speculative(True, bufs[0], tabs, jump_mode)),
                      f"{name} != plain at N={n}")
                runs.append(((n, jump_mode), run))
                lines.append(((n, jump_mode), f"{name:24s} M={m} T={N_TREES} N={n} depth {tabs.max_depth} "
                              f"jumps {ops._total_jumps(tabs.max_depth)}", launch_shape(name, m, n, a, bm, 0, N_TREES)))
        times = profiled_ms(runs, n_bufs, iters=100)
        for key, text, how in lines:
            ms = times[key][0]
            per = ms * 1e6 / (m * N_TREES)
            print(f"[cutoff] {card}: {text}: kernel {ms:.4f} ms, {per:.3f} ns a (record, tree), "
                  f"{per / -(-key[0] // 32):.3f} ns a node slot; {how}")


def load_parent(root: Path):
    """The kernel and ops modules of the checkout at ``root``, loaded beside
    this tree's: its ops module is bound to its own kernel module, and both
    use this tree's unchanged helpers (core, build, reference)."""
    base = root / "src" / "repro_torch" / "kernels" / "tree_eval"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module

    pk = load("parent_tree_eval_kernel", base / "kernel.py")
    package = sys.modules["repro_torch.kernels.tree_eval"]
    saved = package.kernel
    package.kernel = pk
    try:
        po = load("parent_tree_eval_ops", base / "ops.py")
    finally:
        package.kernel = saved
    return pk, po


def phase_parent(dev, image, enc, forest, plan, second, layouts, root: Path, card) -> None:
    """The kernels of the checkout at ``root`` against this tree's on phase
    7's inputs, timed in turns: parent, this, this, parent (profiler device
    time, record buffers rotated past L2).  Speculative: K1, K3, K5 (both
    forms) and K7 (three storages); data-parallel: K2, K4, K6 at the
    cascade's first stage, at the whole forest and at its second stage (on
    ``second``, the records that survive the first), and K8 (three
    storages).  The parent's tile is its own ``choose_block_m``'s."""
    pk, po = load_parent(root)
    bufs = {}
    for key, img in (("image", image), ("second", second)):
        rec = torch.from_numpy(img).to(dev)
        n_bufs = L2_BYTES // rec.nbytes + 2   # each set overflows L2 on its own
        bufs[key, "raw"] = [rec.clone() for _ in range(n_bufs)]
        bufs[key, "clean"] = [sanitize_records(r) for r in bufs[key, "raw"]]
    a = image.shape[1]
    tree = ops.PackedTree(enc, N_ATTRS, device=dev)
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)

    def stage(s):
        return ops.PackedForest(EncodedForest([forest.tree(i) for i in plan.stage_trees(s)]), N_ATTRS,
                                max_depth=forest.max_depth, device=dev)

    first, last = stage(0), stage(1)
    cases = []   # (name, record buffers, tables, kwargs, wrapper, this block_m, parent block_m, C, T)

    def add(name, recs, args, kw, fn, n, c, t, algorithm="speculative", jump_mode="gather"):
        sizes = dict(algorithm=algorithm, jump_mode=jump_mode, n_classes=c)
        cases.append((name, recs, args, kw, fn, ops.choose_block_m(n, a, **sizes),
                      po.choose_block_m(n, a, **sizes), c, t))

    for jump_mode in ("gather", "onehot"):
        recs = bufs["image", "clean" if jump_mode == "onehot" else "raw"]
        for fn, tabs, c in (("speculative", tree, 0), ("fused_speculative", packed, 0),
                            ("fused_votes_speculative", first, N_CLASSES)):
            args = (tabs.attr_idx, tabs.attr_select, tabs.threshold, tabs.child, tabs.class_val)
            kw = dict(total_jumps=ops._total_jumps(tabs.max_depth), jump_mode=jump_mode)
            if c:
                kw["n_classes"] = c
            add(f"{fn}/{jump_mode}", recs, args, kw, fn, tabs.n_nodes, c, getattr(tabs, "n_trees", 1),
                jump_mode=jump_mode)
    raw = bufs["image", "raw"]
    for label, fn, tabs, c, recs in (("data_parallel", "data_parallel", tree, 0, raw),
                                     ("fused_data_parallel", "fused_data_parallel", packed, 0, raw),
                                     ("fused_votes_data_parallel first stage", "fused_votes_data_parallel",
                                      first, N_CLASSES, raw),
                                     ("fused_votes_data_parallel whole forest", "fused_votes_data_parallel",
                                      packed, N_CLASSES, raw),
                                     ("fused_votes_data_parallel second stage", "fused_votes_data_parallel",
                                      last, N_CLASSES, bufs["second", "raw"])):
        kw = dict(max_depth=tabs.max_depth) | ({"n_classes": c} if c else {})
        add(label, recs, (tabs.attr_idx, tabs.threshold, tabs.child, tabs.class_val), kw, fn, tabs.n_nodes,
            c, getattr(tabs, "n_trees", 1), algorithm="data_parallel")
    for storage, q in timed_layouts(layouts).items():
        args = (q.attr_idx, q.threshold, q.child, q.class_val)
        add(f"fused_speculative_q/{storage}", raw, args, dict(total_jumps=ops._total_jumps(q.max_depth)),
            "fused_speculative_q", q.n_nodes, 0, q.n_trees)
        add(f"fused_data_parallel_q/{storage}", raw, args, dict(max_depth=q.max_depth),
            "fused_data_parallel_q", q.n_nodes, 0, q.n_trees, algorithm="data_parallel")
    runs, lines = [], []
    for name, recs, args, kw, fn, bm, parent_bm, c, t in cases:
        this = lambda i, fn=fn, recs=recs, args=args, kw=kw, bm=bm: getattr(K, fn)(
            recs[i % len(recs)], *args, block_m=bm, **kw)
        parent = lambda i, fn=fn, recs=recs, args=args, kw=kw, bm=parent_bm: getattr(pk, fn)(
            recs[i % len(recs)], *args, block_m=bm, **kw)
        check(torch.equal(this(0), parent(0)), f"{name}: this tree's kernel and the parent's disagree")
        runs += [((name, "parent"), parent), ((name, "this"), this), ((name, "this"), this),
                 ((name, "parent"), parent)]
        m, n = recs[0].shape[0], args[0].shape[-1]
        shape = f"M={m} N={n} T={t}" + (f" C={c}" if c else "")
        key = name.split(" ")[0]
        grid = launch_shape(key, m, n, a, bm, c, t)
        kernel, variant, jump_mode = kernel_id(key)
        if kernel % 2 == 0:
            if hasattr(pk, "launch_grid"):
                parent_grid = pk.launch_grid(kernel, variant, m, parent_bm, a, n, jump_mode, c, t)[0]
            else:   # a checkout without launch_grid launches one data-parallel CTA per tile
                parent_grid = -(-m // parent_bm)
            grid += f"; parent grid {parent_grid} CTAs"
        lines.append((name, shape, bm, parent_bm, grid))
    times = profiled_ms(runs, max(len(b) for b in bufs.values()), iters=100)
    for name, shape, bm, parent_bm, grid in lines:
        p_ms, t_ms = times[(name, "parent")][0], times[(name, "this")][0]
        print(f"[parent] {card}: {name:40s} {shape}: parent {p_ms:.4f} ms (block_m {parent_bm}), "
              f"this tree {t_ms:.4f} ms (block_m {bm}); parent / this {p_ms / t_ms:.2f}x "
              f"(profiler, 200 launches each in turns parent, this, this, parent); outputs equal; {grid}")


def phase_breakdown(dev, image, enc, forest, plan, card) -> None:
    """Where one image's service time goes: host wall vs device busy, by kernel.

    One call each of the tree (K1 gather), the forest (K3 gather + vote) and
    the cascade (2 stages of K5 gather, bound 1.0) path, from numpy on the
    host to classes on the host, under the profiler (which slows the host
    side; the device times stand).  For the cascade also the host ops that
    cost most, and, from one call without the profiler, its own spans.
    """
    from torch.profiler import ProfilerActivity, profile

    tree = ops.PackedTree(enc, N_ATTRS, device=dev)
    packed = ops.PackedForest(forest, N_ATTRS, device=dev)
    ev = cascade_evaluator(dev, forest, plan, 1.0, "speculative", "gather")
    calls = {
        "tree": lambda: ops.tree_eval(torch.from_numpy(image).to(dev), tree).cpu(),
        "forest": lambda: majority_vote(
            ops.forest_eval_fused(torch.from_numpy(image).to(dev), packed), N_CLASSES).cpu(),
        "cascade": lambda: ev(torch.from_numpy(image).to(dev)).classes.cpu(),
    }
    for label, call in calls.items():
        timed(call)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(call)
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        parts = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}"
                          for e in sorted(events, key=lambda e: -e.self_device_time_total))
        print(f"[breakdown] {card}: {label} speculative/gather, one image: host wall {wall:.3f} ms, "
              f"device busy {busy:.4f} ms, idle share {1 - busy / wall:.1%}; {parts}")
        if label == "cascade":
            host = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
                          key=lambda e: -e.self_cpu_time_total)[:12]
            print(f"[breakdown] {card}: cascade host ops by self CPU time: " + "; ".join(
                f"{e.key} {e.self_cpu_time_total / 1e3:.4f} ms x{e.count}" for e in host))
    ev.tracer = obs.Tracer()
    _, wall = timed(calls["cascade"])
    spans = "; ".join(f"{e.name}" + "".join(f" {k}={e.args[k]}" for k in ("stage", "phase") if k in e.args)
                      + f" {e.dur_us / 1e3:.4f} ms" for e in ev.tracer.events())
    print(f"[breakdown] {card}: cascade spans, one image without the profiler: host wall {wall:.3f} ms; {spans}")


# ---------------------------------------------------------------------------


REPLACES = {
    "speculative": "src/repro/kernels/tree_eval/kernel.py:137",
    "data_parallel": "src/repro/kernels/tree_eval/kernel.py:219",
    "fused_speculative": "src/repro/kernels/tree_eval/kernel.py:285",
    "fused_data_parallel": "src/repro/kernels/tree_eval/kernel.py:618",
    "fused_votes_speculative": "src/repro/kernels/tree_eval/kernel.py:373",
    "fused_votes_data_parallel": "src/repro/kernels/tree_eval/kernel.py:431",
    "fused_speculative_q": "src/repro/kernels/tree_eval/kernel.py:564",
    "fused_data_parallel_q": "src/repro/kernels/tree_eval/kernel.py:581",
}


def ptxas_lines(report: str) -> list[str]:
    """Registers, shared memory and spills of each kernel in an ``-Xptxas -v``
    report, with the kernel names demangled where a demangler is installed."""
    lines = [line.strip() for line in report.splitlines()
             if "registers" in line or "Compiling entry" in line or "spill" in line]
    demangler = shutil.which("cu++filt") or shutil.which("c++filt")
    if demangler:
        out = subprocess.run([demangler], input="\n".join(lines), capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(lines):
            return out.stdout.splitlines()
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, nargs="+", default=[],
                        help="earlier checkouts whose kernels to time in turns with this tree's, one after another")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.ptxas_report(K.SOURCE)
    print(f"[build] {_build.library_path(K.SOURCE).name} in {time.perf_counter() - t0:.1f} s on the host of {card}")
    for line in ptxas_lines(report):
        print(f"[build] {line}")

    errs = phase_kernels(dev)
    errs |= phase_quant_kernels(dev)
    for name, err in phase_subnormal(dev).items():
        errs[name] = max(errs.get(name, 0), err)

    t0 = time.perf_counter()
    data = make_segmentation(seed=0)
    enc = breadth_first_encode(train_cart(
        data.x_train, data.y_train, N_CLASSES,
        CartConfig(max_depth=12, min_samples_split=8, min_gain=4e-3)))
    forest = bagged_forest(data)
    rows = np.concatenate([data.x_train, data.x_test])   # what the images are tiled from
    layouts = quant_layouts(forest, rows, dev)
    pairs = [replicated_dataset(data, M_IMAGE, seed=i + 1) for i in range(N_IMAGES)]
    images, labels = [p[0] for p in pairs], [p[1] for p in pairs]
    depths = observed_depths(enc, images[0])
    tree_depth_sums = [int(observed_depths(forest.tree(t), images[0]).sum()) for t in range(forest.n_trees)]
    forest_depths = sum(tree_depth_sums)
    print(f"[setup] CART tree N={enc.n_nodes} depth={tree_depth(enc)} "
          f"d_mu={mean_traversal_depth(depths):.3f}; forest T={forest.n_trees} "
          f"N={forest.n_nodes} depth={forest.max_depth} "
          f"d_mu={forest_depths / (forest.n_trees * M_IMAGE):.3f} ({time.perf_counter() - t0:.1f} s on host)")

    t0 = time.perf_counter()
    mix = skewed_mix(images[0])
    mix_per_tree = np.stack([eval_serial(forest.tree(t), mix) for t in range(forest.n_trees)])
    print(f"[setup] skewed 90/10 mix of image 0 and its per-tree eval_serial classes "
          f"({time.perf_counter() - t0:.1f} s on host)")

    K.reset_launches()
    lat, per_trees = phase_service(dev, images, labels, enc, forest)
    phase_quant_service(dev, images, forest, rows, per_trees, layouts)
    phase_quant_latency(dev, images, forest, layouts, card)
    phase_cascade(dev, images + [mix], per_trees + [mix_per_tree], forest, card)
    phase_cascade_latency(dev, images + [mix], forest, card)
    launches = dict(K.LAUNCHES)
    print(f"[service] main-path launches: {launches}")
    for key, ms in lat.items():
        steady = ms[1:]
        print(f"[service] {card}: {key:30s} per-image ms (H2D + eval + D2H, host clock): "
              f"first {ms[0]:.3f}, steady mean {np.mean(steady):.3f} min {min(steady):.3f} max {max(steady):.3f}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    K.reset_launches()
    serve_keys = phase_serve(dev, images, enc, forest, per_trees, card)
    serve_launches = dict(K.LAUNCHES)
    print(f"[serve] served-path launches: {serve_launches}")
    for name in sorted(serve_keys):
        check(serve_launches[name] > 0, f"kernel {name} of a measured candidate was not launched on the served path")
    launches = {name: count + serve_launches[name] for name, count in launches.items()}

    K.reset_launches()
    parts = phase_forest_serve(dev, images, forest, per_trees, card)
    forest_launches = dict(K.LAUNCHES)
    for part, counts in parts.items():
        print(f"[forest-serve] launches by {part}: {dict(sorted((k, v) for k, v in counts.items() if v))}")
    print(f"[forest-serve] forest-serve launches: {forest_launches}")
    for name in FOREST_PATH:
        check(forest_launches[name] > 0, f"kernel {name} was not launched on the forest-serve path")
    launches = {name: count + forest_launches[name] for name, count in launches.items()}

    plan = cascade_plan(dev, forest, images[0], 2, 1.0)
    phase_breakdown(dev, images[0], enc, forest, plan, card)
    timings = phase_timing(dev, images[0], enc, forest, int(depths.sum()), forest_depths, card)
    ref = cascade_ref_from_classes(per_trees[0], order=plan.order, stage_sizes=plan.stage_sizes,
                                   n_classes=N_CLASSES, bound=1.0)
    second = images[0][ref.exit_stage != 0]    # the records the first stage leaves to the second
    print(f"[setup] cascade 2 stages bound 1.0 on image 0: {len(second)} records reach stage 1 "
          f"({plan.stage_sizes[1]} trees)")
    timings += phase_vote_timing(dev, images[0], forest, plan, tree_depth_sums, second, card)
    timings += phase_quant_timing(dev, images[0], layouts, timings, card)
    phase_cutoff(dev, images[0], card)
    serve_tile_timing(dev, images[0], enc, card)
    for root in args.parent:
        print(f"[parent] {root}")
        phase_parent(dev, images[0], enc, forest, plan, second, layouts, root, card)
    check(len(timings) == len(K.LAUNCHES), f"timed {len(timings)} kernels, not {len(K.LAUNCHES)}")
    kernels = []
    for row in timings:
        wrapper = row["name"].split("/")[0]
        kernels.append({
            "name": row["name"],
            "route": "cuda",
            "source": "src/repro_torch/kernels/tree_eval/csrc/tree_eval.cu",
            "replaces": REPLACES[wrapper],
            "launches": launches[row["name"]],
            "max_abs_err": max(errs[row["name"]], row["max_abs_err"]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,   # no single PyTorch call evaluates a tree or a forest
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
