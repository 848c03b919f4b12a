"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and power limit; no CUDA device is an error;
2. build — compile ``csrc/tree_eval.cu`` for sm_90a with nvcc, print the
   ``-Xptxas -v`` report;
2l. lm-serve — the LM serving path, in a child process of its own
   (``chip_smoke.py --lm-serve``): ``build_model`` of granite-moe-3b-a800m at
   full width on the card (3,375,428,064 parameters + the vocabulary's
   padding, f32 masters from a seeded ``torch.Generator``), ``ServeEngine``
   (its bf16 working copy made once) serving 8 requests of 128 seeded ids,
   32 new tokens each, greedy, in 2 waves of 4: K1 onehot (the tree router,
   N 127, A 63) launched exactly 32 layers × (1 prefill + 31 decode steps) ×
   2 waves = 2,048 times in the served run's window; every route of the
   first prefill and of one decode step, captured by forward hooks on the
   ``TreeRouter`` modules, ``torch.equal`` to K1's plain version on the same
   ``z``; the f32 model on the same masters: last logits of ``prefill`` and
   of one ``decode_step`` (B 2, S 17) against ``forward(serve_hard_tree=
   True)`` within 2e-2 (the JAX smoke test's tolerance); prefill ms per
   wave, decode ms per step (host clock and CUDA events), tokens/s, one
   decode step under the profiler (device busy, idle share, time and
   launches by kind), K1 at the router's decode (M 4) and prefill (M 512)
   shapes against its plain version and bound, the step's byte bound;
2t. lm-train — the LM training path, in a child process of its own after
   2l (``chip_smoke.py --lm-train``; the two would not fit together):
   granite-moe-3b-a800m at full width (seed 0, remat "full"); remat
   "offload" against "full" on the same weights and first batch, in turns
   (full, offload, offload, full): the memory allocated right after the
   forward lower under "offload" by the 32 block inputs that go to pinned
   host memory (50,331,648 B, within 10%), the loss and every gradient
   within 1e-6 of each tensor's scale, forward + backward ms; its
   ``AdamWState`` (memory after each), ``train_loop`` for 6 steps of
   ``pipeline_for(cfg, ShapeConfig("train", 128, 4, "train"), seed=0)``
   (one 512-token MoE group a step, ``TrainConfig(lr=3e-4, warmup_steps=1,
   total_steps=6, ckpt_every=0)``): loss, grad norm, lr, step ms and
   tokens/s a step, peak memory; every number finite, step 0's loss equal
   to ``model.loss`` on batch 0 just before it within 1e-5, and the loss on
   batch 0 lower after the steps; one step under the profiler (device busy,
   idle share, launches, device time by kind: GEMMs, dispatch/combine
   einsums, MoE elementwise, attention, loss, optimizer); then, the
   optimizer state freed, the trained routers (stale until
   ``pack_routers``) serve one prefill and 4 decode steps: K1 onehot
   launched once a layer a step (160) and no other kernel, every route
   ``torch.equal`` to K1's plain version and to ``hard_tree_route`` with
   routers packed fresh from the trained thresholds; at the smoke width
   (f32) one train step on the card against the CPU port within 1e-5, and
   the fault-tolerant loop (checkpoints every 2 steps, a
   ``SimulatedFailure`` at step 3) replaying an uninterrupted run's losses
   within 1e-5;
2f. lm-families — the remaining LM families and the tree head, in a child
   process of its own after 2t (``chip_smoke.py --lm-families``), each
   model at full width (nothing cut; f32 masters from a generator seeded
   0; built, used and freed one after another): hymba-1.5b (hybrid:
   attention beside an SSM head, sliding window 1,024 with 3 global layers)
   through ``ServeEngine`` (8 requests of 128 seeded ids, 32 new tokens,
   greedy, ``max_batch`` 4), then a wave of 4 prompts of 1,280 ids (past
   the window; five 256-step SSM chunks), 8 new tokens; xlstm-125m
   (``XLSTMModel``) through ``ServeEngine``, 8 × 128, 32 new;
   whisper-medium (``EncDecModel``, which no engine serves) driven as the
   JAX package's tests drive it: ``prefill({"embeds", "tokens"})`` of 4
   requests (seeded frame embeddings (4, 1,500, 1,024) × 0.02, 16-token
   prompts), then 31 greedy ``decode_step``s; then ``tree_head_classify``
   with 7 classes (depth 3, N 15, A 7) over that prefill's encoder output
   (M 6,000 frame records), twice.  Gates: every served token in range;
   K1 onehot launched exactly once a tree-head call and no other kernel in
   the phase's window (from its start to the tree head); every class
   ``torch.equal`` to K1's plain version; the f32 model on the same
   masters (B 2, S 17): prefill's last logits within 2e-2 of the
   teacher-forced forward, and decode's, for all three (hymba's prefill
   restarts the SSM state, as JAX's does; the gap that makes stays within
   the gate at this init); each family's f32 smoke model on the card equal to the CPU port
   within 1e-4.  Printed for each model: parameters, peak memory, served
   prefill ms per wave and decode ms a step, tokens/s, steady prefill and
   decode ms (host clock and CUDA events), the decode step's byte bound,
   one decode step under the profiler (device busy, idle share, launches
   and time by kind); K1 at the tree head's shape against its plain
   version and bound;
2g. lm-families-train — the same three families trained, in a child process
   of its own after 2f (``chip_smoke.py --lm-families-train``), each at full
   width (f32 masters from a generator seeded 0, remat "full"; built,
   trained and freed one after another): hymba-1.5b first takes remat
   "offload" against "full" as 2t does (52,428,800 B of block inputs);
   then each its ``AdamWState`` and ``train_loop`` over
   ``pipeline_for(cfg, ShapeConfig("train", 128, 4, "train"), seed=0)``
   (``TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps,
   ckpt_every=0)``), 4 steps for hymba and xlstm-125m, 2 for
   whisper-medium at full width and 8 of its 24 + 24 layers (its encoder's
   attention runs 375 blocks a layer; the cut keeps the smoke's time): loss,
   grad norm, lr, step ms and tokens/s a step, peak memory; every number
   finite, step 0's loss equal to ``model.loss`` on batch 0 within 1e-5,
   the loss on batch 0 lower after the steps; for hymba and xLSTM one more
   step under the profiler (device busy, idle share, launches and device
   time by kind: GEMMs, the SSM's or the mLSTM's and sLSTM's elementwise
   work, attention, loss, optimizer; whisper's step, millions of kernels,
   is more than a profiler session keeps); then each family's smoke width
   (f32), one train step on the card against the CPU port, the model's
   part (loss, gradients) and AdamW's (on the card's gradients) each
   within 1e-5; no kernel of ours launches in the phase;
2d. lm-dist — the LM trained across the cards, in a child process of its
   own after 2g (``chip_smoke.py --lm-dist``) that spawns one process a card
   (NCCL through a ``FileStore``): a (data, model) mesh of 1×1 on one card,
   2×1 on two or three, 2×2 on four or more, and on four also 1×4.
   granite-moe-3b-a800m at full width in f32 (bf16 gradients would round
   once a shard, not once a batch), seed 0, built with the mesh's axes:
   rank 0 first takes the single-device step (``loss_and_grads``) on B 8 ×
   S 128 and frees it; then every rank builds the model on ``meta``, places
   it by its JAX specs (``distribute``), draws the same weights and takes
   one sharded step, split over ``model`` where it is above 1 (the
   sequence-parallel residual, vocab-sharded loss and expert-parallel MoE
   of ``parallel.sharding``; blocks gathering their dense weights just in
   time, gradients reduce-scattered, ZeRO-1 AdamW): loss within 1e-4
   relative of the reference's, every gradient within 1e-4 of its leaf's
   max-abs, AdamW on equal gradients within 1e-5 (ROADMAP §3 item 17; the
   whole step's difference is printed); each rank's parameter, gradient and
   moment bytes, its peak and the step's time, then a second (warm) step's,
   beside the unsplit step's (2×2 with the compute whole on each card); the stale
   routers raise, are packed from the gathered thresholds and route each
   rank's tokens (its sequence shard of its batch shard) on K1 onehot (a
   launch a layer a rank), every route ``torch.equal`` to its plain
   version.  On two cards or more, the bf16 witness on a mesh whose
   ``model`` axis is 1 (its premise): yi-6b at full width and 4 of its 32
   layers in its own bf16 activations, B 4 × S 128, the sharded step's
   loss and gradients within 1e-5 of the single-device step microbatched
   by the number of batch shards (each part's bf16 gradients summed in
   f32, as the shards' are), the whole-batch step's difference printed
   beside it, and 3 steps' losses of all three.  On four cards yi-6b at
   full width then trains 3 steps of B 4 × S 128 on a 2×2 mesh (losses
   finite, each card holding at most a quarter of the sharded leaves plus
   the replicated norms, peak under the card's memory; the gradients'
   bytes read inside each step); on fewer cards one line says what did not
   run;
2s. families-dist — hymba, xLSTM and whisper split over ``model``, in a
   child process after 2d (``chip_smoke.py --families-dist``) that spawns
   one process a card on four cards (on fewer one line says it did not
   run). hymba-1.5b and xlstm-125m at full width in f32 on a 2x2 and a 1x4
   mesh: rank 0's single-device step, then one split train step on the
   same weights (seed 0) and batch (B 8 x S 128): loss within 1e-4
   relative, every gradient within 1e-4 of its leaf's max-abs (the xLSTM:
   its split gradients within 1e-4, or twice the single-device f32 step's
   distance where that is more, of an f64 step rank 0 takes on the same
   weights: its exponential gates amplify the rounding a split reorders);
   each rank's bytes, peak and step time, a warm step's; then each served
   (``launch.specs.plan_cell``'s model, the size policy lifted so the
   xLSTM splits; its plan's line names the mLSTM's layout): prefill and a
   decode step counted, their collectives by kind equal to the fake mesh's
   plan, each rank's cache leaves its block
   of ``cache_specs``, and 8 greedy decode steps timed. whisper-medium at
   4 of its 24 + 24 layers with the same step gates, then its tree head on
   K1 onehot over each rank's rows of the encoder output, ``torch.equal``
   to K1's plain version and, gathered over 'data', to one card's K1 over
   the gathered frames (a launch a rank a mesh);
2r. dryrun — the dry-run (``repro_torch.launch.dryrun``: a fake process
   group, fake tensors, the step's ops counted by ``utils.op_cost``) held
   against the real steps.  Inside 2l, on the serving model (bf16 weights,
   ``launch.specs.serving_config``, seed 0): prefill B 4 x S 128 and one
   decode step of B 4 against a 160-deep cache; inside 2t, once the
   trained weights have been served, the train step of B 4 x S 128 on its
   model and AdamW state: each planned on a fake 1x1 mesh and run on the
   card under the counter, then once more uncounted (K1's launches read
   after both runs).
   Gates: the real step's FLOPs equal the plan's exactly, its K1 launches
   equal the plan's K1 ops, the plan's peak within 10% of
   ``max_memory_allocated`` (less what the process holds besides the step's
   arguments); printed: the roofline terms at the H100's peaks and the
   measured roofline fraction (model FLOPs at 989 TFLOP/s over the
   measured step), and where the bytes differ, by op.  Then its own child
   (``chip_smoke.py --dryrun``): ``python -m repro_torch.launch.dryrun
   --arch granite-moe-3b-a800m --shape decode_32k --mesh single`` in a
   process with its own time limit (its row and wall time); on four cards phi3.5-moe-42b-a6.6b
   at full width in bf16 on a 2x2 NCCL mesh, split over ``model`` (its 8 KV
   heads' cache by heads), B 8 x S 128 (whole 512-token MoE groups a batch
   shard) and 8 greedy decode steps: a card's parameter bytes equal to the
   fake 2x2 plan's, its cache bytes to JAX's ``cache_specs`` block, the
   prefill's and a decode step's collectives by kind equal to the plan's,
   their peaks within 10% of it, a decode step's all-gathers printed
   beside the unsplit step's 452; then phi at 4 of its 32 layers in f32 split on 2x2,
   its prefill and 8 decode steps' logits (fed the reference's greedy
   tokens) within 1e-4 of their max-abs of one card's run microbatched by
   the batch shards, the greedy tokens printed; and in bf16 on 4x1 (a
   ``model`` axis of 1), B 16, bit-equal to one card's microbatched run;
   on fewer cards one line says it did not run;
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
6m. margin — the cascade's margin pass (``csrc/cascade_margin.cu``, built and
   its ``-Xptxas -v`` report printed) at ``forest-frame``'s shape (M 65,536,
   C 7, 50 trees in stages of 26 + 24): the exit test of stage 0 and the
   finish, binning into a histogram's buffer on the card, on seeded tallies
   with ties, equal to their plain versions bit for bit (keep, exit stages,
   classes, margin, confidence; the histogram after 3 calls against
   ``observe_many`` of the plain margins); each kernel's device time
   (profiler, 200 launches, the tally warm in L2 as the cascade leaves it),
   its plain version's and ``torch.topk``'s (CUDA events), and its byte
   bound; then a 50-tree ``CascadeEvaluator`` on the card against the same
   evaluator on the CPU on 65,536 records (every field and the exit-margin
   histogram), two margin launches a call.  ``chip_smoke.py --margin`` runs
   this phase alone;
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
obs-smoke — after 6f, ``repro_torch.obs.smoke.main`` on the card (its
   ``ForestServeEngine`` on the card's default devices, metrics and tracing
   on): the Perfetto nesting ``serve.wave`` → ``stream.eval`` →
   ``kernel.dispatch``, the Prometheus text and JSON snapshot, the
   duplicate-metric guard, a flight bundle on a forced breach, the
   profiler's counter tracks; it must launch a forest kernel of ours (the
   one the engine's tuner resolves);
examples — then the five ``examples/*_torch.py`` with their default
   arguments, one after another, each in a child process of its own: every exit
   code 0 and each one's wall time, the quickstart's five EXACT MATCH lines
   (K1 and K2 among them), ``tree_router_moe`` routing on K1 onehot; the
   segmentation service's classifier on image 0 equal to ``eval_serial``;
8. the ``kernels`` JSON line (the margin kernels with ``replaces`` null: they
   replace no TPU kernel; their ``launches`` are phase 6's, in ``--margin``
   the 50-tree evaluator's, never the timing loops'), the card line, and
   the ``ok`` line.

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
anytime stages, shard bodies, the chunker), and in phase 2l's own window
over its served run, where K1 onehot must launch 2,048 times and no other
kernel (then the dry-run's serving cells, whose K1 launches must equal the
plan's K1 ops), in phase 2t's over the serve from the trained weights (160 K1
onehot launches), and in phase 2f's from its start to the tree head (2 K1
onehot launches, no other kernel), in phase 2g's (no launch), over
[obs-smoke] and in the children of [examples] (each child prints its own
counts).  The ``kernels`` line's ``launches`` is the sum of these windows.
Any mismatch, missing launch or exception exits non-zero.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import json
import math
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
    margin as MARGIN,
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
    """Stop the run: the reason on standard output, where the phases print,
    and on standard error, which a caller that keeps only the errors sees."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
# phase 6m: the cascade's margin pass
# ---------------------------------------------------------------------------

MARGIN_M, MARGIN_T, MARGIN_STAGES = 65_536, 50, (26, 24)   # forest-frame's frame, forest and plan
MARGIN_BOUNDARIES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)   # cascade.exit_margin's


def seeded_tally(m: int, c: int, t: int, seed: int) -> np.ndarray:
    """(m, c) int32 votes of ``t`` trees, most rows led by one class; an
    eighth tied at the top, an eighth unanimous."""
    rng = np.random.default_rng(seed)
    p = np.full((m, c), 1.0 / c)
    p[np.arange(m), rng.integers(0, c, m)] += rng.uniform(0.0, 6.0, m)
    votes = rng.multinomial(t, p / p.sum(1, keepdims=True)).astype(np.int32)
    k = m // 8
    votes[:k] = 0
    votes[:k, :2] = t // 2
    votes[k:2 * k] = 0
    votes[k:2 * k, c - 1] = t
    return votes


def margin_forest() -> EncodedForest:
    """50 trees in ``forest-frame``'s geometry: 25 vote one class whatever the
    record (the plan puts them first), 25 random, so about one record in
    seven exits after the first stage."""
    trees = [Node(class_val=2)] * 25 + [
        random_tree(n_attrs=N_ATTRS, n_classes=N_CLASSES, max_depth=6, seed=i) for i in range(25)]
    return EncodedForest([breadth_first_encode(t) for t in trees])


def phase_margin(dev, card) -> tuple[list[dict], dict]:
    """The margin kernels against their plain versions, timed; a whole
    evaluator on the card against the CPU's.  Returns the kernels' rows and
    the evaluator's margin launches."""
    t0 = time.perf_counter()
    report = _build.ptxas_report(MARGIN.SOURCE)
    print(f"[margin] build {_build.library_path(MARGIN.SOURCE).name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_lines(report):
        print(f"[margin] {line}")
    m, c, t_total = MARGIN_M, N_CLASSES, MARGIN_T
    first = MARGIN_STAGES[0]
    votes0 = torch.from_numpy(seeded_tally(m, c, first, seed=1)).to(dev)     # stage 0's tally
    votes = torch.from_numpy(seeded_tally(m, c, t_total, seed=2)).to(dev)    # the finish's
    alive = torch.arange(m, device=dev)
    thr = 1.0 * (t_total - first)
    trees = torch.where(torch.arange(m, device=dev) % 7 == 0, first, t_total).to(torch.int32)
    def histogram():
        return obs.Registry().histogram("cascade.exit_margin", boundaries=MARGIN_BOUNDARIES)

    stage_k, stage_p = (torch.full((m,), -1, dtype=torch.int32, device=dev) for _ in range(2))
    keep_k = MARGIN.exit_test(votes0, alive, 0, thr, stage_k)
    keep_p = MARGIN.exit_test_plain(votes0, alive, 0, thr, stage_p)
    hist_k, hist_p = histogram(), histogram()
    for _ in range(3):
        got = MARGIN.finish(votes, trees, t_total, hist_k)
        want = MARGIN.finish_plain(votes, trees, t_total)
        hist_p.observe_many(want[1].cpu().numpy())
    torch.cuda.synchronize()
    check(torch.equal(keep_k, keep_p) and torch.equal(stage_k, stage_p),
          "cascade_exit_test_kernel != plain at forest-frame's shape")
    for name, g, w in zip(("classes", "margin", "confidence"), got, want):
        check(g.dtype == w.dtype and torch.equal(g, w), f"cascade_finish_kernel {name} != plain")
    check(hist_k.state() == hist_p.state(), f"finish bins {hist_k.state()} != plain {hist_p.state()}")
    print(f"[margin] {card}: both kernels equal their plain versions at M={m} C={c}: "
          f"{int(keep_k.sum())} of {m} stay after stage 0 (threshold {thr}); bins after 3 calls "
          f"{hist_k.state()['bucket_counts']}")

    hist = histogram()
    n_exit = m - int(keep_k.sum())
    specs = [   # (name, kernel call, plain call, torch.topk call, bytes)
        ("cascade_exit_test_kernel",
         lambda i: MARGIN.exit_test(votes0, alive, 0, thr, stage_k),
         lambda i: MARGIN.exit_test_plain(votes0, alive, 0, thr, stage_p),
         lambda i: votes0.index_select(0, alive).topk(2, dim=1),
         m * c * 4 + m * 8 + m + n_exit * 4),
        ("cascade_finish_kernel",
         lambda i: MARGIN.finish(votes, trees, t_total, hist),
         lambda i: MARGIN.finish_plain(votes, trees, t_total),
         lambda i: votes.topk(2, dim=1),
         m * c * 4 + m * 4 + 3 * m * 4),
    ]
    times = profiled_ms([(name, run) for name, run, _, _, _ in specs], 1, iters=200)
    rows = []
    for name, run, plain, library, nbytes in specs:
        ms, n_events = times[name]
        bound_ms, bound_by = roofline.bound_ms(nbytes, m * c)
        row = dict(name=name, ms=ms, plain_ms=event_ms(plain, 1, iters=50),
                   library_ms=event_ms(library, 1, iters=50), bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=0)
        rows.append(row)
        print(f"[timing] {card}: {name:32s} M={m} C={c}: kernel {ms:.4f} ms (profiler, {n_events} "
              f"launches), plain {row['plain_ms']:.4f} ms, torch.topk {row['library_ms']:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}, {nbytes} B), kernel at {bound_ms / ms:.1%} of bound")

    forest = margin_forest()
    rec = np.random.default_rng(3).normal(size=(m, N_ATTRS)).astype(np.float32)
    plan = plan_cascade(forest, rec[:512], n_classes=N_CLASSES, stages=2, bound=1.0, device="cpu")
    check(plan.stage_sizes == MARGIN_STAGES, f"plan {plan.stage_sizes}, not {MARGIN_STAGES}")
    regs = [obs.Registry(), obs.Registry()]
    evs = [CascadeEvaluator(forest, plan, n_classes=N_CLASSES, bound=1.0, engine="cuda",
                            algorithm="data_parallel", registry=r, device=d)
           for r, d in zip(regs, (dev, "cpu"))]
    before = dict(MARGIN.LAUNCHES)
    for seed in range(2):
        batch = np.random.default_rng(10 + seed).normal(size=(m, N_ATTRS)).astype(np.float32)
        got, want = evs[0](torch.from_numpy(batch).to(dev)), evs[1](batch)
        for field in CASCADE_FIELDS:
            check(torch.equal(getattr(got, field).cpu(), getattr(want, field)),
                  f"cascade on the card: {field} != the CPU's")
        check(got.stage_survivors == want.stage_survivors, "cascade on the card: survivors != the CPU's")
    launched = {k: MARGIN.LAUNCHES[k] - before[k] for k in before}
    check(launched == {"exit_test": 2, "finish": 2}, f"margin launches {launched} for 2 calls")
    hist = [obs.snapshot(r)["histograms"]["cascade.exit_margin"] for r in regs]
    check(hist[0] == hist[1], f"exit-margin histogram on the card {hist[0]} != the CPU's {hist[1]}")
    print(f"[margin] {card}: 50-tree cascade on the card equals the CPU's on 2 x {m} records "
          f"(survivors {got.stage_survivors}), margin launches {launched}, exit_margin count "
          f"{hist[0]['count']} p50 {hist[0]['p50']}")
    return rows, launched


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
# phase 2l: the LM serving path (build_model → DecoderModel → MoE on K1 → ServeEngine)
# ---------------------------------------------------------------------------


LM_ARCH = "granite-moe-3b-a800m"
LM_PARAMS = 3_375_428_064        # cfg.n_params() of granite-moe-3b-a800m
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_BATCH = 8, 128, 32, 4
LM_DECODE_TIMED = 16
LM_TOL = 2e-2                    # tests/test_arch_smoke.py::test_smoke_prefill_decode_consistency
LM_RESULT = "[lm-serve] result "
LM_TIMEOUT_S = 600
DISPATCH_EQS = ("ngec,ngd->necd", "ngec,necd->ngd")
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::matmul", "aten::linear")


def lm_dropped(experts: torch.Tensor, moe, e_pad: int) -> tuple[int, int]:
    """(assignments dropped past the experts' capacity, assignments) of one
    MoE call whose tree routed its (n, g) tokens to ``experts``: each token
    takes its expert and the k − 1 next ones, an expert keeps ``_capacity``."""
    from repro_torch.models.layers import moe as lm_moe

    n, g = experts.shape
    cap = lm_moe._capacity(g, moe, e_pad)
    top = (experts.long()[..., None] + torch.arange(moe.top_k, device=experts.device)) % moe.n_experts
    counts = torch.stack([torch.bincount(t.reshape(-1), minlength=e_pad) for t in top])
    return int((counts - cap).clamp(min=0).sum()), n * g * moe.top_k


def lm_profiled_kinds(step, ranges, range_kinds: dict | None = None) -> tuple[float, list, dict]:
    """``step()`` once to warm up, then once under the profiler (CPU and CUDA), with
    a ``record_function`` range opened around each function of ``ranges``
    ((module, attribute, label or label(*args))) for that step only.
    ``range_kinds`` (label → kind) names the kind of a kernel launched
    inside such a range that no earlier rule places (the SSM's and the
    xLSTM's elementwise work).

    Returns (host wall ms, the device events, {kind: (ms, kernels)}).  K1 is
    told by its kernel name; every other kernel by the op that launched it
    (the profiler attaches a kernel to its launching op) and the ranges
    around that op; a kernel of the backward pass also by the ranges around
    the forward op its autograd node came from (matched by sequence number
    and thread).  The ranges' own mirrors on the device timeline are not
    device work and are left out.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label, fn):
        def run(*args, **kw):
            name = label(*args) if callable(label) else label
            with record_function(name):
                return fn(*args, **kw)
        return run

    step()
    torch.cuda.synchronize()
    real = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in ranges]
    for (mod, attr, fn), (_, _, label) in zip(real, ranges):
        setattr(mod, attr, ranged(label, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, fn in real:
            setattr(mod, attr, fn)
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and not e.key.startswith("lm.")]
    check(len(device) > 0, "the profiler saw no device event in the profiled step")
    k1 = [e for e in device if "speculative_kernel" in e.key]
    kinds = {"K1": (sum(e.time_range.elapsed_us() for e in k1) / 1e3, len(k1))}
    forward = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.sequence_nr >= 0 \
                and not e.name.startswith("autograd::engine"):
            forward.setdefault((e.thread, e.sequence_nr), e)

    def chain(node):
        nodes = []
        while node is not None:
            nodes.append(node)
            node = node.cpu_parent
        return nodes

    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        nodes = chain(e)
        grad = next((n for n in nodes if n.name.startswith("autograd::engine::evaluate_function")), None)
        # a kernel inside a range is forward work (a recompute in the backward
        # pass too); one outside every range belongs to its autograd node
        if not any(n.name.startswith("lm.") for n in nodes) and grad is not None \
                and (grad.fwd_thread, grad.sequence_nr) in forward:
            nodes += chain(forward[(grad.fwd_thread, grad.sequence_nr)])
        labels = [n.name for n in nodes]
        for kern in e.kernels:
            if "speculative_kernel" in kern.name:
                continue
            if "lm.attention" in labels:
                kind = "attention"
            elif any(f"lm.einsum {eq}" in labels for eq in DISPATCH_EQS):
                kind = "dispatch/combine einsums"
            elif e.name in GEMM_OPS:
                kind = "GEMMs"
            elif "Memcpy" in kern.name or "Memset" in kern.name:
                kind = "copies"
            elif "lm.optimizer" in labels:
                kind = "optimizer (AdamW, clipping)"
            elif "lm.loss" in labels:
                kind = "loss (masked softmax, gold logit, sums)"
            elif any(label in labels for label in range_kinds or {}):
                kind = next(k for label, k in range_kinds.items() if label in labels)
            elif "lm.moe" in labels:
                kind = "elementwise in the MoE (routing, dispatch/combine build)"
            else:
                kind = "elementwise outside the MoE"
            ms, n = kinds.get(kind, (0.0, 0))
            kinds[kind] = (ms + kern.duration / 1e3, n + 1)
    return wall, device, kinds


def kinds_line(wall: float, device: list, kinds: dict) -> str:
    busy = union_length([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    total = sum(e.time_range.elapsed_us() for e in device) / 1e3
    seen = sum(n for _, n in kinds.values())
    parts = "; ".join(f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]))
    return (f"host wall {wall:.3f} ms, device busy {busy:.4f} ms, idle share {1 - busy / wall:.1%}; "
            f"{len(device)} device events (launches) a step, {total:.4f} ms of device time; by kind: {parts} "
            f"({seen} kernels placed by the op that launched them)")


def lm_step_breakdown(step, card) -> None:
    """One decode step under the profiler (:func:`lm_profiled_kinds`), with
    ranges around ``attention._grouped_attention`` (attention),
    ``moe.moe_apply`` (the MoE layer) and ``torch.einsum`` (the dispatch and
    combine einsums by their equations)."""
    from repro_torch.models.layers import attention as lm_attn
    from repro_torch.models.layers import moe as lm_moe

    wall, device, kinds = lm_profiled_kinds(step, [
        (torch, "einsum", lambda eq, *_: f"lm.einsum {eq}"),
        (lm_attn, "_grouped_attention", "lm.attention"),
        (lm_moe, "moe_apply", "lm.moe")])
    print(f"[lm-serve] {card}: one decode step (B {LM_BATCH}) under the profiler: {kinds_line(wall, device, kinds)}")


def phase_lm_serve(dev, card, cfg=None) -> dict:
    """The LM serving path at granite-moe-3b-a800m's full width; see the
    module docstring (phase 2l).  Returns what the parent needs: K1 onehot's
    launches in the served run's window, and the largest disagreement of a
    captured route with K1's plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = cfg or get_config(LM_ARCH)
    moe, depth = cfg.moe, cfg.moe.tree_depth()
    n_int, n_nodes = 2**depth - 1, 2 ** (depth + 1) - 1
    gib = 2.0**30

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    built = sum(p.numel() for p in model.parameters())
    pad = (model.v_pad - cfg.vocab_size) * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    print(f"[lm-serve] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, {moe.n_experts} experts top-{moe.top_k} d_ff {moe.d_ff}, "
          f"router tree depth {depth} (N {n_nodes}, A {n_int}); {built:,} parameters allocated = "
          f"cfg.n_params() {cfg.n_params():,} + {pad:,} of vocabulary padding ({cfg.vocab_size:,} → "
          f"{model.v_pad:,}); f32 masters drawn from a seeded torch.Generator on the card in {built_s:.1f} s")
    check(built - pad == cfg.n_params(), f"{built} parameters allocated, {cfg.n_params()} + {pad} expected")
    if cfg.name == LM_ARCH:
        check(cfg.n_params() == LM_PARAMS, f"cfg.n_params() {cfg.n_params()} is not {LM_PARAMS}")
    print(f"[lm-serve] {card}: memory allocated {torch.cuda.memory_allocated() / gib:.3f} GiB, "
          f"peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB (the f32 masters)")

    tracer = obs.Tracer()
    engine = ServeEngine(model, max_batch=LM_BATCH, max_len=LM_PROMPT + LM_NEW, tracer=tracer)
    torch.cuda.synchronize()
    print(f"[lm-serve] {card}: with the engine's {cfg.dtype} working copy: memory allocated "
          f"{torch.cuda.memory_allocated() / gib:.3f} GiB, peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB")

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, LM_PROMPT).astype(np.int32),
                    max_new_tokens=LM_NEW) for i in range(LM_REQUESTS)]
    captured: dict = {"prefill": [], "decode": []}

    def capture(router, args, experts):
        kind = "prefill" if args[0].shape[1] == LM_BATCH * LM_PROMPT else "decode"
        if len(captured[kind]) < cfg.n_layers:
            captured[kind].append((router, args[0], args[1], experts))

    hooks = [r.register_forward_hook(capture) for r in engine.model.tree_routers()]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        engine.run(reqs, pad_to=LM_PROMPT)
    finally:
        for h in hooks:
            h.remove()
    served_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    waves = LM_REQUESTS // LM_BATCH
    expect = cfg.n_layers * LM_NEW * waves     # a layer routes once a prefill and once a decode step
    print(f"[lm-serve] served {LM_REQUESTS} requests (prompts of {LM_PROMPT} seeded ids, {LM_NEW} new tokens, "
          f"greedy) in {engine.stats.waves} waves of {LM_BATCH} in {served_s:.3f} s: K1 onehot launched "
          f"{launches['speculative/onehot']} times in the served run's window ({cfg.n_layers} layers x "
          f"(1 prefill + {LM_NEW - 1} decode steps) x {waves} waves = {expect}); other kernels "
          f"{ {k: v for k, v in launches.items() if v and k != 'speculative/onehot'} }")
    check(launches["speculative/onehot"] == expect, f"K1 onehot launched {launches['speculative/onehot']} times, not {expect}")
    check(sum(launches.values()) == expect, f"kernels other than K1 onehot launched: {launches}")
    check(engine.stats.waves == waves and engine.stats.decode_steps == waves * (LM_NEW - 1),
          f"{engine.stats.waves} waves, {engine.stats.decode_steps} decode steps")
    for r in reqs:
        check(r.done and len(r.out_tokens) == LM_NEW and all(0 <= t < model.v_pad for t in r.out_tokens),
              f"request {r.uid}: {r.out_tokens}")
    print(f"[lm-serve] out tokens: " + "; ".join(f"req {r.uid}: {r.out_tokens[:8]}..." for r in reqs[:4])
          + f"; ids ≥ vocab_size {cfg.vocab_size} (the padded columns the engine samples too): "
          f"{sum(t >= cfg.vocab_size for r in reqs for t in r.out_tokens)} of {LM_REQUESTS * LM_NEW}")

    # every captured route against K1's plain version on the same z
    check(len(captured["prefill"]) == len(captured["decode"]) == cfg.n_layers,
          f"captured {len(captured['prefill'])} prefill and {len(captured['decode'])} decode routes")
    err, margin, used, drops = 0, float("inf"), set(), {"prefill": [0, 0], "decode": [0, 0]}
    for kind, caps in captured.items():
        for router, h2, proj, experts in caps:
            z = lm_moe.router_features(h2, proj).reshape(-1, n_int)
            p = router.packed
            plain = K.speculative_plain(sanitize_records(z), p.attr_idx, p.attr_select, p.threshold, p.child,
                                        p.class_val, total_jumps=ops._total_jumps(p.max_depth), jump_mode="onehot")
            got = experts.reshape(-1)
            check(torch.equal(got, plain), f"{kind}: K1 routed {int((got != plain).sum())} of {got.numel()} "
                                           "tokens otherwise than its plain version")
            err = max(err, max_abs_err(got, plain))
            margin = min(margin, float((z - p.threshold[:n_int]).abs().min()))
            used |= set(got.tolist())
            d, a = lm_dropped(experts, moe, lm_moe.padded_experts(moe))
            drops[kind][0] += d
            drops[kind][1] += a
    print(f"[lm-serve] every captured route torch.equal to K1's plain version on the same z: "
          f"{cfg.n_layers} prefill calls (M {LM_BATCH * LM_PROMPT}) and {cfg.n_layers} decode calls (M {LM_BATCH}); "
          f"smallest |z - threshold| {margin:.3g}; {len(used)} of {moe.n_experts} experts chosen by a tree; "
          f"assignments dropped past capacity: prefill {drops['prefill'][0]} of {drops['prefill'][1]}, "
          f"decode {drops['decode'][0]} of {drops['decode'][1]}")

    spans = [e.dur_us / 1e3 for e in tracer.events() if e.name == "serve.prefill"]
    s = engine.stats
    print(f"[lm-serve] {card}: served prefill ms per wave (B {LM_BATCH} x S {LM_PROMPT}, host clock after "
          f"synchronize): {', '.join(f'{ms:.3f}' for ms in spans)}; decode {s.decode_s * 1e3:.3f} ms for "
          f"{s.decode_steps} steps ({s.decode_s * 1e3 / s.decode_steps:.3f} ms a step with sampling), "
          f"{LM_REQUESTS * (LM_NEW - 1) / s.decode_s:.1f} decode tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB")

    # consistency at full width in f32, on the same f32 masters
    m32 = model.cast_for_compute("float32")
    check(all(a.data_ptr() == b.data_ptr() for a, b in zip(m32.parameters(), model.parameters())),
          "the f32 model does not share the masters")
    routes32: list = []
    hooks = [r.register_forward_hook(lambda r, a, out: routes32.append(out)) for r in m32.tree_routers()]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)).to(dev)
    try:
        with torch.no_grad():
            full, _ = m32({"tokens": toks}, serve_hard_tree=True)
            lp, cache = m32.prefill({"tokens": toks[:, :16]}, max_len=24)
            ld, _ = m32.decode_step(cache, {"tokens": toks[:, 16:17]})
    finally:
        for h in hooks:
            h.remove()
    check(bool(torch.isfinite(full).all()) and full.shape == (2, 17, model.v_pad), "f32 forward logits")
    err_p = float((lp[:, -1] - full[:, 15]).abs().max())
    err_d = float((ld[:, 0] - full[:, 16]).abs().max())
    dropped = [lm_dropped(e, moe, lm_moe.padded_experts(moe)) for e in routes32]
    per = cfg.n_layers
    why = "; ".join(f"{name} {sum(d for d, _ in dropped[i * per:(i + 1) * per])} of "
                    f"{sum(a for _, a in dropped[i * per:(i + 1) * per])}"
                    for i, name in enumerate(("forward (group 34)", "prefill (group 32)", "decode (group 2)")))
    print(f"[lm-serve] {card}: f32 consistency at full width (B 2, S 17, the same masters): max |prefill - forward| "
          f"{err_p:.3g} at position 15, max |decode - forward| {err_d:.3g} at position 16, logits max "
          f"{float(full.abs().max()):.3g}; tolerance {LM_TOL} (rtol and atol), the JAX smoke test's; the errors sit "
          f"below it because f32 on the card differs only in summation order and in which assignments each "
          f"group drops past capacity ({why}), and the experts' outputs are small at this init")
    check(torch.allclose(lp[:, -1], full[:, 15], rtol=LM_TOL, atol=LM_TOL)
          and torch.allclose(ld[:, 0], full[:, 16], rtol=LM_TOL, atol=LM_TOL),
          f"f32 prefill/decode disagree with forward: {err_p}, {err_d}")
    del m32, full, lp, ld, cache

    # steady prefill and decode steps outside the served window
    work = engine.model
    wave = torch.from_numpy(engine._pad_wave(reqs[:LM_BATCH], LM_PROMPT)).to(dev)
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = work.prefill({"tokens": wave}, max_len=LM_PROMPT + LM_DECODE_TIMED + 2)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    host, events = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(LM_DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits, cache = work.decode_step(cache, {"tokens": tok})
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
    weights = sum(p.numel() * p.element_size() for n, p in work.named_parameters() if n != "embed.table")
    kv = cache.kv.k[:, :, :cache.pos].numel() * cache.kv.k.element_size() * 2
    w_ms, kv_ms = weights / roofline.HBM_BW * 1e3, kv / roofline.HBM_BW * 1e3
    print(f"[lm-serve] {card}: steady prefill ms (B {LM_BATCH} x S {LM_PROMPT}, host clock after synchronize): "
          f"{', '.join(f'{ms:.3f}' for ms in pre)}; decode step ms over {LM_DECODE_TIMED} steps (B {LM_BATCH}, "
          f"no sampling): host clock mean {np.mean(host):.3f} min {min(host):.3f}, CUDA events mean "
          f"{np.mean(events):.3f} min {min(events):.3f}; {LM_BATCH / np.mean(host) * 1e3:.1f} tokens/s at the "
          f"host-clock mean; byte bound of a step: the {cfg.dtype} working weights but the embedding table "
          f"({weights / 1e9:.3f} GB) {w_ms:.3f} ms + the KV cache read ({kv / 1e6:.2f} MB) {kv_ms:.4f} ms = "
          f"{w_ms + kv_ms:.3f} ms at {roofline.HBM_BW / 1e12:.2f} TB/s")
    lm_step_breakdown(lambda: work.decode_step(cache, {"tokens": tok}), card)

    # K1 onehot at the router's decode and prefill shapes, on the captured z
    p = captured["decode"][0][0].packed
    bm = ops.choose_block_m(n_nodes, n_int, algorithm="speculative", jump_mode="onehot")
    jumps = ops._total_jumps(p.max_depth)
    runs, rows = [], []
    for kind in ("decode", "prefill"):
        router, h2, proj, _ = captured[kind][0]
        z = sanitize_records(lm_moe.router_features(h2, proj).reshape(-1, n_int))
        tabs = (p.attr_idx, p.attr_select, p.threshold, p.child, p.class_val)
        runs.append((kind, lambda i, z=z, tabs=tabs: K.speculative(z, *tabs, total_jumps=jumps,
                                                                    jump_mode="onehot", block_m=bm)))
        plain_ms = event_ms(lambda i, z=z, tabs=tabs: K.speculative_plain(z, *tabs, total_jumps=jumps,
                                                                           jump_mode="onehot"), 1, 50)
        m = z.shape[0]
        bnd, by = bound(m, n_int, 1, n_nodes, m * depth)
        rows.append((kind, m, plain_ms, bnd, by, launch_shape("speculative/onehot", m, n_nodes, n_int, bm)))
    timed_k1 = profiled_ms(runs, 1, 200)
    for kind, m, plain_ms, bnd, by, shape in rows:
        ms, n = timed_k1[kind]
        print(f"[lm-serve] {card}: K1 onehot at the router's {kind} shape M {m}, N {n_nodes}, A {n_int} "
              f"(block_m {bm}; {shape}): {ms:.4f} ms "
              f"(profiler, {n} launches), plain {plain_ms:.4f} ms (CUDA events), bound {bnd:.3g} ms ({by}, "
              f"launch/roofline.py), {bnd / ms:.2%} of the bound; library: none")
    planned = dryrun_serve_check(dev, cfg, card)
    print(f"[lm-serve] phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return {"k1_onehot_launches": launches["speculative/onehot"] + planned["k1_onehot_launches"],
            "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 2t: the LM training path (loss → AdamW → train_loop), then serving
# the trained weights through K1
# ---------------------------------------------------------------------------


LM_TRAIN_STEPS, LM_TRAIN_SEQ, LM_TRAIN_BATCH = 6, 128, 4     # B 4 × S 128: one 512-token MoE group
LM_TRAIN_DECODE = 4
LM_TRAIN_TOL = 1e-5
LM_RESTART_STEPS, LM_RESTART_EVERY, LM_RESTART_FAIL = 8, 2, 3
LM_TRAIN_RESULT = "[lm-train] result "
LM_TRAIN_TIMEOUT_S = 900


def lm_train_ranges():
    """The profiler ranges of a train step: the serve step's, each block, and
    the loss and the optimizer (patched where the train path looks them up)."""
    from repro_torch.models import lm as lm_model
    from repro_torch.models.layers import attention as lm_attn
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.train import step as lm_step
    from repro_torch.utils import losses as lm_losses

    return [(lm_model.Block, "forward", "lm.block"),                # every block's work, recomputed too
            (torch, "einsum", lambda eq, *_: f"lm.einsum {eq}"),
            (lm_attn, "_grouped_attention", "lm.attention"),
            (lm_moe, "moe_apply", "lm.moe"),
            (lm_model, "chunked_softmax_xent", "lm.loss"),
            (lm_losses, "_chunk_sums", "lm.loss"),       # the chunks' recompute in the backward pass
            (lm_step, "adamw_apply", "lm.optimizer")]


def close_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / (|want| + max |want|) (the CPU tests' comparison),
    in f64 on ``want``'s device."""
    want = want.detach().double()
    got = got.detach().to(want.device, torch.float64)
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float(((got - want).abs() / (want.abs() + scale + 1e-30)).max()) if want.numel() else 0.0


def lm_train_card_vs_cpu(dev, card) -> float:
    """One train step of the f32 smoke model on the card and on the CPU, from
    the same weights, batch and optimizer state: loss, grad norm, lr, every
    parameter and moment.  Returns the largest relative difference."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import device_batch, make_train_step

    cfg = get_smoke_config("granite-moe")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    pipe = pipeline_for(cfg, ShapeConfig("train", 32, 2, "train"), seed=0)
    runs, start = [], None
    for where in ("cpu", dev):
        model = build_model(cfg, device=where)
        if start is None:
            model.init(torch.Generator(device="cpu").manual_seed(0))
            start = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(start)
        opt = adamw_init(model)
        model, opt, metrics = make_train_step(model, tcfg)(model, opt, device_batch(pipe(0), where))
        runs.append((model, opt, metrics))
    (cm, co, cmet), (gm, go, gmet) = runs
    errs = {k: (close_rel(gmet[k], cmet[k]), "") for k in cmet}
    named = dict(cm.named_parameters())
    for n, p in gm.named_parameters():
        for kind, got, want in (("params", p, named[n]), ("m", go.m[n], co.m[n]), ("v", go.v[n], co.v[n])):
            errs[kind] = max(errs.get(kind, (0.0, "")), (close_rel(got, want), f" ({n})"))
    worst = max(e for e, _ in errs.values())
    print(f"[lm-train] {card}: one train step of {cfg.name} (f32, B 2 x S 32) on the card against the CPU port "
          f"from the same weights: largest relative difference "
          + ", ".join(f"{k} {v:.3g}{at}" for k, (v, at) in errs.items())
          + f" (tolerance {LM_TRAIN_TOL}: |card - cpu| <= tol * (|cpu| + max |cpu|) a tensor)")
    check(worst <= LM_TRAIN_TOL, f"the card's train step differs from the CPU's by {worst}")
    return worst


def train_step_card_vs_cpu(dev, arch: str) -> tuple[dict, float]:
    """One f32 smoke train step of ``arch`` through ``make_train_step`` on the
    CPU and on ``dev``, from the same weights, batch and optimizer state.

    Returns ({part: (largest relative difference, the tensor where)}, the
    largest difference of the parameters after the whole step).  The parts
    are the step's metrics (loss, nll, aux, grad norm, lr) and the gradients
    it hands AdamW (caught at its call of ``adamw_apply``), then AdamW's
    parameters and moments, applied from the start on both sides to the
    card's gradients.  The whole step's parameters are returned apart: AdamW's
    first update, g / (|g| + eps) a parameter, magnifies the last bits in
    which the two sides' gradients differ wherever |g| is near eps (ROADMAP
    §3)."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init, default_decay_mask
    from repro_torch.train import device_batch, make_train_step
    from repro_torch.train import step as lm_step

    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = pipeline_for(cfg, ShapeConfig("train", 32, 2, "train"), seed=0)(0)
    real = lm_step.adamw_apply
    runs, start = [], None
    for where in ("cpu", dev):
        model = build_model(cfg, device=where)
        if start is None:
            model.init(torch.Generator(device="cpu").manual_seed(0))
            start = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(start)
        caught = {}

        def catch(params, grads, *args, **kw):
            caught.update(grads)
            return real(params, grads, *args, **kw)

        lm_step.adamw_apply = catch
        try:
            model, _, metrics = make_train_step(model, tcfg)(model, adamw_init(model), device_batch(batch, where))
        finally:
            lm_step.adamw_apply = real
        runs.append((model, metrics, caught))
    (cm, cmet, cg), (gm, gmet, gg) = runs
    errs = {k: (close_rel(gmet[k], cmet[k]), "") for k in cmet}
    named = dict(cm.named_parameters())
    whole = max(close_rel(p, named[n]) for n, p in gm.named_parameters())
    for n, g in gg.items():
        errs["grads"] = max(errs.get("grads", (0.0, "")), (close_rel(g, cg[n]), f" ({n})"))
    opts = []
    for model, grads in ((cm, {n: g.cpu() for n, g in gg.items()}), (gm, gg)):
        model.load_state_dict({k: v.to(model.device) for k, v in start.items()})
        opts.append(adamw_init(model))
        real(model, grads, opts[-1], tcfg, decay_mask=default_decay_mask(model))
    co, go = opts
    for n, p in gm.named_parameters():
        for kind, got, want in (("params", p, named[n]), ("m", go.m[n], co.m[n]), ("v", go.v[n], co.v[n])):
            errs[kind] = max(errs.get(kind, (0.0, "")), (close_rel(got, want), f" ({n})"))
    return errs, whole


def fam_train_card_vs_cpu(dev, card, arch: str) -> float:
    """:func:`train_step_card_vs_cpu` printed and gated at ``LM_TRAIN_TOL``;
    returns the largest gated difference."""
    errs, whole = train_step_card_vs_cpu(dev, arch)
    worst = max(e for e, _ in errs.values())
    print(f"{FAM_TRAIN_TAG} {card}: one train step (make_train_step) of {arch}-smoke (f32, B 2 x S 32) on the card "
          f"against the CPU port from the same weights: largest relative difference "
          + ", ".join(f"{k} {v:.3g}{at}" for k, (v, at) in errs.items())
          + f" (params, m, v: AdamW applied on both sides to the card's gradients; tolerance {LM_TRAIN_TOL}: "
          f"|card - cpu| <= tol * (|cpu| + max |cpu|) a tensor); parameters after the whole step {whole:.3g}, "
          f"not gated (ROADMAP §3)")
    check(worst <= LM_TRAIN_TOL, f"{arch}: the card's train step differs from the CPU's by {worst}")
    return worst


def lm_train_restart(dev, card) -> None:
    """The fault-tolerant loop on the card at smoke width: checkpoints every
    2 steps, a ``SimulatedFailure`` at step 3, the restore reading the
    checkpoint in place; the replayed losses against an uninterrupted run's."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import LoopState, SimulatedFailure, device_batch, make_train_step, train_loop

    cfg = get_smoke_config("granite-moe")
    pipe = pipeline_for(cfg, ShapeConfig("train", 32, 2, "train"), seed=0)
    batches = lambda i: device_batch(pipe(i), dev)   # noqa: E731
    reports = []
    with tempfile.TemporaryDirectory() as tmp:
        for every, fail in ((0, None), (LM_RESTART_EVERY, LM_RESTART_FAIL)):
            tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=LM_RESTART_STEPS, ckpt_every=every,
                               ckpt_dir=os.path.join(tmp, f"ckpt_{every}"))
            model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
            state = LoopState(model=model, opt_state=adamw_init(model), step=0)
            fired = []

            def injector(i, fail=fail, fired=fired):
                if i == fail and not fired:
                    fired.append(i)
                    raise SimulatedFailure(f"injected at step {i}")

            def restore_fn(last, state=state, tcfg=tcfg):
                ckpt.restore(tcfg.ckpt_dir, last, {"params": state.model, "opt": state.opt_state})
                return LoopState(model=state.model, opt_state=state.opt_state, step=last)

            _, report = train_loop(state, make_train_step(model, tcfg), batches, tcfg,
                                   failure_injector=injector, restore_fn=restore_fn)
            reports.append(report)
    clean, faulty = reports
    resumed = LM_RESTART_FAIL - (LM_RESTART_FAIL % LM_RESTART_EVERY)     # the latest checkpoint's step
    want = clean.losses[:LM_RESTART_FAIL] + clean.losses[resumed:]
    err = max(abs(a - b) / abs(b) for a, b in zip(faulty.losses, want)) if len(want) == len(faulty.losses) else 1.0
    print(f"[lm-train] {card}: restart at smoke width: checkpoints every {LM_RESTART_EVERY} steps, a "
          f"SimulatedFailure at step {LM_RESTART_FAIL}, restored from step {resumed}: restarts {faulty.restarts}, "
          f"final step {faulty.final_step}, {len(faulty.losses)} losses (steps 0-{LM_RESTART_FAIL - 1}, then "
          f"{resumed}-{LM_RESTART_STEPS - 1} again); largest relative difference from the uninterrupted run "
          f"{err:.3g} (rtol {LM_TRAIN_TOL}: sums that atomics accumulate on the card need not repeat bit for bit)")
    check(faulty.restarts == 1 and faulty.final_step == LM_RESTART_STEPS and clean.restarts == 0,
          f"restarts {faulty.restarts}, final step {faulty.final_step}")
    check(err <= LM_TRAIN_TOL, f"the replayed losses differ from the uninterrupted run's by {err}")


OFFLOAD_TOL = 1e-6       # tests/test_torch_device.py::test_offload_smoke_train_step_on_card_equals_full
OFFLOAD_BYTES_RTOL = 0.10


def remat_offload_check(model, batch: dict, card, tag: str) -> None:
    """Remat "offload" against "full" on the same weights and batch, in turns
    (full, offload, offload, full): the memory still allocated right after
    the forward (``model.loss``), which must be lower under "offload" by the
    block inputs that go to pinned host memory (L x B x S x d_model in the
    activation dtype, within 10%); the loss and every gradient of each run
    against the first "full" run's, within ``OFFLOAD_TOL`` of each tensor's
    scale; the forward + backward ms of each run (host clock after
    synchronize).  Leaves the model at "full"."""
    import dataclasses

    cfg = model.cfg
    b, s = batch["tokens"].shape
    want = cfg.n_layers * b * s * cfg.d_model * torch.empty((), dtype=cfg.act_dtype).element_size()
    params = list(model.parameters())
    ref, runs = None, []
    for mode in ("full", "offload", "offload", "full"):
        model.parallel = dataclasses.replace(model.parallel, remat=mode)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = model.loss(batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if ref is None:
            ref, err = (loss.detach(), grads), 0.0
        else:
            err = max([close_rel(loss, ref[0])] + [close_rel(g, r) for g, r in zip(grads, ref[1])])
        runs.append((mode, held, ms, err))
        del loss, grads
    model.parallel = dataclasses.replace(model.parallel, remat="full")
    del ref
    torch.cuda.empty_cache()
    saved = runs[3][1] - runs[2][1]
    print(f"{tag} {card}: {cfg.name} remat 'offload' against 'full' (same weights, batch B {b} x S {s}), in turns: "
          + "; ".join(f"{mode}: {held:,} B allocated after the forward, forward + backward {ms:.1f} ms, largest "
                      f"relative difference from the first full run {err:.3g}" for mode, held, ms, err in runs)
          + f"; offload holds {saved:,} B less after the forward (predicted {want:,} B: {cfg.n_layers} block inputs "
          f"of {b} x {s} x {cfg.d_model} {cfg.dtype} in pinned host memory; tolerance {OFFLOAD_BYTES_RTOL:.0%}); "
          f"gradient tolerance {OFFLOAD_TOL} (the card's scatter-adds may sum in another order)")
    check(abs(saved - want) <= OFFLOAD_BYTES_RTOL * want,
          f"{cfg.name}: offload saved {saved} B after the forward, not {want} B")
    check(all(err <= OFFLOAD_TOL for *_, err in runs), f"{cfg.name}: offload or a rerun differs from full: {runs}")


def phase_lm_train(dev, card, cfg=None) -> dict:
    """The LM training path at granite-moe-3b-a800m's full width; see the
    module docstring (phase 2t).  Returns K1 onehot's launches in the window
    of the serve from the trained weights and the largest disagreement of a
    captured route with K1's plain version."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import LoopState, device_batch, make_train_step, train_loop

    t_phase = time.perf_counter()
    cfg = cfg or get_config(LM_ARCH)
    moe, depth = cfg.moe, cfg.moe.tree_depth()
    n_int = 2**depth - 1
    gib = 2.0**30

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    built = sum(p.numel() for p in model.parameters())
    print(f"[lm-train] {cfg.name} at full width: {cfg.n_layers} layers, remat {model.parallel.remat!r}, "
          f"{built:,} f32 parameters (seed 0); {card}: memory allocated {torch.cuda.memory_allocated() / gib:.3f} GiB")
    pipe = pipeline_for(cfg, ShapeConfig("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"), seed=0)
    batches = lambda i: device_batch(pipe(i), dev)   # noqa: E731
    batch0 = batches(0)
    remat_offload_check(model, batch0, card, "[lm-train]")
    opt = adamw_init(model)
    torch.cuda.synchronize()
    print(f"[lm-train] {card}: with the AdamWState (m, v in f32): memory allocated "
          f"{torch.cuda.memory_allocated() / gib:.3f} GiB")

    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=LM_TRAIN_STEPS, ckpt_every=0)
    with torch.no_grad():
        before, _ = model.loss(batch0)
    before = float(before)

    train_step = make_train_step(model, tcfg)
    seen = []

    def step(m, o, b):
        out = train_step(m, o, b)
        torch.cuda.synchronize()
        seen.append(out[2])
        return out

    torch.cuda.reset_peak_memory_stats()
    state, report = train_loop(LoopState(model=model, opt_state=opt, step=0), step, batches, tcfg)
    peak = torch.cuda.max_memory_allocated() / gib
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    for i, (metrics, dt) in enumerate(zip(seen, report.step_times)):
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"step {i}: {vals}")
        print(f"[lm-train] {card}: step {i}: loss {vals['loss']:.6f} (nll {vals['nll']:.6f}, aux {vals['aux']:.6f}), "
              f"grad norm {vals['grad_norm']:.6f}, lr {vals['lr']:.6g}, {dt * 1e3:.1f} ms (host clock, after "
              f"synchronize), {tokens / dt:,.0f} tokens/s")
    with torch.no_grad():
        after, _ = model.loss(batch0)
    after = float(after)
    err0 = abs(report.losses[0] - before) / abs(before)
    steady = report.step_times[1:]
    print(f"[lm-train] {card}: {LM_TRAIN_STEPS} steps of B {LM_TRAIN_BATCH} x S {LM_TRAIN_SEQ}: steady mean "
          f"{np.mean(steady) * 1e3:.1f} ms a step, min {min(steady) * 1e3:.1f} ms, first {report.step_times[0] * 1e3:.1f} ms; "
          f"{tokens / np.mean(steady):,.0f} tokens/s; peak memory {peak:.3f} GiB during the steps; loss on batch 0 "
          f"{before:.6f} before, {after:.6f} after; step 0 reported {report.losses[0]:.6f} (relative difference "
          f"{err0:.3g} from model.loss just before it)")
    check(report.final_step == LM_TRAIN_STEPS and report.restarts == 0, f"final step {report.final_step}")
    check(err0 <= LM_TRAIN_TOL, f"step 0's loss {report.losses[0]} is not model.loss {before}")
    check(np.isfinite(after) and after < before, f"the loss on batch 0 did not fall: {before} -> {after}")

    wall, device, kinds = lm_profiled_kinds(lambda: train_step(model, opt, batches(LM_TRAIN_STEPS)),
                                            lm_train_ranges())
    print(f"[lm-train] {card}: one train step (B {LM_TRAIN_BATCH} x S {LM_TRAIN_SEQ}, forward + block "
          f"recompute + backward + AdamW) under the profiler: {kinds_line(wall, device, kinds)}")

    # serve from the trained weights: the routers' thresholds moved
    del state
    stale = sum(r.stale for r in model.tree_routers())
    check(stale == cfg.n_layers, f"{stale} of {cfg.n_layers} routers stale after training")
    print(f"[lm-train] after training {stale} of {cfg.n_layers} routers are stale (router_thr moved); "
          f"DecoderModel.pack_routers() packs them again")
    model.pack_routers()
    work = model.cast_for_compute()
    captured = []
    hooks = [r.register_forward_hook(lambda r, a, out: captured.append((r, a[0], a[1], out)))
             for r in work.tree_routers()]
    toks = batch0["tokens"]
    K.reset_launches()
    try:
        logits, cache = work.prefill({"tokens": toks}, max_len=LM_TRAIN_SEQ + LM_TRAIN_DECODE + 1)
        for _ in range(LM_TRAIN_DECODE):
            tok = logits[:, -1].argmax(-1, keepdim=True).int()
            logits, cache = work.decode_step(cache, {"tokens": tok})
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    launches = dict(K.LAUNCHES)
    expect = cfg.n_layers * (1 + LM_TRAIN_DECODE)
    check(launches["speculative/onehot"] == expect and sum(launches.values()) == expect,
          f"serving the trained weights launched {launches}, not K1 onehot {expect} times")
    check(len(captured) == expect and bool(torch.isfinite(logits).all()), f"{len(captured)} routes captured")
    err, fresh_equal = 0, 0
    for i, (router, h2, proj, experts) in enumerate(captured):
        z = lm_moe.router_features(h2, proj).reshape(-1, n_int)
        p = router.packed
        plain = K.speculative_plain(sanitize_records(z), p.attr_idx, p.attr_select, p.threshold, p.child,
                                    p.class_val, total_jumps=ops._total_jumps(p.max_depth), jump_mode="onehot")
        got = experts.reshape(-1)
        check(torch.equal(got, plain), f"route {i}: K1 routed {int((got != plain).sum())} tokens otherwise than plain")
        err = max(err, max_abs_err(got, plain))
        layer = model.layers[i % cfg.n_layers]
        fresh = lm_moe.pack_router(cfg, layer.moe.router_thr.detach().clone())
        want = lm_moe.hard_tree_route({"router_proj": proj}, h2, cfg=cfg, e_pad=lm_moe.padded_experts(moe),
                                      packed=fresh)
        check(torch.equal(experts, want), f"route {i}: the trained router routes otherwise than a fresh pack")
        fresh_equal += 1
    print(f"[lm-train] served the trained weights ({cfg.dtype} working copy): one prefill (B {LM_TRAIN_BATCH} x "
          f"S {LM_TRAIN_SEQ}) and {LM_TRAIN_DECODE} decode steps: K1 onehot launched {launches['speculative/onehot']} "
          f"times ({cfg.n_layers} layers x {1 + LM_TRAIN_DECODE}), no other kernel; all {len(captured)} routes "
          f"torch.equal to K1's plain version on the same z and to hard_tree_route with routers packed fresh from "
          f"the trained router_thr ({fresh_equal})")
    del work, cache, logits
    # the dry-run's two real steps, after everything that reads the trained weights
    planned = dryrun_train_check(model, opt, train_step, batches(LM_TRAIN_STEPS + 1), cfg, card)
    del opt, model
    torch.cuda.empty_cache()

    lm_train_card_vs_cpu(dev, card)
    lm_train_restart(dev, card)
    print(f"[lm-train] phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return {"k1_onehot_launches": launches["speculative/onehot"] + planned, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 2f: the remaining LM families (hybrid, xLSTM, encoder-decoder) at full
# width, and the tree token head on K1
# ---------------------------------------------------------------------------


FAM_ARCHS = ("hymba-1.5b", "xlstm-125m", "whisper-medium")
FAM_PARAMS = {"hymba-1.5b": 1_661_956_800, "xlstm-125m": 204_706_560, "whisper-medium": 657_188_864}
FAM_REQUESTS, FAM_PROMPT, FAM_NEW, FAM_BATCH = 8, 128, 32, 4
FAM_LONG_PROMPT, FAM_LONG_NEW = 1_280, 8   # past hymba's 1,024-token window; five 256-step SSM chunks
FAM_WHISPER_PROMPT = 16
FAM_TREE_CLASSES = 7                       # the paper's seven segmentation classes: depth 3, N 15, A 7
FAM_DECODE_TIMED = 8
FAM_CPU_TOL = 1e-4        # tests/test_torch_device.py::test_new_families_on_card_equal_cpu
LM_FAMILIES_RESULT = "[lm-families] result "
LM_FAMILIES_TIMEOUT_S = 900


def fam_ranges(family: str):
    """The profiler ranges of one decode step and the kinds they name."""
    from repro_torch.models.layers import attention as lm_attn
    from repro_torch.models.layers import ssm as lm_ssm
    from repro_torch.models.layers import xlstm as lm_xl

    if family == "ssm":
        return ([(lm_xl, "mlstm_decode", "lm.mlstm"), (lm_xl, "slstm_decode", "lm.slstm")],
                {"lm.mlstm": "elementwise in the mLSTM", "lm.slstm": "elementwise in the sLSTM"})
    ranges = [(lm_attn, "_grouped_attention", "lm.attention")]
    if family == "hybrid":
        return ranges + [(lm_ssm, "ssm_decode", "lm.ssm")], {"lm.ssm": "elementwise in the SSM"}
    return ranges, {}


def fam_build(cfg, dev, card, tag: str = "[lm-families]"):
    """``build_model`` at full width, f32 masters from a generator seeded 0."""
    from repro_torch.models import build_model
    from repro_torch.models import schema as lm_schema

    gib = 2.0**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    built = sum(p.numel() for p in model.parameters())
    count = lm_schema.param_count(model.schema())
    print(f"{tag} {cfg.name} ({type(model).__name__}) at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV; {built:,} parameters allocated = the JAX "
          f"schema's {count:,} (cfg.n_params() {cfg.n_params():,}, the reference's own estimate); f32 masters "
          f"drawn from a seeded torch.Generator on the card in {time.perf_counter() - t0:.1f} s; {card}: memory "
          f"allocated {torch.cuda.memory_allocated() / gib:.3f} GiB")
    check(built == count, f"{built} parameters allocated, the schema declares {count}")
    if cfg.name in FAM_PARAMS:
        check(cfg.n_params() == FAM_PARAMS[cfg.name], f"cfg.n_params() {cfg.n_params()} is not {FAM_PARAMS[cfg.name]}")
    return model


def fam_batch(cfg, dev, batch: int, seq: int, seed: int) -> dict:
    """Seeded ids (B, S), and for the encoder-decoder seeded frame embeddings
    (B, F, D) × 0.02, as tests/test_arch_smoke.py makes them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(dev)}
    if cfg.family == "audio":
        emb = rng.normal(size=(batch, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32) * 0.02
        out["embeds"] = torch.from_numpy(emb).to(dev)
    return out


def fam_consistency(model, dev, card) -> tuple[float, float]:
    """The f32 model on the same masters (B 2, S 17): the last logits of
    ``prefill`` and of one ``decode_step`` against the teacher-forced
    forward, both gated within 2e-2.  The hybrid's prefill restarts the SSM
    state (ROADMAP.md §3 item 13); at this init the state's share of the
    logits is small enough that its decode stays within the gate too (the
    gap the restart makes is pinned on the CPU, with weights that carry)."""
    m32 = model.cast_for_compute("float32")
    check(all(a.data_ptr() == b.data_ptr() for a, b in zip(m32.parameters(), model.parameters())),
          "the f32 model does not share the masters")
    batch = fam_batch(model.cfg, dev, 2, 17, seed=1)
    prompt = {k: (v[:, :16] if k == "tokens" else v) for k, v in batch.items()}
    with torch.no_grad():
        full, _ = m32(batch)
        lp, cache = m32.prefill(prompt, max_len=24)
        ld, _ = m32.decode_step(cache, {"tokens": batch["tokens"][:, 16:17]})
    check(bool(torch.isfinite(full).all() and torch.isfinite(lp).all() and torch.isfinite(ld).all())
          and full.shape == (2, 17, model.v_pad), f"{model.cfg.name}: f32 logits not finite or misshapen")
    err_p = float((lp[:, -1] - full[:, 15]).abs().max())
    err_d = float((ld[:, 0] - full[:, 16]).abs().max())
    hybrid = model.cfg.family == "hybrid"
    print(f"[lm-families] {card}: {model.cfg.name} f32 consistency at full width (B 2, S 17, the same masters): "
          f"max |prefill - forward| {err_p:.3g} at position 15, max |decode - forward| {err_d:.3g} at position 16"
          f"{' (the prefill restarts the SSM state, as in JAX)' if hybrid else ''}, logits max "
          f"{float(full.abs().max()):.3g}; tolerance {LM_TOL} (rtol and atol), the JAX smoke test's")
    check(torch.allclose(lp[:, -1], full[:, 15], rtol=LM_TOL, atol=LM_TOL),
          f"{model.cfg.name}: f32 prefill disagrees with forward by {err_p}")
    check(torch.allclose(ld[:, 0], full[:, 16], rtol=LM_TOL, atol=LM_TOL),
          f"{model.cfg.name}: f32 decode disagrees with forward by {err_d}")
    return err_p, err_d


def fam_decode_bytes(work, cache) -> tuple[int, int]:
    """(weight bytes, state bytes) one decode step must read: the working
    weights the step uses (not the embedding table, of which it gathers B
    rows, unless it is the tied output head; not an encoder's), and the
    caches' filled part."""
    cfg = work.cfg
    skip = ("enc_layers.", "enc_norm.", "pos_embed") + (() if cfg.tie_embeddings else ("embed.table",))
    weights = sum(p.numel() * p.element_size() for n, p in work.named_parameters() if not n.startswith(skip))
    size = lambda t: t.numel() * t.element_size()   # noqa: E731
    if cfg.family == "ssm":
        state = sum(size(t) for st in cache.states for t in st)
    elif cfg.family == "audio":
        state = 2 * size(cache.self_kv.k[:, :, :cache.pos]) + 2 * size(cache.cross_kv.k)
    else:
        state = 2 * size(cache.kv.k[:, :, :cache.pos]) + size(cache.ssm.conv) + size(cache.ssm.h)
    return weights, state


def fam_steady(work, batch: dict, card) -> None:
    """Three prefills and ``FAM_DECODE_TIMED`` decode steps outside the
    served window (host clock after synchronize, and CUDA events), the
    step's byte bound, then one decode step under the profiler."""
    cfg = work.cfg
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = work.prefill(batch, max_len=batch["tokens"].shape[1] + FAM_DECODE_TIMED + 2)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    host, events = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(FAM_DECODE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits, cache = work.decode_step(cache, {"tokens": tok})
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
    b, s = batch["tokens"].shape
    weights, state = fam_decode_bytes(work, cache)
    w_ms, s_ms = weights / roofline.HBM_BW * 1e3, state / roofline.HBM_BW * 1e3
    print(f"[lm-families] {card}: {cfg.name} steady prefill ms (B {b} x S {s}, host clock after synchronize): "
          f"{', '.join(f'{ms:.3f}' for ms in pre)}; decode step ms over {FAM_DECODE_TIMED} steps (B {b}, no "
          f"sampling): host clock mean {np.mean(host):.3f} min {min(host):.3f}, CUDA events mean "
          f"{np.mean(events):.3f} min {min(events):.3f}; {b / np.mean(host) * 1e3:.1f} tokens/s at the host-clock "
          f"mean; byte bound of a step: the {cfg.dtype} weights it reads ({weights / 1e9:.3f} GB) {w_ms:.3f} ms + "
          f"its state ({state / 1e6:.2f} MB) {s_ms:.4f} ms = {w_ms + s_ms:.3f} ms at "
          f"{roofline.HBM_BW / 1e12:.2f} TB/s")
    ranges, kinds = fam_ranges(cfg.family)
    step = lambda: work.decode_step(cache, {"tokens": tok})   # noqa: E731
    wall, device, by_kind = lm_profiled_kinds(step, ranges, kinds)
    print(f"[lm-families] {card}: {cfg.name} one decode step (B {b}) under the profiler: "
          f"{kinds_line(wall, device, by_kind)}")


def fam_served_line(name: str, engine, tracer, served_s: float, reqs, card) -> None:
    gib = 2.0**30
    spans = [e.dur_us / 1e3 for e in tracer.events() if e.name == "serve.prefill"]
    s = engine.stats
    decode_tokens = sum(len(r.out_tokens) - 1 for r in reqs)
    print(f"[lm-families] {card}: {name} served in {served_s:.3f} s: prefill ms per wave (host clock after "
          f"synchronize): {', '.join(f'{ms:.3f}' for ms in spans)}; decode {s.decode_s * 1e3:.3f} ms for "
          f"{s.decode_steps} steps ({s.decode_s * 1e3 / max(s.decode_steps, 1):.3f} ms a step with sampling), "
          f"{decode_tokens / s.decode_s:.1f} decode tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB")


def fam_check_tokens(reqs, v_pad: int, new: int) -> None:
    for r in reqs:
        check(r.done and len(r.out_tokens) == new and all(0 <= t < v_pad for t in r.out_tokens),
              f"request {r.uid}: {r.out_tokens}")


def fam_serve_engine(cfg, dev, card, waves) -> None:
    """``ServeEngine`` (its bf16 working copy) over ``waves``: (requests,
    prompt length, new tokens) each, one engine for all."""
    from repro_torch.serve import Request, ServeEngine

    model = fam_build(cfg, dev, card)
    tracer = obs.Tracer()
    engine = ServeEngine(model, max_batch=FAM_BATCH, max_len=max(p + n for _, p, n in waves), tracer=tracer)
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    steps = 0
    t0 = time.perf_counter()
    for n_req, prompt, new in waves:
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, prompt).astype(np.int32), max_new_tokens=new)
                for i in range(n_req)]
        engine.run(reqs, pad_to=prompt)
        fam_check_tokens(reqs, model.v_pad, new)
        steps += -(-n_req // FAM_BATCH) * (new - 1)
        print(f"[lm-families] {cfg.name}: {n_req} requests (prompts of {prompt} seeded ids, {new} new tokens, "
              f"greedy, max_batch {FAM_BATCH}); out tokens: "
              + "; ".join(f"req {r.uid}: {r.out_tokens[:6]}..." for r in reqs[:2]))
    served_s = time.perf_counter() - t0
    check(engine.stats.decode_steps == steps, f"{engine.stats.decode_steps} decode steps, not {steps}")
    fam_served_line(cfg.name, engine, tracer, served_s, reqs, card)
    fam_consistency(model, dev, card)
    fam_steady(engine.model, fam_batch(cfg, dev, FAM_BATCH, FAM_PROMPT, seed=2), card)


def fam_tree_head(cfg, enc: torch.Tensor, card) -> dict:
    """``tree_head_classify`` with ``FAM_TREE_CLASSES`` classes over the
    encoder's frames (M = B × F records), twice, each call building the
    head's tables as JAX does.  Reads the phase's launch counts (every
    launch since the phase began must be these two K1 onehot calls), then
    holds each class against K1's plain version on the same ``z`` and
    tables, and times K1 at this shape."""
    import dataclasses

    from repro_torch.models import schema as lm_schema
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.models.layers import tree_head as th

    hcfg = dataclasses.replace(cfg, tree_head_classes=FAM_TREE_CLASSES)
    depth = th.tree_head_depth(FAM_TREE_CLASSES)
    n_int, n_nodes = 2**depth - 1, 2 ** (depth + 1) - 1
    gen = torch.Generator(device=enc.device).manual_seed(0)
    params = {name: lm_schema.init_leaf_(torch.empty(s.shape, dtype=s.dtype, device=enc.device), s, gen)
              for name, s in lm_schema.leaves(th.tree_head_schema(hcfg))}
    classes = th.tree_head_classify(params, enc, cfg=hcfg)
    again = th.tree_head_classify(params, enc, cfg=hcfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    m = classes.numel()
    print(f"[lm-families] tree head ({FAM_TREE_CLASSES} classes: depth {depth}, N {n_nodes}, A {n_int}) over the "
          f"encoder output {tuple(enc.shape)} (M {m} frame records), twice: launches in the phase's window {dict((k, v) for k, v in launches.items() if v)}; classes per id "
          f"{torch.bincount(classes.reshape(-1).long(), minlength=FAM_TREE_CLASSES).tolist()}")
    check(launches["speculative/onehot"] == 2 and sum(launches.values()) == 2,
          f"the phase launched {launches}, not K1 onehot once a tree-head call and nothing else")
    z = sanitize_records(lm_moe.router_features(enc, params["proj"]).reshape(-1, n_int))
    packed = th.pack_tree_head(hcfg, params["thr"])
    tabs = (packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
    jumps = ops._total_jumps(depth)
    plain = K.speculative_plain(z, *tabs, total_jumps=jumps, jump_mode="onehot")
    for got in (classes, again):
        check(torch.equal(got.reshape(-1), plain),
              f"the tree head classed {int((got.reshape(-1) != plain).sum())} of {m} frames otherwise than K1's plain version")
    check(int(classes.min()) >= 0 and int(classes.max()) < FAM_TREE_CLASSES, "a class outside [0, 7)")
    # K1 at the head's shape, against its plain version and bound
    bm = ops.choose_block_m(n_nodes, n_int, algorithm="speculative", jump_mode="onehot")
    ms, n = profiled_ms([("tree-head", lambda i: K.speculative(z, *tabs, total_jumps=jumps, jump_mode="onehot",
                                                               block_m=bm))], 1, 200)["tree-head"]
    plain_ms = event_ms(lambda i: K.speculative_plain(z, *tabs, total_jumps=jumps, jump_mode="onehot"), 1, 50)
    bnd, by = bound(m, n_int, 1, n_nodes, m * depth)
    print(f"[lm-families] {card}: K1 onehot at the tree head's shape M {m}, N {n_nodes}, A {n_int} (block_m {bm}; "
          f"{launch_shape('speculative/onehot', m, n_nodes, n_int, bm)}): {ms:.4f} ms (profiler, {n} launches), "
          f"plain {plain_ms:.4f} ms (CUDA events), bound {bnd:.3g} ms ({by}, launch/roofline.py), "
          f"{bnd / ms:.2%} of the bound; library: none")
    return {"k1_onehot_launches": launches["speculative/onehot"], "max_abs_err": max_abs_err(classes.reshape(-1), plain)}


def fam_whisper(cfg, dev, card) -> dict:
    """The encoder-decoder as the JAX package's tests drive it (no engine
    serves it, ROADMAP.md §3 item 16): its bf16 working copy, one
    ``prefill({"embeds", "tokens"})`` of ``FAM_BATCH`` requests, then a
    greedy ``decode_step`` loop; the tree head over the prefill's encoder
    output."""
    gib = 2.0**30
    model = fam_build(cfg, dev, card)
    work = model.cast_for_compute()
    batch = fam_batch(cfg, dev, FAM_BATCH, FAM_WHISPER_PROMPT, seed=0)
    encoded = []
    hook = work.enc_norm.register_forward_hook(lambda mod, args, out: encoded.append(out))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        logits, cache = work.prefill(batch, max_len=FAM_WHISPER_PROMPT + FAM_NEW)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    pre_ms = (time.perf_counter() - t0) * 1e3
    out = [logits[:, -1].argmax(-1).int()]
    t0 = time.perf_counter()
    for _ in range(FAM_NEW - 1):
        logits, cache = work.decode_step(cache, {"tokens": out[-1][:, None]})
        out.append(logits[:, -1].argmax(-1).int())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu()
    check(toks.shape == (FAM_BATCH, FAM_NEW) and int(toks.min()) >= 0 and int(toks.max()) < model.v_pad,
          f"whisper tokens {toks}")
    check(cache.pos == FAM_WHISPER_PROMPT + FAM_NEW - 1, f"cache at {cache.pos}")
    print(f"[lm-families] {cfg.name}: {FAM_BATCH} requests (frame embeddings {tuple(batch['embeds'].shape)} x 0.02, "
          f"prompts of {FAM_WHISPER_PROMPT} seeded ids, {FAM_NEW} new tokens, greedy) by prefill + decode_step; "
          f"out tokens: " + "; ".join(f"req {i}: {toks[i, :6].tolist()}..." for i in range(2)))
    print(f"[lm-families] {card}: {cfg.name} served: prefill {pre_ms:.3f} ms (B {FAM_BATCH}: the encoder over "
          f"{cfg.encoder.n_frames} frames and the {FAM_WHISPER_PROMPT}-token prompt, host clock after synchronize); "
          f"decode {dec_s * 1e3:.3f} ms for {FAM_NEW - 1} steps ({dec_s * 1e3 / (FAM_NEW - 1):.3f} ms a step with "
          f"sampling), {FAM_BATCH * (FAM_NEW - 1) / dec_s:.1f} decode tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB")
    check(len(encoded) == 1, f"captured {len(encoded)} encoder outputs")
    head = fam_tree_head(cfg, encoded[0], card)
    fam_consistency(model, dev, card)
    fam_steady(work, batch, card)
    return head


def fam_card_vs_cpu(dev, card) -> None:
    """Each family's f32 smoke model from the same weights on the CPU and on
    the card: forward, prefill and one decode step within ``FAM_CPU_TOL``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    for arch in ("hymba", "xlstm", "whisper"):
        cfg = get_smoke_config(arch)
        outs = []
        state = None
        for where in ("cpu", dev):
            model = build_model(cfg, device=where)
            if state is None:
                model.init(torch.Generator(device="cpu").manual_seed(0))
                state = model.state_dict()
            else:
                model.load_state_dict(state)
            batch = fam_batch(cfg, where, 2, 17, seed=0)
            with torch.no_grad():
                full, _ = model(batch)
            lp, cache = model.prefill({k: (v[:, :16] if k == "tokens" else v) for k, v in batch.items()}, max_len=24)
            ld, _ = model.decode_step(cache, {"tokens": batch["tokens"][:, 16:17]})
            outs.append([t.cpu() for t in (full, lp, ld)])
        errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
        print(f"[lm-families] {card}: {cfg.name} (f32) on the card against the CPU port from the same weights: "
              f"max |card - cpu| forward {errs[0]:.3g}, prefill {errs[1]:.3g}, decode {errs[2]:.3g} "
              f"(tolerance {FAM_CPU_TOL}, rtol and atol)")
        check(all(torch.allclose(a, b, rtol=FAM_CPU_TOL, atol=FAM_CPU_TOL) for a, b in zip(outs[1], outs[0])),
              f"{cfg.name}: the card differs from the CPU by {errs}")


def phase_lm_families(dev, card, cfgs=None) -> dict:
    """The hybrid, xLSTM and encoder-decoder families at full width, and the
    tree head on K1; see the module docstring (phase 2f).  Returns K1
    onehot's launches in the phase's window (the tree head's) and the
    largest disagreement of a class with K1's plain version."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfgs = cfgs or [get_config(a) for a in FAM_ARCHS]
    hymba, xlstm, whisper = cfgs
    K.reset_launches()
    fam_serve_engine(hymba, dev, card, [(FAM_REQUESTS, FAM_PROMPT, FAM_NEW),
                                        (FAM_BATCH, FAM_LONG_PROMPT, FAM_LONG_NEW)])
    torch.cuda.empty_cache()
    fam_serve_engine(xlstm, dev, card, [(FAM_REQUESTS, FAM_PROMPT, FAM_NEW)])
    torch.cuda.empty_cache()
    fam_card_vs_cpu(dev, card)
    check(sum(K.LAUNCHES.values()) == 0, f"the families launched kernels of ours: {K.LAUNCHES}")
    head = fam_whisper(whisper, dev, card)
    torch.cuda.empty_cache()
    print(f"[lm-families] phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return head


# ---------------------------------------------------------------------------
# phase 2g: the hybrid, xLSTM and encoder-decoder families trained at full width
# ---------------------------------------------------------------------------


FAM_TRAIN_STEPS = {"hybrid": 4, "ssm": 4, "audio": 2}   # whisper's encoder runs 375 attention blocks a layer
FAM_TRAIN_WHISPER_LAYERS = 8   # of 24 encoder and 24 decoder layers, at full width: the smoke's time
FAM_TRAIN_SEQ, FAM_TRAIN_BATCH = 128, 4
FAM_TRAIN_TAG = "[lm-families-train]"
LM_FAMILIES_TRAIN_RESULT = FAM_TRAIN_TAG + " result "
LM_FAMILIES_TRAIN_TIMEOUT_S = 900


def fam_train_ranges(family: str):
    """The profiler ranges of the hybrid's or the xLSTM's train step and the
    kinds they name: the train step's, and the SSM's or the xLSTM's
    sequence functions."""
    from repro_torch.models.layers import ssm as lm_ssm
    from repro_torch.models.layers import xlstm as lm_xl

    ranges = lm_train_ranges()
    if family == "hybrid":
        return ranges + [(lm_ssm, "ssm_apply", "lm.ssm")], {"lm.ssm": "elementwise in the SSM"}
    return (ranges + [(lm_xl, "mlstm_apply", "lm.mlstm"), (lm_xl, "slstm_apply", "lm.slstm")],
            {"lm.mlstm": "elementwise in the mLSTM", "lm.slstm": "elementwise in the sLSTM"})


def fam_train(cfg, dev, card) -> None:
    """One family at full width: ``build_model`` (f32 masters, seed 0, remat
    "full"), hymba's offload check, ``AdamWState``, ``train_loop`` for
    ``FAM_TRAIN_STEPS`` steps of B 4 x S 128, the gates, one step under the
    profiler; see the module docstring (phase 2g)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import LoopState, device_batch, make_train_step, train_loop

    gib = 2.0**30
    steps = FAM_TRAIN_STEPS[cfg.family]
    t0 = time.perf_counter()
    model = fam_build(cfg, dev, card, FAM_TRAIN_TAG)
    pipe = pipeline_for(cfg, ShapeConfig("train", FAM_TRAIN_SEQ, FAM_TRAIN_BATCH, "train"), seed=0)
    batches = lambda i: device_batch(pipe(i), dev)   # noqa: E731
    batch0 = batches(0)
    if cfg.family == "hybrid":
        remat_offload_check(model, batch0, card, FAM_TRAIN_TAG)
    opt = adamw_init(model)
    torch.cuda.synchronize()
    print(f"{FAM_TRAIN_TAG} {card}: {cfg.name} remat {model.parallel.remat!r}, with the AdamWState (m, v in f32): "
          f"memory allocated {torch.cuda.memory_allocated() / gib:.3f} GiB")
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=steps, ckpt_every=0)
    with torch.no_grad():
        before, _ = model.loss(batch0)
    before = float(before)
    train_step = make_train_step(model, tcfg)
    seen = []

    def step(m, o, b):
        out = train_step(m, o, b)
        torch.cuda.synchronize()
        seen.append(out[2])
        return out

    torch.cuda.reset_peak_memory_stats()
    state, report = train_loop(LoopState(model=model, opt_state=opt, step=0), step, batches, tcfg)
    peak = torch.cuda.max_memory_allocated() / gib
    tokens = FAM_TRAIN_BATCH * FAM_TRAIN_SEQ
    for i, (metrics, dt) in enumerate(zip(seen, report.step_times)):
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"{cfg.name} step {i}: {vals}")
        print(f"{FAM_TRAIN_TAG} {card}: {cfg.name} step {i}: loss {vals['loss']:.6f} (nll {vals['nll']:.6f}, aux "
              f"{vals['aux']:.6f}), grad norm {vals['grad_norm']:.6f}, lr {vals['lr']:.6g}, {dt * 1e3:.1f} ms (host "
              f"clock, after synchronize), {tokens / dt:,.0f} tokens/s")
    with torch.no_grad():
        after, _ = model.loss(batch0)
    after = float(after)
    err0 = abs(report.losses[0] - before) / abs(before)
    later = report.step_times[1:]
    print(f"{FAM_TRAIN_TAG} {card}: {cfg.name} {steps} steps of B {FAM_TRAIN_BATCH} x S {FAM_TRAIN_SEQ}: after the "
          f"first, mean {np.mean(later) * 1e3:.1f} ms a step, min {min(later) * 1e3:.1f} ms, first "
          f"{report.step_times[0] * 1e3:.1f} ms; {tokens / np.mean(later):,.0f} tokens/s; peak memory {peak:.3f} GiB "
          f"during the steps; loss on batch 0 {before:.6f} before, {after:.6f} after; step 0 reported "
          f"{report.losses[0]:.6f} (relative difference {err0:.3g} from model.loss just before it)")
    check(report.final_step == steps and report.restarts == 0, f"{cfg.name}: final step {report.final_step}")
    check(err0 <= LM_TRAIN_TOL, f"{cfg.name}: step 0's loss {report.losses[0]} is not model.loss {before}")
    check(np.isfinite(after) and after < before, f"{cfg.name}: the loss on batch 0 did not fall: {before} -> {after}")
    if cfg.family == "audio":
        print(f"{FAM_TRAIN_TAG} {card}: {cfg.name} one train step under the profiler: not measured (its encoder and "
              f"cross-attention run {cfg.encoder.n_frames // 4} blocks of 4 keys a layer, millions of kernels a step: "
              f"more events than one profiler session keeps)")
    else:
        ranges, kinds = fam_train_ranges(cfg.family)
        wall, device, by_kind = lm_profiled_kinds(lambda: train_step(model, opt, batches(steps)), ranges, kinds)
        print(f"{FAM_TRAIN_TAG} {card}: {cfg.name} one train step (B {FAM_TRAIN_BATCH} x S {FAM_TRAIN_SEQ}, forward "
              f"+ block recompute + backward + AdamW) under the profiler: {kinds_line(wall, device, by_kind)}")
    del state, opt, model
    torch.cuda.empty_cache()
    print(f"{FAM_TRAIN_TAG} {cfg.name} took {time.perf_counter() - t0:.1f} s on the host of {card}")


def phase_lm_families_train(dev, card, cfgs=None) -> dict:
    """The hybrid, xLSTM and encoder-decoder families trained at full width,
    one after another, then each one's smoke width on the card against the
    CPU; no kernel of ours launches.  See the module docstring (phase 2g)."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    K.reset_launches()
    if cfgs is None:
        cfgs = [get_config(a) for a in FAM_ARCHS]
        n = FAM_TRAIN_WHISPER_LAYERS
        cfgs = [dataclasses.replace(c, name=f"{c.name}-{n}+{n}L", n_layers=n,
                                    encoder=dataclasses.replace(c.encoder, n_layers=n))
                if c.family == "audio" else c for c in cfgs]
    for cfg in cfgs:
        fam_train(cfg, dev, card)
    for arch in ("hymba", "xlstm", "whisper"):
        fam_train_card_vs_cpu(dev, card, arch)
    check(sum(K.LAUNCHES.values()) == 0, f"training the families launched kernels of ours: {K.LAUNCHES}")
    print(f"{FAM_TRAIN_TAG} phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return {"k1_onehot_launches": 0, "max_abs_err": 0}


# ---------------------------------------------------------------------------
# phase 2d: the LM training path across the cards (one process a card)
# ---------------------------------------------------------------------------


DIST_ARCH_BIG = "yi-6b"
DIST_BATCH, DIST_SEQ = 8, 128          # granite: each data shard holds whole 512-token MoE groups
DIST_BIG_BATCH, DIST_BIG_SEQ, DIST_BIG_STEPS = 4, 128, 3
DIST_LOSS_TOL = 1e-4                   # tests/test_distributed.py::test_sharded_train_step_matches_single_device
DIST_GRAD_TOL = 1e-4                   # of each gradient leaf's max-abs
DIST_ADAMW_TOL = 1e-5                  # ROADMAP §3 item 17: AdamW from equal gradients, of each leaf's max-abs
# the bf16 witness: the sharded bf16 step against one device's microbatched
# by the batch shards rounds the same bf16 gradients and differs only in the
# order of f32 sums (0 at smoke width on the host, tests/test_torch_distributed.py)
DIST_WITNESS_LAYERS = 4
DIST_BF16_TOL = 1e-5                   # loss relative; each gradient leaf, of its max-abs
DIST_TAG = "[lm-dist]"
DIST_UNSPLIT = ("the granite step on 2x2 with the compute whole on each card of a 'model' row: 1,408.2-1,626.9 ms "
                "warm, peak 14.05 GiB a card (PERF.md section 5)")
LM_DIST_RESULT = DIST_TAG + " result "
LM_DIST_TIMEOUT_S = 900
DIST_RANK_TIMEOUT_S = 300


def dist_mesh_shape(cards: int) -> tuple[int, int]:
    """(data, model) of the ``[lm-dist]`` mesh: 1×1 on one card, 2×1 on two or
    three, 2×2 on four or more."""
    return (1, 1) if cards < 2 else (2, 1) if cards < 4 else (2, 2)


def dist_bytes(tensors) -> int:
    """The bytes of the blocks this rank holds."""
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes for t in tensors)


def dist_gather(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def dist_print(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def dist_cards_line(rank: int, card: str, what: str, per_rank: list, tag: str = DIST_TAG) -> None:
    gib = 2.0**30
    dist_print(rank, f"{tag} {card}: {what}: " + "; ".join(
        f"rank {r}: params {p['params'] / gib:.3f} GiB, grads {p['grads'] / gib:.3f} GiB, m+v "
        f"{p['mv'] / gib:.3f} GiB, peak {p['peak'] / gib:.3f} GiB" for r, p in enumerate(per_rank)))


def dist_granite(rank: int, world: int, mesh, card: str) -> dict:
    """granite-moe-3b-a800m at full width in f32 (as the JAX test's config:
    bf16 gradients round once a shard, not once a batch): the single-device
    step (rank 0), freed, then one sharded step on the same weights and
    batch; gradients and AdamW held against it; a second, warm step timed;
    K1 routing from the gathered thresholds."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.optim import adamw as lm_adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import device_batch, loss_and_grads

    dev = shd.mesh_device(mesh)
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    axes = shd.from_mesh(mesh)
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    batch = device_batch(pipeline_for(cfg, ShapeConfig("train", DIST_SEQ, DIST_BATCH, "train"), seed=0)(0), dev)
    gib = 2.0**30

    ref = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=dev, axes=axes)
        model.init(torch.Generator(device=dev).manual_seed(0))
        t0 = time.perf_counter()
        loss, aux, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref = {"loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
               "grad_norm": float(lm_adamw.global_norm(grads)),
               "grads": {n: g.to("cpu") for n, g in grads.items()}}
        print(f"{DIST_TAG} {card}: the single-device reference on rank 0's card ({cfg.name} in f32, vocab "
              f"padded to {model.v_pad} and {model.layers[0].moe.wi.shape[0]} experts for model={axes.model_size}): "
              f"loss {ref['loss']:.6f} (nll {ref['nll']:.6f}, aux {ref['aux']:.6f}), grad norm "
              f"{ref['grad_norm']:.6f}, forward + backward {ref_s * 1e3:.1f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB; freed before the sharded model is built", flush=True)
        del model, loss, aux, grads
    torch.cuda.empty_cache()
    dist.barrier()

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    before = {}
    for n, p in model.named_parameters():      # rank 0 keeps the weights on the host, for AdamW's check
        full = p.detach().full_tensor()
        if rank == 0:
            before[n] = full.to("cpu")
        del full
    opt = lm_adamw.adamw_init(model)
    decay = lm_adamw.default_decay_mask(model)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, aux, grads = loss_and_grads(model, batch)
    _, opt, stats = lm_adamw.adamw_apply(model, grads, opt, tcfg, decay_mask=decay)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    mine = {"params": dist_bytes(model.parameters()), "grads": dist_bytes(grads.values()),
            "mv": dist_bytes(list(opt.m.values()) + list(opt.v.values())),
            "peak": torch.cuda.max_memory_allocated(), "step_s": step_s}
    per_rank = dist_gather(mine)
    got = {"loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
           "grad_norm": float(stats["grad_norm"])}
    split = model.model_split(batch)
    how = {True: "split over 'model': sequence-parallel residual, vocab-sharded loss, expert-parallel MoE",
           False: "split over 'model' with the tokens alike on its ranks: vocab-sharded loss, expert-parallel MoE",
           None: "each batch shard computed whole on its card"}[split]
    dist_print(rank, f"{DIST_TAG} {card}: {cfg.name} at full width on a {shd.mesh_sizes(mesh)} mesh ({world} "
               f"card{'s' * (world > 1)}, {dist.get_backend()}), B {DIST_BATCH} x S {DIST_SEQ}, one sharded step "
               f"({how}; forward + block re-gather and recompute + backward + reduce-scatter + ZeRO-1 AdamW): loss "
               f"{got['loss']:.6f} (nll {got['nll']:.6f}, aux {got['aux']:.6f}), grad norm {got['grad_norm']:.6f}; step "
               + ", ".join(f"{p['step_s'] * 1e3:.1f}" for p in per_rank) + " ms by rank (host clock, after synchronize)")
    dist_cards_line(rank, card, "bytes of this rank's blocks and its peak during the step", per_rank)

    # gradients and AdamW, leaf by leaf, against the reference (rank 0 checks)
    worst = {"grad": (0.0, ""), "adamw": (0.0, ""), "step": (0.0, "")}
    scale = lm_adamw._clip_scale(stats["grad_norm"], tcfg.grad_clip)
    if rank == 0:
        ref_scale = lm_adamw._clip_scale(torch.tensor(ref["grad_norm"], device=dev), tcfg.grad_clip)
        loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        check(loss_err <= DIST_LOSS_TOL, f"the sharded loss {got['loss']} is not the reference's {ref['loss']}")
    noclip = dataclasses.replace(tcfg, grad_clip=float("inf"))
    for n, p in model.named_parameters():
        g = grads[n].full_tensor()
        after = p.detach().full_tensor()
        if rank == 0:
            rg = ref["grads"].pop(n).to(dev)
            m = float(rg.abs().max())
            err = float((g - rg).abs().max()) / max(m, 1e-30)
            worst["grad"] = max(worst["grad"], (err, n))
            check(err <= DIST_GRAD_TOL, f"gradient {n}: {err:.3g} of its max-abs {m:.3g}")
            # one device's AdamW on the sharded step's own gradients (clip
            # applied here with the sharded norm), then on the reference's
            for key, gg, sc in (("adamw", g, scale), ("step", rg, ref_scale)):
                p1 = {n: before[n].to(dev)}
                one = lm_adamw.adamw_init(p1)
                lm_adamw.adamw_apply(p1, {n: gg * sc}, one, noclip, decay_mask={n: decay[n]})
                pm = float(p1[n].abs().max())
                e = float((after - p1[n]).abs().max()) / max(pm, 1.0)
                worst[key] = max(worst[key], (e, n))
            del rg, p1, one
        del g, after
    if rank == 0:
        check(worst["adamw"][0] <= DIST_ADAMW_TOL, f"sharded AdamW differs from one device's on equal gradients: "
              f"{worst['adamw']}")
        print(f"{DIST_TAG} {card}: against the single-device step on the same weights and batch: loss relative "
              f"difference {loss_err:.3g} (tolerance {DIST_LOSS_TOL}), grad norm {got['grad_norm']:.6f} vs "
              f"{ref['grad_norm']:.6f}; largest gradient difference {worst['grad'][0]:.3g} of its leaf's max-abs "
              f"({worst['grad'][1]}; tolerance {DIST_GRAD_TOL}); AdamW (ZeRO-1, sharded) against one device's "
              f"AdamW on the same gradients: {worst['adamw'][0]:.3g} of max(1, max-abs) ({worst['adamw'][1]}; "
              f"tolerance {DIST_ADAMW_TOL}); whole step against the reference's gradients through one device's "
              f"AdamW: {worst['step'][0]:.3g} ({worst['step'][1]}; printed, not gated: ROADMAP §3 item 17)",
              flush=True)
    before.clear()
    del grads

    dist.barrier()
    t0 = time.perf_counter()
    loss, aux, grads = loss_and_grads(model, batch)
    lm_adamw.adamw_apply(model, grads, opt, tcfg, decay_mask=decay)
    torch.cuda.synchronize()
    warm = dist_gather(time.perf_counter() - t0)
    dist_print(rank, f"{DIST_TAG} {card}: a second sharded step on the same batch (warm): loss {float(loss):.6f}, "
               + ", ".join(f"{t * 1e3:.1f}" for t in warm) + f" ms by rank (host clock, after synchronize); peaks "
               + ", ".join(f"{p['peak'] / gib:.3f}" for p in per_rank) + f" GiB by rank; on "
               f"{shd.mesh_sizes(mesh)}, beside {DIST_UNSPLIT}")
    del loss, aux, grads

    # the hard route on K1 from the gathered thresholds
    stale = sum(r.stale for r in model.tree_routers())
    check(stale == cfg.n_layers, f"{stale} of {cfg.n_layers} routers stale after the sharded step")
    tokens = {"tokens": batch["tokens"]}
    try:
        with torch.no_grad(), model.on_batch_shards(tokens) as local:
            model.hidden(local, serve_hard_tree=True)
        fail("a stale router routed after the sharded step")
    except RuntimeError as e:
        check("changed since" in str(e), f"the stale router raised {e}")
    model.pack_routers()
    captured = []
    hooks = [r.register_forward_hook(lambda r, a, out: captured.append((r, a[0], a[1], out)))
             for r in model.tree_routers()]
    K.reset_launches()
    try:
        with torch.no_grad(), model.on_batch_shards(tokens) as local:
            x, _ = model.hidden(local, serve_hard_tree=True)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    launches = K.LAUNCHES["speculative/onehot"]
    check(launches == cfg.n_layers and sum(K.LAUNCHES.values()) == launches and bool(torch.isfinite(x).all()),
          f"rank {rank}: the hard route launched {dict(K.LAUNCHES)}")
    n_int = 2**cfg.moe.tree_depth() - 1
    err = 0
    for i, (router, h2, proj, experts) in enumerate(captured):
        z = lm_moe.router_features(h2, proj).reshape(-1, n_int)
        pk = router.packed
        plain = K.speculative_plain(sanitize_records(z), pk.attr_idx, pk.attr_select, pk.threshold, pk.child,
                                    pk.class_val, total_jumps=ops._total_jumps(pk.max_depth), jump_mode="onehot")
        check(torch.equal(experts.reshape(-1), plain), f"rank {rank} layer {i}: K1 routed otherwise than plain")
        err = max(err, max_abs_err(experts.reshape(-1), plain))
    total = sum(dist_gather(launches))
    routed = int(captured[0][1].numel() // cfg.d_model)
    dist_print(rank, f"{DIST_TAG} after the sharded step all {stale} routers are stale on every rank and the hard "
               f"route raises; pack_routers() packs them from the gathered router_thr; one hard-routed forward of "
               f"each rank's tokens ({local['tokens'].shape[0]} rows x {routed // local['tokens'].shape[0]} positions "
               f"a rank) launched K1 onehot {launches} times a rank ({total} in all), every route torch.equal to K1's "
               f"plain version on the same z")
    del model, opt, x, captured
    torch.cuda.empty_cache()
    return {"launches": total, "max_abs_err": err}


def dist_bf16(rank: int, world: int, mesh, card: str) -> None:
    """The bf16 witness: yi-6b at full width, cut to DIST_WITNESS_LAYERS
    layers, in its own bf16 activations (f32 parameters).  Rank 0 takes 3
    steps on one card twice, on the whole batch and microbatched by the
    number of batch shards; then every rank takes the same 3 steps sharded.
    The first step's loss and gradients are held against the microbatched
    step (the same bf16 roundings); the whole-batch step's difference and
    every step's loss are printed."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim import adamw as lm_adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import device_batch, loss_and_grads

    dev = shd.mesh_device(mesh)
    cfg = dataclasses.replace(get_config(DIST_ARCH_BIG), n_layers=DIST_WITNESS_LAYERS)
    axes = shd.from_mesh(mesh)
    shards = shd.BatchShards(mesh, shd.batch_dims(mesh, axes, DIST_BIG_BATCH)).count
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=DIST_BIG_STEPS)      # dist_yi's
    pipe = pipeline_for(cfg, ShapeConfig("train", DIST_BIG_SEQ, DIST_BIG_BATCH, "train"), seed=0)
    batches = [device_batch(pipe(i), dev) for i in range(DIST_BIG_STEPS)]

    def steps(model, microbatch: int):
        """3 train steps: (losses, the first step's gradients as DTensors or tensors)."""
        opt, decay = lm_adamw.adamw_init(model), lm_adamw.default_decay_mask(model)
        losses, first = [], None
        for b in batches:
            loss, _, grads = loss_and_grads(model, b, microbatch=microbatch)
            if first is None:
                first = {n: g.clone() for n, g in grads.items()}
            lm_adamw.adamw_apply(model, grads, opt, tcfg, decay_mask=decay)
            losses.append(float(loss))
        return losses, first

    ref = {}
    if rank == 0:
        for k in (shards, 1):
            model = build_model(cfg, device=dev, axes=axes)
            model.init(torch.Generator(device=dev).manual_seed(0))
            losses, grads = steps(model, k)
            ref[k] = (losses, {n: g.to("cpu") for n, g in grads.items()})
            del model, grads
            torch.cuda.empty_cache()
    dist.barrier()
    model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    losses, grads = steps(model, 0)
    worst = {k: (0.0, "") for k in (shards, 1)}
    for n in list(grads):
        g = grads.pop(n).full_tensor()
        if rank == 0:
            for k in worst:
                rg = ref[k][1][n].to(dev)
                err = float((g - rg).abs().max()) / max(float(rg.abs().max()), 1e-30)
                worst[k] = max(worst[k], (err, n))
            check(worst[shards][0] <= DIST_BF16_TOL, f"bf16 gradient {n}: {worst[shards][0]:.3g} of its max-abs "
                  f"from the step microbatched by the {shards} batch shards")
        del g
    if rank == 0:
        loss_err = abs(losses[0] - ref[shards][0][0]) / abs(ref[shards][0][0])
        check(loss_err <= DIST_BF16_TOL, f"the sharded bf16 loss {losses[0]} is not the microbatched one's "
              f"{ref[shards][0][0]}")
        fmt = lambda xs: ", ".join(f"{x:.6f}" for x in xs)      # noqa: E731
        print(f"{DIST_TAG} {card}: the bf16 witness: {cfg.name} at full width and {cfg.n_layers} of its "
              f"{get_config(DIST_ARCH_BIG).n_layers} layers, {cfg.dtype} activations, B {DIST_BIG_BATCH} x S "
              f"{DIST_BIG_SEQ} over {shards} batch shards of the {shd.mesh_sizes(mesh)} mesh, seed 0. First step: "
              f"the sharded step against one card's microbatched by {shards}: loss {loss_err:.3g} relative, "
              f"gradients {worst[shards][0]:.3g} of their leaf's max-abs at most ({worst[shards][1]}; tolerance "
              f"{DIST_BF16_TOL}); against one card's whole batch: gradients {worst[1][0]:.3g} ({worst[1][1]}; "
              f"printed: one device rounds the whole batch's bf16 gradient once). Losses of {DIST_BIG_STEPS} steps "
              f"(lr {tcfg.lr:g}, warmup {tcfg.warmup_steps}): sharded {fmt(losses)}; one card microbatched "
              f"{fmt(ref[shards][0])}; one card whole batch {fmt(ref[1][0])}; ln(vocab {cfg.vocab_size}) = "
              f"{math.log(cfg.vocab_size):.6f}", flush=True)
    ref.clear()
    del model
    torch.cuda.empty_cache()


def dist_yi(rank: int, world: int, mesh, card: str) -> None:
    """yi-6b at full width on a 2×2 mesh: 3 sharded train steps."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_apply, adamw_init, default_decay_mask
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import LoopState, device_batch, loss_and_grads, train_loop

    dev = shd.mesh_device(mesh)
    cfg = get_config(DIST_ARCH_BIG)
    axes = shd.from_mesh(mesh)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(model)
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=DIST_BIG_STEPS, ckpt_every=0)
    pipe = pipeline_for(cfg, ShapeConfig("train", DIST_BIG_SEQ, DIST_BIG_BATCH, "train"), seed=0)
    decay = default_decay_mask(model)
    seen = []

    def timed_step(m, o, b):      # make_train_step's step, the gradients' bytes read on the way
        loss, _, grads = loss_and_grads(m, b)
        grad_bytes = dist_bytes(grads.values())
        m, o, stats = adamw_apply(m, grads, o, tcfg, decay_mask=decay)
        del grads
        torch.cuda.synchronize()
        seen.append({"lr": float(stats["lr"]), "grad_norm": float(stats["grad_norm"]), "grad_bytes": grad_bytes})
        return m, o, {"loss": loss, **stats}

    torch.cuda.reset_peak_memory_stats()
    state, report = train_loop(LoopState(model=model, opt_state=opt, step=0), timed_step,
                               lambda i: device_batch(pipe(i), dev), tcfg)
    params = list(model.parameters())
    whole = {"2d": 0, "1d": 0, "replicated": 0}
    for p in params:
        n_sharded = sum(isinstance(pl, Shard) for pl in p.placements)
        whole["2d" if n_sharded == 2 else "1d" if n_sharded == 1 else "replicated"] += p.numel() * p.element_size()
    check(len({x["grad_bytes"] for x in seen}) == 1, f"rank {rank}: gradient bytes {seen}")
    mine = {"params": dist_bytes(params), "grads": seen[0]["grad_bytes"],
            "mv": dist_bytes(list(opt.m.values()) + list(opt.v.values())),
            "peak": torch.cuda.max_memory_allocated(), "times": report.step_times, "losses": report.losses}
    per_rank = dist_gather(mine)
    cap = torch.cuda.get_device_properties(dev).total_memory
    for r, p in enumerate(per_rank):
        check(all(np.isfinite(x) for x in p["losses"]), f"rank {r}: losses {p['losses']}")
        check(p["params"] <= whole["2d"] / 4 + whole["1d"] / 2 + whole["replicated"],
              f"rank {r} holds {p['params']} parameter bytes, more than a quarter of the sharded leaves")
        check(p["peak"] < cap, f"rank {r}: peak {p['peak']} of {cap}")
    gib = 2.0**30
    n_params = sum(p.numel() for p in params)
    dist_print(rank, f"{DIST_TAG} {card}: {cfg.name} at full width ({n_params:,} f32 parameters, seed 0) on a "
               f"{shd.mesh_sizes(mesh)} mesh, {DIST_BIG_STEPS} steps of B {DIST_BIG_BATCH} x S {DIST_BIG_SEQ}: "
               f"losses " + ", ".join(f"{x:.6f}" for x in per_rank[0]["losses"]) + " (lr "
               + ", ".join(f"{x['lr']:g}" for x in seen) + ", grad norm " + ", ".join(f"{x['grad_norm']:.4f}" for x in seen)
               + f"; ln(vocab {cfg.vocab_size}) = {math.log(cfg.vocab_size):.6f}); step times "
               + ", ".join(f"{t * 1e3:.1f}" for t in per_rank[0]["times"]) + " ms (rank 0, host clock, after "
               f"synchronize); the whole state: parameters {4 * n_params / gib:.3f} GiB, their 2-D-sharded leaves "
               f"{whole['2d'] / gib:.3f} GiB, 1-D {whole['1d'] / gib:.3f}, replicated {whole['replicated'] / gib:.4f}")
    dist_cards_line(rank, card, "bytes of this rank's blocks (gradients as each step's loss_and_grads returned "
                    "them, freed after its AdamW) and its peak during the steps", per_rank)
    del state, model, opt
    torch.cuda.empty_cache()


def lm_dist_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of ``[lm-dist]``: a card of its own, NCCL through a FileStore
    (the kernel library is already built by the process that spawned it)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S),
                            device_id=torch.device("cuda", rank))
    try:
        card = card_line()
        mesh = make_test_mesh(*dist_mesh_shape(world))
        result = dist_granite(rank, world, mesh, card)
        if world >= 4:          # the split over a 'model' row of four
            more = dist_granite(rank, world, make_test_mesh(1, 4), card)
            result = {"launches": result["launches"] + more["launches"],
                      "max_abs_err": max(result["max_abs_err"], more["max_abs_err"])}
        if world >= 2:          # a 'model' axis of 1: one card microbatched by the batch shards is its premise
            dist_bf16(rank, world, make_test_mesh(world, 1), card)
        else:
            dist_print(rank, f"{DIST_TAG} the bf16 witness needs 2 cards (a sharded step against one card's); "
                       f"{world} here, so it did not run")
        if world >= 4:
            dist_yi(rank, world, make_test_mesh(2, 2), card)
        else:
            dist_print(rank, f"{DIST_TAG} {DIST_ARCH_BIG} at full width needs 4 cards (a 2x2 mesh: its f32 "
                       f"parameters, gradients and AdamW moments come to about 97 GB); {world} here, so it did not run")
        if rank == 0:
            Path(out).write_text(json.dumps({"k1_onehot_launches": result["launches"],
                                             "max_abs_err": result["max_abs_err"]}))
        dist.barrier()
    except BaseException:
        # leave at once: the other ranks wait in a collective that will not
        # come, and the spawning process ends them when this one exits
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def phase_lm_dist(card) -> dict:
    """The multi-card LM training path, one process a card (module docstring, phase 2d)."""
    import tempfile

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    world = int(np.prod(dist_mesh_shape(cards)))
    tmp = tempfile.mkdtemp(prefix="lm_dist_")
    try:
        out = os.path.join(tmp, "result.json")
        print(f"{DIST_TAG} {cards} card{'s' * (cards > 1)} present: {world} rank{'s' * (world > 1)} on a "
              f"{dist_mesh_shape(cards)} (data, model) mesh", flush=True)
        torch.multiprocessing.spawn(lm_dist_rank, args=(world, os.path.join(tmp, "store"), out), nprocs=world,
                                    join=True)
        result = json.loads(Path(out).read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{DIST_TAG} phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return result


# ---------------------------------------------------------------------------
# phase 2s: the hybrid SSM, xLSTM and encoder-decoder split over 'model'
# across four cards (one process a card)
# ---------------------------------------------------------------------------


FDIST_TAG = "[families-dist]"
FDIST_ARCHS = ("hymba-1.5b", "xlstm-125m")
FDIST_WHISPER = "whisper-medium"
FDIST_WHISPER_LAYERS = 4            # of its 24 + 24: the encoder's 1,500 frames dominate the phase's time
FDIST_MESHES = ((2, 2), (1, 4))
FDIST_BATCH, FDIST_SEQ, FDIST_NEW = 8, 128, 8
FDIST_CARDS = 4
FDIST_RESULT = FDIST_TAG + " result "
FDIST_TIMEOUT_S = 1500
# the archs whose split gradients are held to an f64 step on the same
# weights: within DIST_GRAD_TOL of it, or twice the single-device f32 step's
# distance from it where that is more (the mLSTM's exponential gates amplify
# the f32 rounding of its contractions, which a split reorders)
FDIST_F64_ARCHS = ("xlstm-125m",)
FDIST_F64_TIMEOUT_S = 300
# the f64 step, in a process that imports an f64 copy of the port
FDIST_F64_SCRIPT = """
import dataclasses, sys
import torch
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.train import device_batch, loss_and_grads
arch, d, m, seq, batch, weights, out, dev = sys.argv[1:9]
cfg = dataclasses.replace(get_config(arch), dtype="float32")     # f64 in this copy
model = build_model(cfg, device=dev, axes=shd.MeshAxes(("data",), "model", {"data": int(d), "model": int(m)}))
state = torch.load(weights, weights_only=True)
model.load_state_dict({k: v.double() if v.is_floating_point() else v for k, v in state.items()})
data = device_batch(pipeline_for(cfg, ShapeConfig("train", int(seq), int(batch), "train"), seed=0)(0), dev)
loss, _, grads = loss_and_grads(model, data)
torch.save({"loss": float(loss), "grads": {n: g.cpu() for n, g in grads.items()}}, out)
"""


def fdist_cfg(arch: str):
    """The phase's f32 config of ``arch``: full width; whisper's depth cut."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if arch == FDIST_WHISPER:
        cfg = dataclasses.replace(cfg, n_layers=FDIST_WHISPER_LAYERS,
                                  encoder=dataclasses.replace(cfg.encoder, n_layers=FDIST_WHISPER_LAYERS))
    return cfg


def f64_copy(dst: str) -> str:
    """A copy of ``src/repro_torch`` under ``dst`` computing in f64: every
    ``torch.float32`` and ``.float()`` made f64 (the configs' "float32"
    then names f64 too); returns ``dst``.  ``tests/torch_f64_probe.py``
    makes its copies with it too."""
    import re

    pkg = os.path.join(dst, "repro_torch")
    shutil.copytree(Path(__file__).resolve().parent / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                text = re.sub(r"torch\.float32", "torch.float64", Path(path).read_text())
                Path(path).write_text(text.replace(".float()", ".double()"))
    return dst


def fdist_f64(cfg, mesh, model, dev) -> dict:
    """The f64 step of ``cfg`` on ``model``'s weights and the phase's batch,
    on ``dev``, in a process of its own (an f64 copy of the port):
    {"loss", "grads" (f64, on the host)}."""
    import tempfile

    from repro_torch.parallel import sharding as shd

    sizes = shd.mesh_sizes(mesh)
    with tempfile.TemporaryDirectory(prefix="fdist_f64_") as tmp:
        weights, out = os.path.join(tmp, "weights.pt"), os.path.join(tmp, "f64.pt")
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, weights)
        env = dict(os.environ, PYTHONPATH=f64_copy(os.path.join(tmp, "src")))
        proc = subprocess.run([sys.executable, "-c", FDIST_F64_SCRIPT, cfg.name, str(sizes["data"]),
                               str(sizes["model"]), str(FDIST_SEQ), str(FDIST_BATCH), weights, out, str(dev)],
                              env=env, capture_output=True, text=True, timeout=FDIST_F64_TIMEOUT_S)
        check(proc.returncode == 0, f"the f64 step exited {proc.returncode}: {proc.stderr[-2000:]}")
        return torch.load(out, weights_only=False)


def fdist_step(rank: int, world: int, mesh, cfg, card: str, keep: bool = False):
    """``cfg``'s train step split over the mesh's 'model' against rank 0's
    single-device step on the same weights (seed 0) and batch: loss within
    DIST_LOSS_TOL relative, every gradient within DIST_GRAD_TOL of its
    leaf's max-abs (FDIST_F64_ARCHS: the split's within that of the f64
    step, or twice the single-device f32 step's distance from it where
    that is more); each rank's
    bytes, peak and step time, then a warm step's.  Returns the sharded
    model with ``keep``."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import build_model
    from repro_torch.optim import adamw as lm_adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import device_batch, loss_and_grads

    dev = shd.mesh_device(mesh)
    axes = shd.from_mesh(mesh)
    tcfg = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    batch = device_batch(pipeline_for(cfg, ShapeConfig("train", FDIST_SEQ, FDIST_BATCH, "train"), seed=0)(0), dev)
    gib = 2.0**30
    where = f"{cfg.name} on a {shd.mesh_sizes(mesh)} mesh"
    ref = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=dev, axes=axes)
        model.init(torch.Generator(device=dev).manual_seed(0))
        t0 = time.perf_counter()
        loss, aux, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref = {"loss": float(loss), "grads": {n: g.to("cpu") for n, g in grads.items()}}
        print(f"{FDIST_TAG} {card}: {where}: the single-device reference on rank 0's card: loss {ref['loss']:.6f}, "
              f"forward + backward {ref_s * 1e3:.1f} ms, peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB",
              flush=True)
        if cfg.name in FDIST_F64_ARCHS:
            t0 = time.perf_counter()
            ref["f64"] = fdist_f64(cfg, mesh, model, dev)
            print(f"{FDIST_TAG} {card}: {where}: the f64 step on the same weights and batch (an f64 copy of the port "
                  f"in a process of its own on rank 0's card, {time.perf_counter() - t0:.1f} s): loss "
                  f"{ref['f64']['loss']:.9f}", flush=True)
        del model, loss, aux, grads
    torch.cuda.empty_cache()
    dist.barrier()
    model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt = lm_adamw.adamw_init(model)
    decay = lm_adamw.default_decay_mask(model)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, aux, grads = loss_and_grads(model, batch)
    lm_adamw.adamw_apply(model, grads, opt, tcfg, decay_mask=decay)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    per_rank = dist_gather({"params": dist_bytes(model.parameters()), "grads": dist_bytes(grads.values()),
                            "mv": dist_bytes(list(opt.m.values()) + list(opt.v.values())),
                            "peak": torch.cuda.max_memory_allocated(), "step_s": step_s})
    split = model.model_split(batch)
    check(split is not None, f"{where}: the step did not split over 'model'")
    worst = {"ref": (0.0, ""), "split-f64": (0.0, ""), "ref-f64": (0.0, "")}
    f64 = ref is not None and "f64" in ref
    for n in list(grads):
        g = grads.pop(n).full_tensor()
        if rank == 0:
            rg = ref["grads"].pop(n).to(dev)
            m = float(rg.abs().max())
            err = float((g - rg).abs().max()) / max(m, 1e-30)
            worst["ref"] = max(worst["ref"], (err, n))
            if f64:
                g64 = ref["f64"]["grads"].pop(n).to(dev)
                m64 = max(float(g64.abs().max()), 1e-30)
                worst["split-f64"] = max(worst["split-f64"], (float((g.double() - g64).abs().max()) / m64, n))
                worst["ref-f64"] = max(worst["ref-f64"], (float((rg.double() - g64).abs().max()) / m64, n))
                del g64
            else:
                check(err <= DIST_GRAD_TOL, f"{where}: gradient {n}: {err:.3g} of its max-abs {m:.3g}")
            del rg
        del g
    if rank == 0:
        tol, gated = DIST_GRAD_TOL, f"tolerance {DIST_GRAD_TOL}"
        if f64:
            tol, gated = max(DIST_GRAD_TOL, 2 * worst["ref-f64"][0]), "not gated: the split is held to the f64 step"
            print(f"{FDIST_TAG} {card}: {where}: distances from the f64 step, of each leaf's max-abs: the split step "
                  f"{worst['split-f64'][0]:.3g} ({worst['split-f64'][1]}; tolerance {tol:.3g}: twice the "
                  f"single-device f32 step's, at least {DIST_GRAD_TOL}), the single-device f32 step "
                  f"{worst['ref-f64'][0]:.3g} ({worst['ref-f64'][1]})", flush=True)
            check(worst["split-f64"][0] <= tol, f"{where}: gradient {worst['split-f64'][1]}: "
                  f"{worst['split-f64'][0]:.3g} of its max-abs from the f64 step's, past {tol:.3g}")
        loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        check(loss_err <= DIST_LOSS_TOL, f"{where}: the split loss {float(loss)} is not the reference's {ref['loss']}")
        how = "sequence-split residual" if split else "the ranks of 'model' holding the same tokens"
        print(f"{FDIST_TAG} {card}: {where} ({world} cards, nccl), B {FDIST_BATCH} x S {FDIST_SEQ}, one step split "
              f"over 'model' ({how}; forward + backward + ZeRO-1 AdamW): loss {float(loss):.6f}, "
              f"{loss_err:.3g} relative from the single-device step's (tolerance {DIST_LOSS_TOL}); largest gradient "
              f"difference {worst['ref'][0]:.3g} of its leaf's max-abs ({worst['ref'][1]}; {gated}); "
              "step " + ", ".join(f"{p['step_s'] * 1e3:.1f}" for p in per_rank) + " ms by rank (host clock, after "
              "synchronize)", flush=True)
    dist_cards_line(rank, card, f"{where}: bytes of this rank's blocks and its peak during the step", per_rank,
                    FDIST_TAG)
    del grads, loss, aux
    dist.barrier()
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(model, batch)
    lm_adamw.adamw_apply(model, grads, opt, tcfg, decay_mask=decay)
    torch.cuda.synchronize()
    warm = dist_gather(time.perf_counter() - t0)
    check(bool(np.isfinite(float(loss))), f"{where}: the warm step's loss is {float(loss)}")
    dist_print(rank, f"{FDIST_TAG} {card}: {where}: a second step on the same batch (warm): loss {float(loss):.6f}, "
               + ", ".join(f"{t * 1e3:.1f}" for t in warm) + " ms by rank (host clock, after synchronize)")
    del grads, loss, opt
    if not keep:
        del model
        model = None
    torch.cuda.empty_cache()
    return model


def fdist_serve(rank: int, mesh, cfg, plans: dict, card: str) -> None:
    """``cfg``'s serving model (``launch.specs.plan_cell``, the dry-run's)
    split over 'model': prefill B FDIST_BATCH x S FDIST_SEQ and a decode
    step counted (``utils.op_cost``), their collectives by kind equal to
    the fake mesh's plan; each rank's cache leaves its block of
    ``cache_specs`` (JAX's); then prefill and FDIST_NEW greedy decode steps
    timed."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models import build_model
    from repro_torch.models.schema import cache_leaves
    from repro_torch.parallel import sharding as shd

    gib = 2.0**30
    dev = shd.mesh_device(mesh)
    sizes = shd.mesh_sizes(mesh)
    where = f"{cfg.name} served on a {sizes} mesh"
    model = plan_cell(cfg, ShapeConfig("fd_prefill", FDIST_SEQ, FDIST_BATCH, "prefill"),
                      shd.from_mesh(mesh)).model.distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(11)
    prompt = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (FDIST_BATCH, FDIST_SEQ),
                                                      dtype=np.int32)).to(dev)}
    max_len = FDIST_SEQ + FDIST_NEW
    for kind in ("prefill", "decode"):
        row = plans[kind]
        if kind == "prefill":
            real = dryrun_real(lambda: model.prefill(prompt), (model, prompt))
        else:
            logits, cache = model.prefill(prompt, max_len=max_len)
            whole = cache_leaves(build_model(cfg, device="meta").cache_shapes(FDIST_BATCH, max_len))
            specs = model.cache_specs(FDIST_BATCH)
            got = cache_leaves(cache)
            check(set(got) == set(whole), f"{where}: cache leaves {sorted(got)}, whole {sorted(whole)}")
            mine = want = 0
            for path, leaf in got.items():
                spec = specs
                for part in path.split("."):
                    spec = spec[int(part)] if part.isdigit() else getattr(spec, part)
                block = spec_block(tuple(whole[path].shape), spec, sizes)
                check(tuple(leaf.shape) == block, f"rank {rank} {where}: cache {path} {tuple(leaf.shape)}, "
                      f"cache_specs' block {block}")
                mine += leaf.numel() * leaf.element_size()
                want += int(np.prod(block)) * leaf.element_size()
            check(mine == want, f"rank {rank} {where}: cache bytes {mine}, cache_specs' block {want}")
            dist_print(rank, f"{FDIST_TAG} {card}: {where}: rank {rank}'s decode cache ({len(got)} leaves, "
                       f"max_len {max_len}): {mine:,} bytes ({mine / gib:.4f} GiB), its block of cache_specs "
                       f"{want:,} bytes; e.g. {next(iter(got))} {tuple(next(iter(got.values())).shape)}")
            tok = dist_next_tokens(model.gathered_logits(logits, prompt), mesh)
            real = dryrun_real(lambda: model.decode_step(cache, {"tokens": tok}), (model, cache, {"tokens": tok}))
        counts = dict(sorted(real["cost"].coll_count.items()))
        dist_print(rank, f"{FDIST_TAG} {card}: {where}: {kind} on rank {rank}: collectives counted {counts}, planned "
                   f"{row['collectives']}; peak {real['peak'] / gib:.3f} GiB, planned {row['fit_bytes'] / gib:.3f} "
                   f"GiB; FLOPs counted {real['cost'].flops:.6e}, planned {row['flops_per_card']:.6e}; "
                   f"{real['s'] * 1e3:.1f} ms (uncounted run)")
        check(counts == row["collectives"], f"rank {rank} {where} {kind}: collectives {counts}, planned "
              f"{row['collectives']}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, max_len=max_len)
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    steps, batch = [], prompt
    for _ in range(FDIST_NEW):
        tok = dist_next_tokens(model.gathered_logits(logits, batch), mesh)
        batch = {"tokens": tok}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits).all()), f"{where}: decode logits are not finite")
    dist_print(rank, f"{FDIST_TAG} {card}: {where}, rank {rank}: prefill {pre * 1e3:.1f} ms, {FDIST_NEW} greedy "
               f"decode steps {', '.join(f'{s * 1e3:.1f}' for s in steps)} ms (host clock after synchronize); "
               f"peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB")
    del model, cache, logits
    torch.cuda.empty_cache()


def fdist_tree_head(rank: int, mesh, model, cfg, card: str) -> dict:
    """The tree token head on whisper's encoder output, a frame a record:
    each rank classifies its batch rows (``tree_head_classify``, K1 onehot,
    one launch), its classes ``torch.equal`` to K1's plain version on the
    same ``z``; the ranks' classes, gathered over 'data', equal to K1 on one
    card over the gathered encoder output (a comparison launch, not
    counted)."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models import schema as lm_schema
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.models.layers import tree_head as th
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import device_batch

    dev = shd.mesh_device(mesh)
    batch = device_batch(pipeline_for(cfg, ShapeConfig("train", FDIST_SEQ, FDIST_BATCH, "train"), seed=0)(0), dev)
    with torch.no_grad(), model.on_batch_shards(batch) as local:
        enc = model.encode(local["embeds"])
    hcfg = dataclasses.replace(cfg, tree_head_classes=FAM_TREE_CLASSES)
    depth = th.tree_head_depth(FAM_TREE_CLASSES)
    n_int = 2**depth - 1
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {name: lm_schema.init_leaf_(torch.empty(s.shape, dtype=s.dtype, device=dev), s, gen)
              for name, s in lm_schema.leaves(th.tree_head_schema(hcfg))}
    K.reset_launches()
    classes = th.tree_head_classify(params, enc, cfg=hcfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["speculative/onehot"] == 1 and sum(launches.values()) == 1,
          f"rank {rank}: the tree head launched {launches}, not K1 onehot once")
    z = sanitize_records(lm_moe.router_features(enc, params["proj"]).reshape(-1, n_int))
    packed = th.pack_tree_head(hcfg, params["thr"])
    tabs = (packed.attr_idx, packed.attr_select, packed.threshold, packed.child, packed.class_val)
    jumps = ops._total_jumps(depth)
    plain = K.speculative_plain(z, *tabs, total_jumps=jumps, jump_mode="onehot")
    check(torch.equal(classes.reshape(-1), plain), f"rank {rank}: the tree head classed "
          f"{int((classes.reshape(-1) != plain).sum())} frames otherwise than K1's plain version")
    group = mesh.get_group(0)
    n = dist.get_world_size(group)
    enc_all = torch.empty((n * enc.shape[0], *enc.shape[1:]), dtype=enc.dtype, device=dev)
    dist.all_gather_into_tensor(enc_all, enc.contiguous(), group=group)
    cls_all = torch.empty((n * classes.shape[0], *classes.shape[1:]), dtype=classes.dtype, device=dev)
    dist.all_gather_into_tensor(cls_all, classes.contiguous(), group=group)
    one = th.tree_head_classify(params, enc_all, cfg=hcfg)        # one card over every row: a comparison launch
    check(torch.equal(cls_all, one), f"rank {rank}: the gathered classes differ from one card's over the gathered "
          f"encoder output in {int((cls_all != one).sum())} frames")
    dist_print(rank, f"{FDIST_TAG} {card}: {cfg.name}'s tree head ({FAM_TREE_CLASSES} classes, depth {depth}) on a "
               f"{shd.mesh_sizes(mesh)} mesh: rank {rank} classed its {enc.shape[0]} rows x {enc.shape[1]} frames "
               f"(M {classes.numel()}) on K1 onehot (1 launch), torch.equal to K1's plain version; gathered over "
               f"'data' ({cls_all.numel()} frames) torch.equal to one card's K1 over the gathered encoder output; "
               f"classes per id {torch.bincount(cls_all.reshape(-1).long(), minlength=FAM_TREE_CLASSES).tolist()}")
    return {"launches": launches["speculative/onehot"], "max_abs_err": max_abs_err(classes.reshape(-1), plain)}


def families_dist_rank(rank: int, world: int, store: str, plan_path: str, out: str) -> None:
    """One rank of ``[families-dist]``: a card of its own, NCCL through a FileStore."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh

    specs.TP_MIN_PARAMS = 0     # the plan's size policy would run xlstm-125m data-parallel only
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S),
                            device_id=torch.device("cuda", rank))
    try:
        card = card_line()
        plans = json.loads(Path(plan_path).read_text())
        launches, err = 0, 0
        for arch in (FDIST_ARCHS[0], FDIST_WHISPER, *FDIST_ARCHS[1:]):
            cfg = fdist_cfg(arch)
            for shape in FDIST_MESHES:
                mesh = make_test_mesh(*shape)
                if arch == FDIST_WHISPER:
                    model = fdist_step(rank, world, mesh, cfg, card, keep=True)
                    head = fdist_tree_head(rank, mesh, model, cfg, card)
                    del model
                    torch.cuda.empty_cache()
                    launches += sum(dist_gather(head["launches"]))
                    err = max(err, head["max_abs_err"])
                else:
                    fdist_step(rank, world, mesh, cfg, card)
                    fdist_serve(rank, mesh, cfg, plans[f"{arch} {shape[0]}x{shape[1]}"], card)
        if rank == 0:
            Path(out).write_text(json.dumps({"k1_onehot_launches": launches, "max_abs_err": err}))
        dist.barrier()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def phase_families_dist(card) -> dict:
    """The hybrid, xLSTM and encoder-decoder families split over 'model' on
    four cards (module docstring, phase 2s); on fewer one line says it did
    not run."""
    import tempfile

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards < FDIST_CARDS:
        print(f"{FDIST_TAG} hymba-1.5b, xlstm-125m and whisper-medium split over 'model' on 2x2 and 1x4 meshes need "
              f"{FDIST_CARDS} cards; {cards} here, so it did not run", flush=True)
        return {"k1_onehot_launches": 0, "max_abs_err": 0}
    from repro_torch.models.layers.xlstm import mlstm_layout

    specs.TP_MIN_PARAMS = 0     # as the ranks: xlstm-125m split over 'model', not data-parallel only
    plans = {}
    for arch in FDIST_ARCHS:
        cfg = fdist_cfg(arch)
        for d, m in FDIST_MESHES:
            key = f"{arch} {d}x{m}"
            plans[key] = {}
            layout = "" if cfg.xlstm is None else (f", mLSTM layout {mlstm_layout(cfg, m)} (each rank its rows of "
                                                   "w_if, the gate logits summed over 'model')")
            for kind, seq in (("prefill", FDIST_SEQ), ("decode", FDIST_SEQ + FDIST_NEW)):
                row = dryrun_plan(cfg, ShapeConfig(f"fd_{kind}", seq, FDIST_BATCH, kind), mesh=f"{d}x{m}")
                plans[key][kind] = row
                print(f"{FDIST_TAG} {key} {kind} (B {FDIST_BATCH}, S {seq}) planned on a fake mesh in "
                      f"{row['plan_s']:.1f} s: split {row['model_split']}{layout}, collectives {row['collectives']}, "
                      f"peak {row['fit_bytes'] / 2**30:.3f} GiB, {row['flops_per_card']:.6e} FLOPs a card", flush=True)
    tmp = tempfile.mkdtemp(prefix="families_dist_")
    try:
        plan_path, out = os.path.join(tmp, "plan.json"), os.path.join(tmp, "result.json")
        Path(plan_path).write_text(json.dumps(plans))
        torch.multiprocessing.spawn(families_dist_rank, args=(FDIST_CARDS, os.path.join(tmp, "store"), plan_path, out),
                                    nprocs=FDIST_CARDS, join=True)
        result = json.loads(Path(out).read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{FDIST_TAG} phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return result


# ---------------------------------------------------------------------------
# [dryrun]: the dry-run's plan (fake process group, fake tensors, counted ops)
# held against the real steps on the card
# ---------------------------------------------------------------------------


DRYRUN_TAG = "[dryrun]"
DRYRUN_PEAK_RTOL = 0.10          # the plan's peak against max_memory_allocated
DRYRUN_CACHE = LM_PROMPT + LM_NEW   # decode: one token against a 160-deep cache, as the served run's last step
DRYRUN_CLI = ("--arch", LM_ARCH, "--shape", "decode_32k", "--mesh", "single")   # one production cell
DRYRUN_CLI_TIMEOUT_S = 300
DRYRUN_RESULT = DRYRUN_TAG + " result "
DRYRUN_TIMEOUT_S = 900
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_BATCH, PHI_PROMPT, PHI_NEW = 8, 128, 8   # 4 rows x 128 a batch shard: whole 512-token MoE groups
PHI_WITNESS_LAYERS = 4
PHI_WITNESS_BATCH = 16   # on 4x1: 4 rows x 128 a batch shard, whole 512-token MoE groups
PHI_SPLIT_TOL = 1e-4     # the f32 witness split over 'model': logits, of their max-abs
PHI_CARDS = 4
PHI_UNSPLIT = "unsplit: 452 all-gathers a decode step (every weight gathered over 'model'), PERF.md section 6"


def dryrun_plan(cfg, shape, mesh: str = "1x1") -> dict:
    """The row of ``cfg``'s cell planned on a fake ``mesh`` (``launch.dryrun``),
    its collectives as counts by kind."""
    from repro_torch.launch import dryrun

    row = dryrun.run_cell(cfg.name, shape, mesh=mesh, cfg=cfg, verbose=False)
    row["collectives"] = {k: v["count"] for k, v in row["collectives"].items()}
    return row


def dryrun_real(fn, held) -> dict:
    """``fn`` (one step) on the card: once under the counter, then once more
    for its time and its peak.  ``held`` are the step's arguments (weights,
    optimizer state, cache, batch); the peak is ``max_memory_allocated``
    less what the process holds besides them.  ``k1`` is K1's launches in
    the counted run, ``k1_total`` those of both runs, read after the
    second."""
    from repro_torch.utils.op_cost import OpCost

    K.reset_launches()
    with OpCost() as cost:
        cost.track(*held)
        out = fn()
        del out
        torch.cuda.synchronize()
    k1 = K.LAUNCHES["speculative/onehot"]
    args = OpCost()
    args.track(*held)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - args.live_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del out
    raw = torch.cuda.max_memory_allocated()
    return {"cost": cost, "k1": k1, "k1_total": K.LAUNCHES["speculative/onehot"], "s": dt, "raw_peak": raw,
            "peak": raw - other}


def dryrun_hold(cfg, shape, row, real: dict, card, chips: int = 1) -> None:
    """Print the plan beside the real step and gate: FLOPs equal, K1 ops equal
    to the launches, the plan's peak within 10% of the real one."""
    gib = 2.0**30
    cost = real["cost"]
    what = f"{cfg.name} {row['step']} B {shape.global_batch} x S {shape.seq_len}"
    print(f"{DRYRUN_TAG} {card}: {what}: plan on a fake {row['mesh']} mesh in {row['plan_s']:.1f} s on the host: "
          f"{row['flops_per_card']:.6e} FLOPs, {row['bytes_per_card']:.6e} bytes, peak {row['fit_bytes'] / gib:.3f} "
          f"GiB, {row['k1_ops']} K1 ops, collectives {row['coll_summary']}; the real step on the card, counted: "
          f"{cost.flops:.6e} FLOPs, {cost.bytes:.6e} bytes, {real['k1']} K1 launches, collectives "
          f"{cost.coll_summary()}; max_memory_allocated {real['raw_peak'] / gib:.3f} GiB, {real['peak'] / gib:.3f} "
          f"GiB of it the step's (its arguments and what it allocates), plan/real {row['fit_bytes'] / real['peak']:.4f}")
    print(f"{DRYRUN_TAG} {card}: {what}: roofline at the H100's peaks (launch/roofline.py): compute "
          f"{row['compute_s'] * 1e3:.4f} ms, memory {row['memory_s'] * 1e3:.4f} ms, collective "
          f"{row['collective_s'] * 1e3:.4f} ms, dominant {row['dominant']}, useful ratio {row['useful_ratio']:.4f}, "
          f"planned roofline fraction {row['roofline_fraction']:.6f}; measured step {real['s'] * 1e3:.1f} ms (host "
          f"clock after synchronize, uncounted), measured roofline fraction "
          f"{roofline.measured_fraction(row['model_flops'], chips, real['s']):.6f} (model FLOPs "
          f"{row['model_flops']:.6e} / {chips} card{'s' * (chips > 1)} at {roofline.PEAK_BF16 / 1e12:.0f} TFLOP/s "
          f"bf16 over the measured step)")
    if cost.bytes != row["bytes_per_card"]:
        planned = row["bytes_by_op"]
        diff = sorted(((name, cost.bytes_by_op.get(name, 0.0) - planned.get(name, 0.0))
                       for name in set(cost.bytes_by_op) | set(planned)), key=lambda kv: -abs(kv[1]))
        print(f"{DRYRUN_TAG} {what}: bytes real - plan by op: "
              f"{', '.join(f'{n} {d:+.0f}' for n, d in diff[:6] if d)}")
    check(cost.flops == row["flops_per_card"],
          f"{what}: the real step's FLOPs {cost.flops:.6e} are not the plan's {row['flops_per_card']:.6e}")
    check(cost.k1 == row["k1_ops"] == real["k1"],
          f"{what}: K1 {cost.k1} counted, {row['k1_ops']} planned, {real['k1']} launched")
    check(abs(row["fit_bytes"] - real["peak"]) <= DRYRUN_PEAK_RTOL * real["peak"],
          f"{what}: the plan's peak {row['fit_bytes'] / gib:.3f} GiB is not within {DRYRUN_PEAK_RTOL:.0%} of the "
          f"card's {real['peak'] / gib:.3f} GiB")


def dryrun_train_check(model, opt, train_step, batch, cfg, card) -> int:
    """The ``[lm-train]`` cell (B 4 x S 128) planned on a fake 1x1 mesh and
    held against the real step on the card (module docstring, ``[dryrun]``).
    The two real steps train ``model`` on: call it when nothing else reads
    the trained weights.  Returns K1's launches in both steps."""
    from repro_torch.configs import ShapeConfig

    shape = ShapeConfig("lm_train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    row = dryrun_plan(cfg, shape)
    real = dryrun_real(lambda: train_step(model, opt, batch), (model, opt, batch))
    dryrun_hold(cfg, shape, row, real, card)
    return real["k1_total"]


def dryrun_serve_check(dev, cfg, card) -> dict:
    """The ``[lm-serve]`` cells, prefill B 4 x S 128 and one decode step of B
    4 against a 160-deep cache, on the serving model (bf16 weights,
    ``launch.specs.serving_config``), each planned on a fake 1x1 mesh and
    held against the real step on the card.  Returns K1's launches, those
    of the counted and the timed runs of both cells."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.specs import serving_config
    from repro_torch.models import build_model

    scfg = serving_config(cfg)
    model = build_model(scfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)).to(dev)
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, 1), dtype=np.int32)).to(dev)
    launches = 0
    shape = ShapeConfig("lm_prefill", LM_PROMPT, LM_BATCH, "prefill")
    row = dryrun_plan(cfg, shape)
    real = dryrun_real(lambda: model.prefill({"tokens": prompt}), (model, {"tokens": prompt}))
    dryrun_hold(scfg, shape, row, real, card)
    launches += real["k1_total"]
    shape = ShapeConfig("lm_decode", DRYRUN_CACHE, LM_BATCH, "decode")
    row = dryrun_plan(cfg, shape)
    cache = model.init_cache(LM_BATCH, DRYRUN_CACHE)._replace(pos=DRYRUN_CACHE - 1)
    real = dryrun_real(lambda: model.decode_step(cache, {"tokens": step}), (model, cache, {"tokens": step}))
    dryrun_hold(scfg, shape, row, real, card)
    launches += real["k1_total"]
    del model, cache
    torch.cuda.empty_cache()
    return {"k1_onehot_launches": launches}


def dryrun_cli(card) -> None:
    """One full-size production cell through the CLI (granite's decode_32k on
    the 16x16 mesh), in a child process with its own time limit: its rows
    and its wall time."""
    import tempfile

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CLI, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                              timeout=DRYRUN_CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if not line.startswith("[rank0]:W"):
                print(f"{DRYRUN_TAG} cli: {line}")
        check(proc.returncode == 0, f"python -m repro_torch.launch.dryrun exited with {proc.returncode}")
        rows = json.loads(Path(out).read_text())
    planned = [r for r in rows if "dominant" in r]
    print(f"{DRYRUN_TAG} {card}: python -m repro_torch.launch.dryrun {' '.join(DRYRUN_CLI)}: "
          f"{len(planned)} cell planned in {wall:.1f} s wall on the host "
          f"(plan seconds {', '.join(f'{r['shape']} {r['plan_s']:.1f}' for r in planned)})")
    check(len(planned) == 1 and planned[0]["flops_per_card"] > 0 and planned[0]["k1_ops"] > 0,
          f"the CLI planned {len(planned)} cells")


def dist_next_tokens(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's greedy next ids from each rank's rows of the
    logits (every vocabulary column: ``DecoderModel.gathered_logits``): this
    rank's argmax, all-gathered over the batch shards ('data')."""
    import torch.distributed as dist

    local = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).contiguous()
    group = mesh.get_group(0)
    out = torch.empty((local.shape[0] * dist.get_world_size(group), 1), dtype=torch.int32, device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    return out


def spec_block(shape, spec, sizes: dict) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` under a JAX spec."""
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[i] //= sizes[a]
    return tuple(out)


def phi_full(rank: int, mesh, plans: dict, card: str) -> dict:
    """phi3.5-moe-42b-a6.6b at full width in bf16 on the 2x2 mesh, its step
    split over 'model': a card's parameter bytes and cache bytes (JAX's
    ``cache_specs`` block), the prefill's and a decode step's collectives
    and peak against the dry-run's plan of the same cells; then the served
    flow (prefill, ``PHI_NEW`` greedy decode steps).  Returns K1's launches
    read on this rank: the counted and timed runs of both cells and the
    served flow."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.specs import plan_cell
    from repro_torch.parallel import sharding as shd

    gib = 2.0**30
    dev = shd.mesh_device(mesh)
    cfg = get_config(PHI_ARCH)
    t0 = time.perf_counter()
    model = plan_cell(cfg, ShapeConfig("phi_prefill", PHI_PROMPT, PHI_BATCH, "prefill"),
                      shd.from_mesh(mesh)).model.distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    param_bytes = sum(p.to_local().numel() * p.element_size() for p in model.parameters())
    dist_print(rank, f"{DRYRUN_TAG} {card}: {PHI_ARCH} at full width in bf16 on a 2x2 NCCL mesh, built on meta, "
               f"placed and drawn in {built:.1f} s: {param_bytes:,} parameter bytes on rank {rank} "
               f"({param_bytes / gib:.3f} GiB), the plan's {plans['prefill']['param_bytes_per_card']:,}")
    check(param_bytes == plans["prefill"]["param_bytes_per_card"] == plans["decode"]["param_bytes_per_card"],
          f"rank {rank} holds {param_bytes} parameter bytes, the plan {plans['prefill']['param_bytes_per_card']}")
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PHI_BATCH, PHI_PROMPT), dtype=np.int32)).to(dev)
    prompt = {"tokens": ids}
    out = {}
    for kind in ("prefill", "decode"):
        row = plans[kind]
        if kind == "prefill":
            real = dryrun_real(lambda: model.prefill(prompt), (model, prompt))
        else:
            logits, cache = model.prefill(prompt, max_len=PHI_PROMPT + PHI_NEW)
            layout, msize, _ = model.cache_split()
            whole = (cfg.n_layers, PHI_BATCH, PHI_PROMPT + PHI_NEW, cfg.n_kv_heads, cfg.head_dim_)
            want = spec_block(whole, model.cache_specs(PHI_BATCH).kv.k, shd.mesh_sizes(mesh))
            cache_bytes = 2 * cache.kv.k.numel() * cache.kv.k.element_size()
            want_bytes = 2 * int(np.prod(want)) * cache.kv.k.element_size()
            dist_print(rank, f"{DRYRUN_TAG} {card}: {PHI_ARCH} decode cache on rank {rank}: K and V "
                       f"{tuple(cache.kv.k.shape)} each, split by {layout} over model={msize}: {cache_bytes:,} bytes "
                       f"({cache_bytes / gib:.4f} GiB) apart from the parameters; JAX's cache_specs block {want}: "
                       f"{want_bytes:,} bytes")
            check(tuple(cache.kv.k.shape) == want and cache_bytes == want_bytes,
                  f"rank {rank}: cache {tuple(cache.kv.k.shape)}, JAX's block {want}")
            tok = dist_next_tokens(model.gathered_logits(logits, prompt), mesh)
            real = dryrun_real(lambda: model.decode_step(cache, {"tokens": tok}), (model, cache, {"tokens": tok}))
        counts = {k: v for k, v in sorted(real["cost"].coll_count.items())}
        dist_print(rank, f"{DRYRUN_TAG} {card}: {PHI_ARCH} {kind} (B {PHI_BATCH}, prompt {PHI_PROMPT}) on rank "
                   f"{rank}: collectives counted {counts}, planned {row['collectives']}; peak "
                   f"{real['peak'] / gib:.3f} GiB (max_memory_allocated {real['raw_peak'] / gib:.3f}), planned "
                   f"{row['fit_bytes'] / gib:.3f} GiB (plan/real {row['fit_bytes'] / real['peak']:.4f}); FLOPs "
                   f"counted {real['cost'].flops:.6e}, planned {row['flops_per_card']:.6e}; "
                   f"{real['s'] * 1e3:.1f} ms (uncounted); K1 launches {real['k1']}, planned {row['k1_ops']}")
        if kind == "decode":
            dist_print(rank, f"{DRYRUN_TAG} {card}: {PHI_ARCH} a decode step's all-gathers on rank {rank}: "
                       f"{real['cost'].coll_count.get('all-gather', 0)} ops, "
                       f"{real['cost'].coll_bytes.get('all-gather', 0.0) / 1e9:.3f} GB; {PHI_UNSPLIT}")
        check(counts == row["collectives"], f"rank {rank} {kind}: collectives {counts}, planned {row['collectives']}")
        check(abs(row["fit_bytes"] - real["peak"]) <= DRYRUN_PEAK_RTOL * real["peak"],
              f"rank {rank} {kind}: peak {real['peak']} against the plan's {row['fit_bytes']}")
        check(real["k1"] == row["k1_ops"], f"rank {rank} {kind}: {real['k1']} K1 launches, {row['k1_ops']} planned")
        out[kind] = real["k1_total"]
    # the served flow: prefill, then greedy decode steps
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, max_len=PHI_PROMPT + PHI_NEW)
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    steps = []
    batch = prompt
    for _ in range(PHI_NEW):
        tok = dist_next_tokens(model.gathered_logits(logits, batch), mesh)
        batch = {"tokens": tok}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits).all()), "phi's decode logits are not finite")
    dist_print(rank, f"{DRYRUN_TAG} {card}: {PHI_ARCH} served on the 2x2 mesh, rank {rank}: prefill "
               f"{pre * 1e3:.1f} ms, {PHI_NEW} greedy decode steps "
               f"{', '.join(f'{s * 1e3:.1f}' for s in steps)} ms (host clock after synchronize); peak "
               f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB")
    out["served"] = K.LAUNCHES["speculative/onehot"]
    del model, cache, logits
    torch.cuda.empty_cache()
    return {"k1": sum(out.values())}


def phi_witness(rank: int, mesh, tmp: str, card: str, *, dtype: str, batch: int, tol: float | None) -> None:
    """phi3.5-moe at 4 of its 32 layers, sharded on ``mesh``, against one
    card's prefill and greedy decode microbatched by the batch shards (one
    device's program on each shard's rows, its MoE groups the same): the
    prefill logits and each decode step's, fed the reference's greedy
    tokens, within ``tol`` of their max-abs (bit-equal where ``tol`` is
    None); the sharded run's own greedy tokens printed beside the
    reference's.  Rank 0 takes the single-card run first."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import serving_axes, serving_config
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd

    dev = shd.mesh_device(mesh)
    full = dataclasses.replace(get_config(PHI_ARCH), dtype=dtype)
    cfg = dataclasses.replace(serving_config(full), n_layers=PHI_WITNESS_LAYERS)
    axes = serving_axes(full, shd.from_mesh(mesh))      # the full model's placement, not the cut one's
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(0, full.vocab_size, (batch, PHI_PROMPT), dtype=np.int32)).to(dev)
    shards = mesh.size(0)
    rows = batch // shards
    ref_path = os.path.join(tmp, f"phi_witness_{dtype}.pt")
    if rank == 0:
        ref = build_model(cfg, device=dev, axes=axes).init(torch.Generator(device=dev).manual_seed(0))
        want = []
        for s in range(shards):
            logits, cache = ref.prefill({"tokens": ids[s * rows:(s + 1) * rows]}, max_len=PHI_PROMPT + PHI_NEW)
            got = {"prefill": logits.cpu(), "decode": [], "tokens": []}
            for _ in range(PHI_NEW):
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                got["tokens"].append(tok.cpu())
                logits, cache = ref.decode_step(cache, {"tokens": tok})
                got["decode"].append(logits.cpu())
            want.append(got)
        torch.save(want, ref_path)
        del ref, cache, logits
        torch.cuda.empty_cache()
    dist.barrier()
    every = torch.load(ref_path, weights_only=False)
    me = mesh.get_coordinate()[0]
    want = every[me]
    model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
    model.init(torch.Generator(device=dev).manual_seed(0))
    step = {"tokens": ids}
    logits, cache = model.prefill(step, max_len=PHI_PROMPT + PHI_NEW)

    def diff(got, ref) -> float:
        got = model.gathered_logits(got, step).cpu()
        return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    errs = [diff(logits, want["prefill"])]
    agree = 0
    for t in range(PHI_NEW):
        mine = dist_next_tokens(model.gathered_logits(logits, step), mesh)[me * rows:(me + 1) * rows]
        agree += int(torch.equal(mine.cpu(), want["tokens"][t]))
        step = {"tokens": torch.cat([w["tokens"][t] for w in every]).to(dev)}
        logits, cache = model.decode_step(cache, step)
        errs.append(diff(logits, want["decode"][t]))
    worst = max(errs)
    split = model.cache_split()[0]
    dist_print(rank, f"{DRYRUN_TAG} {card}: the witness, {PHI_ARCH} at full width and {PHI_WITNESS_LAYERS} of its "
               f"32 layers in {dtype}, on {shd.mesh_sizes(mesh)} ({'split over model, cache by ' + split if split else 'nothing split over model'}): "
               f"rank {rank}'s prefill logits and {PHI_NEW} decode steps' (fed one card's greedy tokens) against "
               f"one card's prefill and decode of its batch shard ({rows} of {batch} rows): largest difference "
               f"{worst:.3g} of the max-abs ({'bit-equal required' if tol is None else f'tolerance {tol:g}'}); its own "
               f"greedy tokens equal one card's in {agree} of {PHI_NEW} steps; one card's tokens "
               + " ".join(str(int(t[0, 0])) for t in want["tokens"]))
    check(worst == 0.0 if tol is None else worst <= tol,
          f"rank {rank}: the sharded witness differs from one card's microbatched run by {worst:.3g}")
    del model, cache, logits
    torch.cuda.empty_cache()


def phi_rank(rank: int, world: int, store: str, plan_path: str, out: str) -> None:
    """One rank of the four-card part of ``[dryrun]`` (NCCL through a FileStore)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S),
                            device_id=torch.device("cuda", rank))
    try:
        card = card_line()
        mesh = make_test_mesh(2, 2)
        result = phi_full(rank, mesh, json.loads(Path(plan_path).read_text()), card)
        phi_witness(rank, mesh, os.path.dirname(out), card, dtype="float32", batch=PHI_BATCH, tol=PHI_SPLIT_TOL)
        phi_witness(rank, make_test_mesh(4, 1), os.path.dirname(out), card, dtype="bfloat16",
                    batch=PHI_WITNESS_BATCH, tol=None)
        if rank == 0:
            Path(out).write_text(json.dumps(result))
        dist.barrier()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def phase_dryrun(card) -> dict:
    """``[dryrun]``'s own part (module docstring): the CLI on one full-size
    production cell, then on four cards phi3.5-moe served on 2x2 against
    its plan.  Returns K1's launches (the four-card part's, rank 0)."""
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config

    t_phase = time.perf_counter()
    dryrun_cli(card)
    cards = torch.cuda.device_count()
    launches = 0
    if cards < PHI_CARDS:
        print(f"{DRYRUN_TAG} {PHI_ARCH} served at full width on a 2x2 NCCL mesh needs {PHI_CARDS} cards (its bf16 "
              f"weights come to about 84 GB, 21 GB a card); {cards} here, so it did not run")
    else:
        cfg = get_config(PHI_ARCH)
        plans = {}
        for kind, seq in (("prefill", PHI_PROMPT), ("decode", PHI_PROMPT + PHI_NEW)):
            row = dryrun_plan(cfg, ShapeConfig(f"phi_{kind}", seq, PHI_BATCH, kind), mesh="2x2")
            plans[kind] = row
            print(f"{DRYRUN_TAG} {PHI_ARCH} {kind} planned on a fake 2x2 mesh in {row['plan_s']:.1f} s: "
                  f"{row['param_bytes_per_card']:,} parameter bytes a card, peak {row['fit_bytes'] / 2**30:.3f} GiB, "
                  f"collectives {row['collectives']}, {row['flops_per_card']:.6e} FLOPs a card, dominant "
                  f"{row['dominant']}")
        tmp = tempfile.mkdtemp(prefix="dryrun_phi_")
        try:
            plan_path, out = os.path.join(tmp, "plan.json"), os.path.join(tmp, "result.json")
            Path(plan_path).write_text(json.dumps(plans))
            torch.multiprocessing.spawn(phi_rank, args=(PHI_CARDS, os.path.join(tmp, "store"), plan_path, out),
                                        nprocs=PHI_CARDS, join=True)
            launches = json.loads(Path(out).read_text())["k1"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"{DRYRUN_TAG} phase took {time.perf_counter() - t_phase:.1f} s on the host of {card}")
    return {"k1_onehot_launches": launches, "max_abs_err": 0}


def run_lm_child(card, flag: str, result_prefix: str, timeout_s: int) -> dict:
    """One LM phase in a process of its own (``chip_smoke.py --lm-serve``,
    ``--lm-train``, ``--lm-families``, ``--lm-families-train``, ``--lm-dist``
    or ``--dryrun``): its weights are freed when it ends, and its profiler
    sessions do not count against the later phases' (a process's late
    sessions lose kernels).  Its lines are printed here; its result line is
    parsed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag],
                          stdout=subprocess.PIPE, text=True, timeout=timeout_s)
    result = None
    tag = result_prefix.split()[0]
    for line in proc.stdout.splitlines():
        if line.startswith(result_prefix):
            result = json.loads(line[len(result_prefix):])
        else:
            print(line)
    check(proc.returncode == 0 and result is not None,
          f"the {tag} phase exited with {proc.returncode} after {time.perf_counter() - t0:.1f} s")
    print(f"{tag} child process took {time.perf_counter() - t0:.1f} s on the host of {card}")
    return result


# ---------------------------------------------------------------------------
# [obs-smoke] and [examples]: the port's observability smoke and its five
# example scripts on the card
# ---------------------------------------------------------------------------


def phase_obs_smoke(card) -> dict:
    """``repro_torch.obs.smoke.main`` on the card (its engine's default
    devices), its artifacts in a temporary directory; every check it makes
    must pass and it must launch a forest kernel of ours.  Returns the
    launches of its window."""
    import contextlib
    import io
    import tempfile

    from repro_torch.obs import smoke

    K.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
        rc = smoke.main(["--out", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for line in out.getvalue().splitlines():
        print(f"[obs-smoke] {line}")
    print(f"[obs-smoke] {card}: python -m repro_torch.obs.smoke on the card: exit {rc} in {wall:.1f} s on the host; "
          f"launches {dict((k, v) for k, v in launches.items() if v)}")
    check(rc == 0, f"the observability smoke returned {rc}")
    check(any(v for k, v in launches.items() if k.startswith("fused_")),
          f"the observability smoke launched no forest kernel of ours: {launches}")
    return launches


EXAMPLES = ("quickstart", "segmentation_service", "serve_lm", "train_lm", "tree_router_moe")
EXAMPLE_LAUNCHES = "[examples] launches "
# runs an example as ``__main__`` in a child process, then prints the child's
# kernel launches (the parent cannot count them)
EXAMPLE_RUNNER = ("import json, runpy, sys; sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__'); "
                  "from repro_torch.kernels.tree_eval import kernel as K; "
                  f"print({EXAMPLE_LAUNCHES!r} + json.dumps(K.LAUNCHES))")
EXAMPLES_TIMEOUT_S = 600


def phase_examples(dev, card) -> dict:
    """The five ``examples/*_torch.py`` on the card with their default
    arguments, one after another, each in a child process of its own: every
    exit code 0, the quickstart's five EXACT MATCH lines; then the
    segmentation service's classifier on one image against ``eval_serial``.
    Returns the children's launches, summed."""
    import tempfile

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    total = {name: 0 for name in K.LAUNCHES}
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        env["TMPDIR"] = tmp       # train_lm's checkpoints
        for name in EXAMPLES:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER, str(root / "examples" / f"{name}_torch.py")],
                                  stdout=subprocess.PIPE, text=True, env=env, cwd=tmp, timeout=EXAMPLES_TIMEOUT_S)
            outs[name] = proc.stdout
            launches = {}
            for line in proc.stdout.splitlines():
                if line.startswith(EXAMPLE_LAUNCHES):
                    launches = json.loads(line[len(EXAMPLE_LAUNCHES):])
                else:
                    print(f"[examples] {name}: {line}")
            ran = dict((k, v) for k, v in launches.items() if v)
            print(f"[examples] {card}: examples/{name}_torch.py (default arguments) exit {proc.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s wall on the host; launches {ran}")
            check(proc.returncode == 0 and launches, f"examples/{name}_torch.py exited with {proc.returncode}")
            for k, v in launches.items():
                total[k] += v
    quick = outs["quickstart"]
    check(quick.count("EXACT MATCH") == 5 and "MISMATCH" not in quick,
          f"the quickstart printed {quick.count('EXACT MATCH')} EXACT MATCH lines, not 5")
    check(total["speculative/gather"] > 0 and total["data_parallel"] > 0 and total["speculative/onehot"] > 0,
          f"the examples did not launch K1 (gather, onehot) and K2: {total}")

    spec = importlib.util.spec_from_file_location("segmentation_service_torch",
                                                  root / "examples" / "segmentation_service_torch.py")
    service = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(service)
    data = make_segmentation(seed=0)
    enc = service.trained_tree(data)
    image, _ = replicated_dataset(data, M_IMAGE, seed=1)
    got = service.classifier(enc, dev)(image)
    want = eval_serial(enc, image)
    print(f"[examples] segmentation service's classifier on the card, image 0 ({M_IMAGE} records): "
          f"{int((got != want).sum())} classes differ from eval_serial")
    check(np.array_equal(got, want), "the segmentation service's classes differ from eval_serial")
    return total


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


def margin_rows(rows: list[dict], launches: dict) -> list[dict]:
    """The ``kernels`` entries of phase 6m's rows, with ``launches`` the main
    path's own margin launches (phase 6's in a full run, the 50-tree
    evaluator's in ``--margin``), never the timing loops'."""
    return [{"name": row["name"], "route": "cuda",
             "source": "src/repro_torch/kernels/tree_eval/csrc/cascade_margin.cu",
             "replaces": None,   # no TPU kernel: the JAX package leaves the margin to XLA's ops
             "launches": launches[row["name"].removeprefix("cascade_").removesuffix("_kernel")],
             **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            for row in rows]


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
    parser.add_argument("--lm-serve", action="store_true",
                        help="run phase 2l (the LM serving path) alone; the full run starts it so, in a child")
    parser.add_argument("--lm-train", action="store_true",
                        help="run phase 2t (the LM training path) alone; the full run starts it so, in a child")
    parser.add_argument("--lm-families", action="store_true",
                        help="run phase 2f (the hybrid, xLSTM and encoder-decoder families and the tree head) "
                             "alone; the full run starts it so, in a child")
    parser.add_argument("--lm-families-train", action="store_true",
                        help="run phase 2g (the hybrid, xLSTM and encoder-decoder families trained) alone; the "
                             "full run starts it so, in a child")
    parser.add_argument("--lm-dist", action="store_true",
                        help="run phase 2d (the LM trained across the cards, one process a card) alone; the full "
                             "run starts it so, in a child")
    parser.add_argument("--families-dist", action="store_true",
                        help="run phase 2s (hymba, xLSTM and whisper split over 'model' on four cards) alone; the "
                             "full run starts it so, in a child, where four cards are present")
    parser.add_argument("--margin", action="store_true",
                        help="run phase 6m (the cascade's margin pass) alone")
    parser.add_argument("--dryrun", action="store_true",
                        help="run [dryrun]'s own part (the dry-run CLI on one production cell; on four cards "
                             "phi3.5-moe served on 2x2 against its plan) alone; the full run starts it so, in a "
                             "child.  Its single-card checks run inside [lm-serve] and [lm-train]")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    if args.lm_serve:
        _build.build(K.SOURCE)
        print(LM_RESULT + json.dumps(phase_lm_serve(dev, card)))
        return
    if args.lm_train:
        _build.build(K.SOURCE)
        print(LM_TRAIN_RESULT + json.dumps(phase_lm_train(dev, card)))
        return
    if args.lm_families:
        _build.build(K.SOURCE)
        print(LM_FAMILIES_RESULT + json.dumps(phase_lm_families(dev, card)))
        return
    if args.lm_families_train:
        _build.build(K.SOURCE)
        print(LM_FAMILIES_TRAIN_RESULT + json.dumps(phase_lm_families_train(dev, card)))
        return
    if args.lm_dist:
        _build.build(K.SOURCE)
        print(LM_DIST_RESULT + json.dumps(phase_lm_dist(card)))
        return
    if args.families_dist:
        _build.build(K.SOURCE)
        print(FDIST_RESULT + json.dumps(phase_families_dist(card)))
        return
    if args.dryrun:
        _build.build(K.SOURCE)
        print(DRYRUN_RESULT + json.dumps(phase_dryrun(card)))
        return
    if args.margin:
        print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(json.dumps({"kernels": margin_rows(*phase_margin(dev, card))}))
        return
    print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.ptxas_report(K.SOURCE)
    print(f"[build] {_build.library_path(K.SOURCE).name} in {time.perf_counter() - t0:.1f} s on the host of {card}")
    for line in ptxas_lines(report):
        print(f"[build] {line}")
    lm = run_lm_child(card, "--lm-serve", LM_RESULT, LM_TIMEOUT_S)
    lm_train = run_lm_child(card, "--lm-train", LM_TRAIN_RESULT, LM_TRAIN_TIMEOUT_S)
    lm_families = run_lm_child(card, "--lm-families", LM_FAMILIES_RESULT, LM_FAMILIES_TIMEOUT_S)
    lm_families_train = run_lm_child(card, "--lm-families-train", LM_FAMILIES_TRAIN_RESULT,
                                     LM_FAMILIES_TRAIN_TIMEOUT_S)
    lm_dist = run_lm_child(card, "--lm-dist", LM_DIST_RESULT, LM_DIST_TIMEOUT_S)
    if torch.cuda.device_count() >= FDIST_CARDS:
        families_dist = run_lm_child(card, "--families-dist", FDIST_RESULT, FDIST_TIMEOUT_S)
    else:
        families_dist = phase_families_dist(card)
    lm_dryrun = run_lm_child(card, "--dryrun", DRYRUN_RESULT, DRYRUN_TIMEOUT_S)

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
    MARGIN.reset_launches()
    phase_cascade(dev, images + [mix], per_trees + [mix_per_tree], forest, card)
    phase_cascade_latency(dev, images + [mix], forest, card)
    margin_launches = dict(MARGIN.LAUNCHES)
    print(f"[service] margin-pass launches in phase 6: {margin_launches}")
    for name, count in margin_launches.items():
        check(count > 0, f"margin kernel {name} was not launched by the cascade")
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

    for name, count in phase_obs_smoke(card).items():
        launches[name] += count
    for name, count in phase_examples(dev, card).items():
        launches[name] += count

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
    for child in (lm, lm_train, lm_families, lm_families_train, lm_dist, families_dist, lm_dryrun):
        launches["speculative/onehot"] += child["k1_onehot_launches"]
        errs["speculative/onehot"] = max(errs["speculative/onehot"], child["max_abs_err"])
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
    kernels += margin_rows(phase_margin(dev, card)[0], margin_launches)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
