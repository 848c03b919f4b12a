"""CUDA kernels K1–K8 for classification-tree evaluation, with their plain versions.

The kernels live in ``csrc/tree_eval.cu`` (see its header for the bound and
the design); this module builds and loads that library at first launch and
wraps each kernel:

=====  =============================  ==============================================
 ID     wrapper                        replaces (``src/repro/kernels/tree_eval/kernel.py``)
=====  =============================  ==============================================
 K1     ``speculative``                ``speculative_pallas`` (Procedure 4/5)
 K2     ``data_parallel``              ``data_parallel_pallas`` (Procedure 3)
 K3     ``fused_speculative``          ``fused_speculative_pallas`` (forest, one launch)
 K4     ``fused_data_parallel``        ``fused_data_parallel_pallas`` (forest, one launch)
 K5     ``fused_votes_speculative``    ``fused_votes_speculative_pallas`` (forest votes)
 K6     ``fused_votes_data_parallel``  ``fused_votes_data_parallel_pallas`` (forest votes)
 K7     ``fused_speculative_q``        ``fused_speculative_q_pallas`` (K3 gather, narrow tables)
 K8     ``fused_data_parallel_q``      ``fused_data_parallel_q_pallas`` (K4, narrow tables)
=====  =============================  ==============================================

K5/K6 return the forest's (M, C) int32 vote counts instead of the (T, M)
per-tree classes; a class outside ``[0, C)`` casts no vote.  K7/K8 read the
quantized layout (``quant.QuantizedForest``) at its stored widths: int8,
int16 or int32 ``attr_idx``/``child``/``class_val`` and bf16, f16 or f32
thresholds, upcast as the tables are staged into shared memory.

A wrapper given CPU tensors returns its plain torch version (``*_plain``);
given CUDA tensors it checks them, allocates the output, launches the kernel
on the current stream and adds one to its entry of ``LAUNCHES`` (and of the
calling thread's count, inside ``thread_launches``).  There is no fallback:
a failed build or launch raises ``RuntimeError``; a tile that does not fit
raises ``TileError``.  K1 is a torch operator (``repro_torch::speculative``)
with a shape rule, so fake and meta tensors go through it without a launch
(``launch.dryrun`` plans the tree-routed MoE through it).

The speculative kernels K1/K3/K5/K7 give each record to one warp, with node
``n`` in slot ``n // 32`` of lane ``n % 32``: ``jump_slots`` says whether a
lane holds its nodes and their path in registers (N ≤ 64, jumps by warp
shuffles) or the warp keeps the path in shared memory.  The data-parallel
kernels K2/K4/K6/K8 have ``dp_threads`` threads a CTA, thread i owning rows
i and i + threads of each ``block_m``-row tile for every tree, and each
thread walks several of its (row, tree) descents at once over 8-byte packed
nodes.  The grid gives a CTA of K4/K6/K8 at most one record a thread until
the card is full (K2: two), so at M 65,536 and the default 256-row tile a
thread of K4/K6/K8 owns one row and the tile's second half stays empty;
the second row is walked where a CTA's run is longer than its threads
(K2, a larger M or a small ``block_m``).  Both stage
the tree tables once per CTA, in equal chunks of trees when the whole
forest does not fit beside the tile (``table_chunk``); ``smem_bytes`` sizes
the tile, and each launch is one whole wave of CTAs, each taking an equal
run of the records (``launch_grid``).

The speculative kernels' ``onehot`` form computes ``records @ attr_select``;
it is exact only on records passed through
``core.eval_speculative.sanitize_records`` (``ops`` does so before every
speculative launch of K1/K3/K5, in both jump modes).  K7 only gathers, so it
takes raw records, ±inf and NaN included, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from pathlib import Path

import torch

from repro_torch.core.eval_speculative import pointer_jump, speculative_node_eval
from repro_torch.core.forest import vote_counts
from repro_torch.kernels import _build
from repro_torch.kernels.tree_eval.ref import forest_eval_ref, tree_eval_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "tree_eval.cu"

SMEM_MAX = 232_448        # bytes of shared memory one CTA may opt into on sm_90
SMEM_TARGET = 48 * 1024   # needs no opt-in and leaves room for several CTAs an SM
DP_TILE_MAX = 1024        # rows of a data-parallel tile, two at most a thread (csrc kDpThreads = 512)
SPEC_WARPS = 8            # warps of a speculative CTA (csrc kSpecThreads = 32·8)
REGISTER_SLOTS = 2        # node slots a lane holds on the register path (N ≤ 64)
SELECT_REGISTERS = 40     # attr_select floats a lane holds there (csrc kSelectRegisters)
JUMP_MODES = ("gather", "onehot")

# Launches per kernel instantiation since the last reset_launches(): a run
# reads these to show that its main path went through the kernels.
LAUNCHES = {
    "speculative/gather": 0,
    "speculative/onehot": 0,
    "data_parallel": 0,
    "fused_speculative/gather": 0,
    "fused_speculative/onehot": 0,
    "fused_data_parallel": 0,
    "fused_votes_speculative/gather": 0,
    "fused_votes_speculative/onehot": 0,
    "fused_votes_data_parallel": 0,
    "fused_speculative_q/bfloat16": 0,
    "fused_speculative_q/float16": 0,
    "fused_speculative_q/float32": 0,
    "fused_data_parallel_q/bfloat16": 0,
    "fused_data_parallel_q/float16": 0,
    "fused_data_parallel_q/float32": 0,
}

# K7/K8's threshold storages: LAUNCHES suffix and the code the launch takes.
THR_CODES = {torch.float32: ("float32", 0), torch.float16: ("float16", 1), torch.bfloat16: ("bfloat16", 2)}
INDEX_DTYPES = (torch.int8, torch.int16, torch.int32)


_THREAD = threading.local()


class TileError(ValueError):
    """No record tile of the requested size fits a CTA's shared memory.

    The one refusal a tuner may score as an infinitely slow candidate: the
    kernel cannot run at that shape.  A failed build or launch is a
    ``RuntimeError`` and is never caught as this.
    """


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def thread_launches():
    """Count this thread's kernel launches inside the block, by ``LAUNCHES`` key.

    Yields a dict that fills as the block launches; ``LAUNCHES`` counts the
    same launches as always.  Launches of other threads (a server's request
    thread while a tuner measures on a worker) do not land in it.
    """
    outer = getattr(_THREAD, "counts", None)
    counts: dict[str, int] = {}
    _THREAD.counts = counts
    try:
        yield counts
    finally:
        _THREAD.counts = outer
        if outer is not None:
            for name, n in counts.items():
                outer[name] = outer.get(name, 0) + n


def jump_slots(n_nodes: int, n_attrs: int, jump_mode: str = "gather") -> int:
    """Register slots a lane of a speculative kernel holds, or 0 for the shared path.

    A warp evaluates one record at a time, node ``n`` in slot ``n // 32`` of
    lane ``n % 32``.  Up to ``REGISTER_SLOTS`` slots (N ≤ 64) a lane keeps
    its nodes' tables and path in registers and a pointer jump is ``k·k``
    warp shuffles; beyond, the path lives in shared memory (``2·k`` accesses
    a round and record), which is cheaper from k = 3 on.  The one-hot form also holds
    its ``k`` attr_select columns, ``A·k ≤ SELECT_REGISTERS`` floats.
    """
    k = max(1, -(-n_nodes // 32))
    if k > REGISTER_SLOTS or (jump_mode == "onehot" and n_attrs * k > SELECT_REGISTERS):
        return 0
    return k


def spec_warps(block_m: int) -> int:
    """Warps of a speculative CTA: one per record of the tile, ``SPEC_WARPS`` at most."""
    return min(SPEC_WARPS, block_m)


def dp_threads(block_m: int) -> int:
    """Threads of a data-parallel CTA: at most two rows of the tile a thread."""
    return -(-block_m // 2)


def _tile_words(algorithm: str, block_m: int, n_attrs: int, n_nodes: int, jump_mode: str, n_classes: int):
    """(words outside the tables, words of one tree's tables) of a tile."""
    if algorithm == "data_parallel":
        rows = -(-block_m * (n_attrs | 1) // 4) * 4   # odd row stride, padded to 16 bytes
        return rows + block_m * n_classes, 3 * n_nodes
    a4 = -(-n_attrs // 4) * 4           # record rows padded to 16 bytes
    paths = 0 if jump_slots(n_nodes, n_attrs, jump_mode) else 4 * n_nodes * spec_warps(block_m)
    fixed = block_m * a4 + paths + block_m * n_classes
    tree = n_nodes * (3 + (n_attrs if jump_mode == "onehot" else 1))
    return fixed, tree


def table_chunk(
    block_m: int, n_attrs: int, n_nodes: int, jump_mode: str = "gather", n_classes: int = 0,
    n_trees: int = 1, algorithm: str = "speculative",
) -> int:
    """Trees whose tables a CTA stages at once.

    All ``n_trees`` when they fit beside the rest of the tile in
    ``SMEM_TARGET`` (staged once per CTA); else the fewest equal chunks that
    do, one tree at least.
    """
    fixed, tree = _tile_words(algorithm, block_m, n_attrs, n_nodes, jump_mode, n_classes)
    fit = max(1, (SMEM_TARGET // 4 - fixed) // tree)
    n_trees = max(1, n_trees)
    chunks = -(-n_trees // fit)
    return -(-n_trees // chunks)


def smem_bytes(
    algorithm: str, block_m: int, n_attrs: int, n_nodes: int, jump_mode: str = "gather",
    n_classes: int = 0, n_trees: int = 1,
) -> int:
    """Dynamic shared memory of one CTA, in bytes.

    The one formula for it: the wrappers pass this count to the launch
    functions of ``csrc/tree_eval.cu``, whose kernels carve their layout
    out of it in this order.  Data-parallel: the record tile, ``block_m``
    rows of ``A | 1`` floats (an odd stride) padded to 16 bytes, then the
    tables of ``table_chunk`` trees (an 8-byte packed node and a class, 12
    bytes a node), then the vote kernel's (block_m, n_classes) int32 vote
    tile (``n_classes`` = 0 for the class kernels).  Speculative: the
    record tile with rows padded to a multiple of 4 floats, the tables of
    ``table_chunk`` trees (threshold, child, class_val, and attr_idx or the
    one-hot form's (A, N) attr_select), on the shared path (``jump_slots``
    0) two double-buffered N-int paths (two records a step) for each of
    ``spec_warps`` warps, then the vote tile.

    The quantized kernels K7/K8 take the ``gather`` footprint of K3/K4:
    their narrow tables are widened as they are staged into shared memory
    (off the inner loop), so a node costs what it does in K3 gather/K4
    whatever its stored width.
    """
    fixed, tree = _tile_words(algorithm, block_m, n_attrs, n_nodes, jump_mode, n_classes)
    chunk = table_chunk(block_m, n_attrs, n_nodes, jump_mode, n_classes, n_trees, algorithm)
    return 4 * (fixed + chunk * tree)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "k1_speculative": [_P] * 7 + [_I] * 9 + [_P],
    "k2_data_parallel": [_P] * 6 + [_I] * 7 + [_P],
    "k3_fused_speculative": [_P] * 7 + [_I] * 11 + [_P],
    "k4_fused_data_parallel": [_P] * 6 + [_I] * 9 + [_P],
    "k5_fused_votes_speculative": [_P] * 7 + [_I] * 12 + [_P],
    "k6_fused_votes_data_parallel": [_P] * 6 + [_I] * 10 + [_P],
    "k7_fused_speculative_q": [_P] * 6 + [_I] * 14 + [_P],
    "k8_fused_data_parallel_q": [_P] * 6 + [_I] * 13 + [_P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tree_eval_empty.argtypes = [_P]
    lib.tree_eval_empty.restype = ctypes.c_int
    lib.tree_eval_per_sm.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.tree_eval_per_sm.restype = ctypes.c_int
    lib.tree_eval_error_string.argtypes = [ctypes.c_int]
    lib.tree_eval_error_string.restype = ctypes.c_char_p
    return lib


def _check(
    records: torch.Tensor, tables: dict, algorithm: str, block_m: int, jump_mode: str,
    n_classes: int = 0,
):
    """Validate what a kernel is handed; returns (M, A, N, shared-memory bytes)."""
    if records.device.type != "cuda":
        raise ValueError(f"kernels take CPU or CUDA tensors, got {records.device}")
    if records.dtype != torch.float32 or records.dim() != 2 or not records.is_contiguous():
        raise ValueError(
            f"records must be contiguous 2-D float32, got {records.dtype} {tuple(records.shape)}"
        )
    m, a = records.shape
    if m > 2**31 - 1 - DP_TILE_MAX:
        raise ValueError(f"{m} records exceed one launch's int32 record count")
    for name, (t, dtypes, shape) in tables.items():
        if t.device != records.device:
            raise ValueError(f"{name} is on {t.device}, records on {records.device}")
        if t.dtype not in dtypes or tuple(t.shape) != shape or not t.is_contiguous():
            want = " or ".join(str(d) for d in dtypes)
            raise ValueError(
                f"{name} must be contiguous {want} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    lead = tables["threshold"][2]
    n, n_trees = lead[-1], (lead[0] if len(lead) == 2 else 1)
    return m, a, n, _tile_smem(algorithm, block_m, a, n, jump_mode, n_classes, n_trees)


def _tile_smem(
    algorithm: str, block_m: int, n_attrs: int, n_nodes: int, jump_mode: str, n_classes: int = 0,
    n_trees: int = 1,
) -> int:
    """Shared-memory bytes of a launchable tile; raises for a tile no CTA can hold."""
    if jump_mode not in JUMP_MODES:
        raise ValueError(f"unknown jump_mode {jump_mode!r}")
    if block_m < 1 or (algorithm == "data_parallel" and block_m > DP_TILE_MAX):
        raise ValueError(f"block_m={block_m} is not a valid {algorithm} tile")
    if n_classes < 0:
        raise ValueError(f"n_classes={n_classes} is negative")
    need = smem_bytes(algorithm, block_m, n_attrs, n_nodes, jump_mode, n_classes, n_trees)
    if need > SMEM_MAX:
        raise TileError(
            f"block_m={block_m} needs {need} B of shared memory for N={n_nodes}, "
            f"A={n_attrs}, C={n_classes}; a CTA has {SMEM_MAX} B"
        )
    return need


def _spec_launch(block_m: int, a: int, n: int, jump_mode: str, n_classes: int = 0, n_trees: int = 1):
    """(trees a chunk, warps a CTA, register slots) of a speculative launch."""
    return (table_chunk(block_m, a, n, jump_mode, n_classes, n_trees), spec_warps(block_m),
            jump_slots(n, a, jump_mode))


def _dp_launch(block_m: int, a: int, n: int, n_classes: int = 0, n_trees: int = 1):
    """(trees a chunk, threads a CTA) of a data-parallel launch."""
    return (table_chunk(block_m, a, n, "gather", n_classes, n_trees, "data_parallel"),
            dp_threads(block_m))


def launch_grid(
    kernel: int, variant: int, m: int, block_m: int, n_attrs: int, n_nodes: int,
    jump_mode: str = "gather", n_classes: int = 0, n_trees: int = 1, device=None,
) -> tuple[int, int]:
    """(CTAs, CTAs a SM) of a launch of kernel K``kernel`` (1–8; ``variant``
    is the one-hot flag of K1/K3/K5, the threshold code of K7/K8, else 0) on
    ``device`` (default the current card), as ``_launch`` sizes it there: the
    SMs times the CTAs one SM holds with this footprint, and at most one CTA
    per ``spec_warps`` records (speculative), per ``dp_threads`` records
    (K4/K6/K8) or per ``2·dp_threads`` (K2, two rows a thread), each CTA
    taking an equal run of the ``m`` records."""
    algorithm = "speculative" if kernel % 2 else "data_parallel"
    smem = smem_bytes(algorithm, block_m, n_attrs, n_nodes, jump_mode, n_classes, n_trees)
    if algorithm == "speculative":
        _, warps, slots = _spec_launch(block_m, n_attrs, n_nodes, jump_mode, n_classes, n_trees)
        threads, per_cta = 32 * warps, warps
    else:
        slots, threads = 0, dp_threads(block_m)
        per_cta = 2 * threads if kernel == 2 else threads
    per_sm = ctypes.c_int(0)
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    with torch.cuda.device(device):   # the occupancy query's smem opt-in is per device
        err = _library().tree_eval_per_sm(kernel, variant, slots, threads, smem, ctypes.byref(per_sm))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if err != 0:
        raise RuntimeError(f"occupancy of K{kernel} failed: CUDA error {err}")
    return min(sms * max(per_sm.value, 1), -(-m // per_cta)), per_sm.value


@functools.cache
def _launch_cost_ms(device: torch.device) -> float:
    lib = _library()
    best = float("inf")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for rep in range(6):
            t0 = time.perf_counter()
            for _ in range(64):
                err = lib.tree_eval_empty(stream)
                if err != 0:
                    raise RuntimeError(f"tree_eval_empty launch failed: CUDA error {err}")
            if rep:   # the first batch warms the path
                best = min(best, (time.perf_counter() - t0) * 1e3 / 64)
    return best


def launch_cost_ms(device) -> float:
    """Host milliseconds one kernel launch costs through this module's ctypes
    path on ``device``: the least mean over five batches of 64 launches of an
    empty kernel, measured once per process and device (the least, so that a
    batch slowed by another thread does not set it).  The tuner prices a
    candidate's launches with it (``tune.measure.score_ms``)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _launch_cost_ms(device)


def _launch(c_name: str, counter: str, tensors, ints) -> None:
    lib = _library()
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, c_name)(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        msg = lib.tree_eval_error_string(err).decode()
        raise RuntimeError(f"{c_name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[counter] += 1
    counts = getattr(_THREAD, "counts", None)
    if counts is not None:
        counts[counter] = counts.get(counter, 0) + 1


def _tables(attr_idx, threshold, child, class_val, lead, attr_select=None, n_attrs=0):
    """What ``_check`` expects of each table: (tensor, allowed dtypes, shape)."""
    n = threshold.shape[-1]
    tables = {
        "attr_idx": (attr_idx, (torch.int32,), lead + (n,)),
        "threshold": (threshold, (torch.float32,), lead + (n,)),
        "child": (child, (torch.int32,), lead + (n,)),
        "class_val": (class_val, (torch.int32,), lead + (n,)),
    }
    if attr_select is not None:
        tables["attr_select"] = (attr_select, (torch.float32,), lead + (n_attrs, n))
    return tables


def _q_tables(attr_idx, threshold, child, class_val):
    """What ``_check`` expects of K7/K8's (T, N) tables, at any stored width."""
    shape = tuple(threshold.shape)
    return {
        "attr_idx": (attr_idx, INDEX_DTYPES, shape),
        "threshold": (threshold, tuple(THR_CODES), shape),
        "child": (child, INDEX_DTYPES, shape),
        "class_val": (class_val, INDEX_DTYPES, shape),
    }


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_speculative_plain(
    records, attr_idx, attr_select, threshold, child, class_val, *, total_jumps: int, jump_mode: str
) -> torch.Tensor:
    """K3's function in plain torch: (T, N) tables → (T, M) int32."""
    if jump_mode not in JUMP_MODES:
        raise ValueError(f"unknown jump_mode {jump_mode!r}")
    path = speculative_node_eval(
        records, attr_idx, threshold, child,
        use_onehot_matmul=(jump_mode == "onehot"), attr_select=attr_select,
    )
    path = pointer_jump(path, total_jumps)
    return class_val.gather(-1, path[..., 0].long())


def speculative_plain(
    records, attr_idx, attr_select, threshold, child, class_val, *, total_jumps: int, jump_mode: str
) -> torch.Tensor:
    """K1's function in plain torch: (N,) tables → (M,) int32."""
    return fused_speculative_plain(
        records, attr_idx[None], attr_select[None], threshold[None], child[None],
        class_val[None], total_jumps=total_jumps, jump_mode=jump_mode,
    )[0]


def data_parallel_plain(records, attr_idx, threshold, child, class_val, *, max_depth: int):
    """K2's function in plain torch: ``max_depth`` rounds of descent, (M,) int32."""
    return tree_eval_ref(records, attr_idx, threshold, child, class_val, max_depth=max_depth)


def fused_data_parallel_plain(records, attr_idx, threshold, child, class_val, *, max_depth: int):
    """K4's function in plain torch: (T, N) tables → (T, M) int32."""
    return forest_eval_ref(records, attr_idx, threshold, child, class_val, max_depth=max_depth)


def fused_votes_speculative_plain(
    records, attr_idx, attr_select, threshold, child, class_val,
    *, n_classes: int, total_jumps: int, jump_mode: str,
) -> torch.Tensor:
    """K5's function in plain torch: K3's classes summed one-hot, (M, C) int32."""
    per_tree = fused_speculative_plain(
        records, attr_idx, attr_select, threshold, child, class_val,
        total_jumps=total_jumps, jump_mode=jump_mode,
    )
    return vote_counts(per_tree, n_classes)


def fused_votes_data_parallel_plain(
    records, attr_idx, threshold, child, class_val, *, n_classes: int, max_depth: int
) -> torch.Tensor:
    """K6's function in plain torch: K4's classes summed one-hot, (M, C) int32."""
    per_tree = fused_data_parallel_plain(
        records, attr_idx, threshold, child, class_val, max_depth=max_depth
    )
    return vote_counts(per_tree, n_classes)


def fused_speculative_q_plain(
    records, attr_idx, threshold, child, class_val, *, total_jumps: int
) -> torch.Tensor:
    """K7's function in plain torch: upcast the narrow tables, then K3 gather's."""
    return fused_speculative_plain(
        records, attr_idx.int(), None, threshold.float(), child.int(), class_val.int(),
        total_jumps=total_jumps, jump_mode="gather",
    )


def fused_data_parallel_q_plain(
    records, attr_idx, threshold, child, class_val, *, max_depth: int
) -> torch.Tensor:
    """K8's function in plain torch: upcast the narrow tables, then K4's descent."""
    return fused_data_parallel_plain(
        records, attr_idx.int(), threshold.float(), child.int(), class_val.int(), max_depth=max_depth
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::speculative", mutates_args=())
def _speculative_op(
    records: torch.Tensor, attr_idx: torch.Tensor, attr_select: torch.Tensor, threshold: torch.Tensor,
    child: torch.Tensor, class_val: torch.Tensor, total_jumps: int, jump_mode: str, block_m: int,
) -> torch.Tensor:
    if records.device.type == "cpu":
        return speculative_plain(
            records, attr_idx, attr_select, threshold, child, class_val,
            total_jumps=total_jumps, jump_mode=jump_mode,
        )
    tables = _tables(attr_idx, threshold, child, class_val, (), attr_select, records.shape[-1])
    m, a, n, smem = _check(records, tables, "speculative", block_m, jump_mode)
    _, warps, slots = _spec_launch(block_m, a, n, jump_mode)
    out = torch.empty((m,), dtype=torch.int32, device=records.device)
    if m:
        _launch(
            "k1_speculative", f"speculative/{jump_mode}",
            (records, attr_idx, attr_select, threshold, child, class_val, out),
            (m, a, n, block_m, total_jumps, int(jump_mode == "onehot"), warps, slots, smem),
        )
    return out


@_speculative_op.register_fake
def _speculative_shape(records, attr_idx, attr_select, threshold, child, class_val, total_jumps, jump_mode, block_m):
    """K1's shape rule: (M,) int32 on the records' device, nothing read.  A
    fake CUDA call is checked as the card would check it; tables on another
    device than the records are refused, as a launch refuses them."""
    if jump_mode not in JUMP_MODES:
        raise ValueError(f"unknown jump_mode {jump_mode!r}")
    if records.device.type == "cuda":
        tables = _tables(attr_idx, threshold, child, class_val, (), attr_select, records.shape[-1])
        _check(records, tables, "speculative", block_m, jump_mode)
    elif any(t.device != records.device for t in (attr_idx, attr_select, threshold, child, class_val)):
        raise ValueError(f"kernels take CPU or CUDA tensors on one device, got {records.device} records "
                         f"and tables on {attr_idx.device}")
    return records.new_empty((records.shape[0],), dtype=torch.int32)


def speculative(
    records, attr_idx, attr_select, threshold, child, class_val,
    *, total_jumps: int, jump_mode: str, block_m: int,
) -> torch.Tensor:
    """K1: Procedure 4/5 for one tree, ``total_jumps`` pointer jumps. (M,) int32.

    The operator ``torch.ops.repro_torch.speculative``: the kernel on CUDA
    tensors, the plain version on CPU tensors, and on fake or meta tensors
    its shape rule alone (a dry-run plans through it without a card).
    """
    return _speculative_op(records, attr_idx, attr_select, threshold, child, class_val,
                           total_jumps, jump_mode, block_m)


def data_parallel(
    records, attr_idx, threshold, child, class_val, *, max_depth: int, block_m: int
) -> torch.Tensor:
    """K2: Procedure 3 for one tree, ``max_depth`` rounds. (M,) int32."""
    if records.device.type == "cpu":
        return data_parallel_plain(records, attr_idx, threshold, child, class_val, max_depth=max_depth)
    tables = _tables(attr_idx, threshold, child, class_val, ())
    m, a, n, smem = _check(records, tables, "data_parallel", block_m, "gather")
    out = torch.empty((m,), dtype=torch.int32, device=records.device)
    if m:
        _launch(
            "k2_data_parallel", "data_parallel",
            (records, attr_idx, threshold, child, class_val, out),
            (m, a, n, block_m, max_depth, dp_threads(block_m), smem),
        )
    return out


def fused_speculative(
    records, attr_idx, attr_select, threshold, child, class_val,
    *, total_jumps: int, jump_mode: str, block_m: int,
) -> torch.Tensor:
    """K3: K1 over a stacked (T, N) forest in one launch. (T, M) int32."""
    if records.device.type == "cpu":
        return fused_speculative_plain(
            records, attr_idx, attr_select, threshold, child, class_val,
            total_jumps=total_jumps, jump_mode=jump_mode,
        )
    t = threshold.shape[0]
    tables = _tables(attr_idx, threshold, child, class_val, (t,), attr_select, records.shape[-1])
    m, a, n, smem = _check(records, tables, "speculative", block_m, jump_mode)
    chunk, warps, slots = _spec_launch(block_m, a, n, jump_mode, 0, t)
    out = torch.empty((t, m), dtype=torch.int32, device=records.device)
    if m and t:
        _launch(
            "k3_fused_speculative", f"fused_speculative/{jump_mode}",
            (records, attr_idx, attr_select, threshold, child, class_val, out),
            (m, a, n, t, block_m, chunk, total_jumps, int(jump_mode == "onehot"), warps, slots, smem),
        )
    return out


def fused_data_parallel(
    records, attr_idx, threshold, child, class_val, *, max_depth: int, block_m: int
) -> torch.Tensor:
    """K4: K2 over a stacked (T, N) forest in one launch. (T, M) int32."""
    if records.device.type == "cpu":
        return fused_data_parallel_plain(
            records, attr_idx, threshold, child, class_val, max_depth=max_depth
        )
    t = threshold.shape[0]
    tables = _tables(attr_idx, threshold, child, class_val, (t,))
    m, a, n, smem = _check(records, tables, "data_parallel", block_m, "gather")
    out = torch.empty((t, m), dtype=torch.int32, device=records.device)
    if m and t:
        chunk, threads = _dp_launch(block_m, a, n, 0, t)
        _launch(
            "k4_fused_data_parallel", "fused_data_parallel",
            (records, attr_idx, threshold, child, class_val, out),
            (m, a, n, t, block_m, chunk, max_depth, threads, smem),
        )
    return out


def fused_votes_speculative(
    records, attr_idx, attr_select, threshold, child, class_val,
    *, n_classes: int, total_jumps: int, jump_mode: str, block_m: int,
) -> torch.Tensor:
    """K5: K3 with the forest's votes tallied in the CTA. (M, n_classes) int32."""
    if records.device.type == "cpu":
        return fused_votes_speculative_plain(
            records, attr_idx, attr_select, threshold, child, class_val,
            n_classes=n_classes, total_jumps=total_jumps, jump_mode=jump_mode,
        )
    t = threshold.shape[0]
    tables = _tables(attr_idx, threshold, child, class_val, (t,), attr_select, records.shape[-1])
    m, a, n, smem = _check(records, tables, "speculative", block_m, jump_mode, n_classes)
    if not (m and t and n_classes):
        return torch.zeros((m, n_classes), dtype=torch.int32, device=records.device)
    chunk, warps, slots = _spec_launch(block_m, a, n, jump_mode, n_classes, t)
    out = torch.empty((m, n_classes), dtype=torch.int32, device=records.device)
    _launch(
        "k5_fused_votes_speculative", f"fused_votes_speculative/{jump_mode}",
        (records, attr_idx, attr_select, threshold, child, class_val, out),
        (m, a, n, t, n_classes, block_m, chunk, total_jumps, int(jump_mode == "onehot"),
         warps, slots, smem),
    )
    return out


def fused_votes_data_parallel(
    records, attr_idx, threshold, child, class_val, *, n_classes: int, max_depth: int, block_m: int
) -> torch.Tensor:
    """K6: K4 with the forest's votes tallied in the CTA. (M, n_classes) int32."""
    if records.device.type == "cpu":
        return fused_votes_data_parallel_plain(
            records, attr_idx, threshold, child, class_val, n_classes=n_classes, max_depth=max_depth
        )
    t = threshold.shape[0]
    tables = _tables(attr_idx, threshold, child, class_val, (t,))
    m, a, n, smem = _check(records, tables, "data_parallel", block_m, "gather", n_classes)
    if not (m and t and n_classes):
        return torch.zeros((m, n_classes), dtype=torch.int32, device=records.device)
    chunk, threads = _dp_launch(block_m, a, n, n_classes, t)
    out = torch.empty((m, n_classes), dtype=torch.int32, device=records.device)
    _launch(
        "k6_fused_votes_data_parallel", "fused_votes_data_parallel",
        (records, attr_idx, threshold, child, class_val, out),
        (m, a, n, t, n_classes, block_m, chunk, max_depth, threads, smem),
    )
    return out


def _launch_q(c_name: str, counter: str, records, attr_idx, threshold, child, class_val,
              algorithm: str, block_m: int, depth_arg: int) -> torch.Tensor:
    """Check and launch K7 or K8; ``depth_arg`` is K7's jumps or K8's depth."""
    tables = _q_tables(attr_idx, threshold, child, class_val)
    m, a, n, smem = _check(records, tables, algorithm, block_m, "gather")
    t = threshold.shape[0]
    out = torch.empty((t, m), dtype=torch.int32, device=records.device)
    if m and t:
        storage, code = THR_CODES[threshold.dtype]
        widths = (code, attr_idx.element_size(), child.element_size(), class_val.element_size())
        if algorithm == "speculative":
            chunk, warps, slots = _spec_launch(block_m, a, n, "gather", 0, t)
            ints = (m, a, n, t, block_m, chunk, depth_arg, *widths, warps, slots, smem)
        else:
            chunk, threads = _dp_launch(block_m, a, n, 0, t)
            ints = (m, a, n, t, block_m, chunk, depth_arg, *widths, threads, smem)
        _launch(c_name, f"{counter}/{storage}", (records, attr_idx, threshold, child, class_val, out),
                ints)
    return out


def fused_speculative_q(
    records, attr_idx, threshold, child, class_val, *, total_jumps: int, block_m: int
) -> torch.Tensor:
    """K7: K3 gather on narrow (T, N) tables, read at their stored widths. (T, M) int32."""
    if records.device.type == "cpu":
        return fused_speculative_q_plain(
            records, attr_idx, threshold, child, class_val, total_jumps=total_jumps
        )
    return _launch_q("k7_fused_speculative_q", "fused_speculative_q", records, attr_idx,
                     threshold, child, class_val, "speculative", block_m, total_jumps)


def fused_data_parallel_q(
    records, attr_idx, threshold, child, class_val, *, max_depth: int, block_m: int
) -> torch.Tensor:
    """K8: K4 on narrow (T, N) tables, read at their stored widths. (T, M) int32."""
    if records.device.type == "cpu":
        return fused_data_parallel_q_plain(
            records, attr_idx, threshold, child, class_val, max_depth=max_depth
        )
    return _launch_q("k8_fused_data_parallel_q", "fused_data_parallel_q", records, attr_idx,
                     threshold, child, class_val, "data_parallel", block_m, max_depth)
