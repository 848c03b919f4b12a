"""The cascade's margin pass: its exit test and its finish, with their plain versions.

Every place where the early-exit cascade (``cascade.py``) turns the (M, C)
int32 vote tally into a vote margin goes through this module: the exit test
of each stage that leaves trees to run (:func:`exit_test`) and the finish
with its winner, confidence and exit-margin histogram (:func:`finish`).  On
CUDA tensors each is one launch of a kernel of ``csrc/cascade_margin.cu``
(see its header for the bound and the design), which replaces no TPU kernel;
on CPU tensors each takes its plain torch version (``*_plain``).  The
choice rests on the tensors' device alone: there is no fallback, and a
failed build or launch raises ``RuntimeError``.

The finish may be handed a histogram to observe the margins into.  On a
card the kernel bins them into the histogram's pending buffer for the card
(``obs.metrics.Histogram.pending``, a :class:`DeviceBins`), which the host
reads only when someone reads the histogram; on the CPU the plain margins
go through ``Histogram.observe_many``.

``LAUNCHES`` counts each kernel's launches since the last
:func:`reset_launches`, so a run can show that the cascade went through them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.core.forest import vote_winner
from repro_torch.kernels import _build
from repro_torch.obs.trace import NULL_TRACER

SOURCE = Path(__file__).resolve().parent / "csrc" / "cascade_margin.cu"

MAX_BOUNDARIES = 31   # csrc kMaxBounds: histogram boundaries a finish takes

LAUNCHES = {"exit_test": 0, "finish": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.cascade_exit_test.argtypes = [_P, _P, _I, _I, _I, ctypes.c_double, _P, _P, _P]
    lib.cascade_finish.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
    for fn in (lib.cascade_exit_test, lib.cascade_finish):
        fn.restype = ctypes.c_int
    lib.cascade_margin_error_string.argtypes = [ctypes.c_int]
    lib.cascade_margin_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _host_bounds(boundaries: tuple[float, ...]):
    return (ctypes.c_double * max(len(boundaries), 1))(*boundaries)


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"cascade_{name}")(*args, stream)
    if err != 0:
        msg = lib.cascade_margin_error_string(err).decode()
        raise RuntimeError(f"cascade_{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the tally on {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")


def _check_votes(votes: torch.Tensor) -> tuple[int, int]:
    if votes.device.type != "cuda":
        raise ValueError(f"the margin pass takes CPU or CUDA tensors, got {votes.device}")
    if votes.dim() != 2:
        raise ValueError(f"votes must be (M, C), got {tuple(votes.shape)}")
    m, c = votes.shape
    _check("votes", votes, torch.int32, (m, c), votes.device)
    if c < 2 or m > 2**31 - 1:
        raise ValueError(f"votes must have 2 classes or more and fewer than 2**31 rows, got {(m, c)}")
    return m, c


class DeviceBins:
    """A histogram's pending buffer on a card: the int64 tensor that
    ``cascade_finish_kernel`` adds to (``Histogram.pending`` lays it out),
    with an event on each stream that queued an add.

    Adds are queued under :meth:`adding`, which records the stream's event
    after them; :meth:`tolist` takes the same lock and waits on every event
    before it copies.  So a read never copies the buffer while a kernel on
    any stream is adding to it, and no add is queued between the wait and
    the copy.  The kernel's atomics let adds from several streams overlap.
    The events are one a stream, and torch draws its streams from a fixed
    pool, so they stay few.
    """

    def __init__(self, init: list[int], device: torch.device):
        self.tensor = torch.tensor(init, dtype=torch.int64, device=device)
        self._lock = threading.Lock()
        self._fences: dict[int, torch.cuda.Event] = {}

    @contextlib.contextmanager
    def adding(self):
        with self._lock:
            yield self.tensor
            stream = torch.cuda.current_stream(self.tensor.device)
            fence = self._fences.get(stream.cuda_stream)
            if fence is None:
                fence = self._fences[stream.cuda_stream] = torch.cuda.Event()
            fence.record(stream)

    def tolist(self) -> list[int]:
        with self._lock:
            for fence in self._fences.values():
                fence.synchronize()
            return self.tensor.tolist()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def exit_test_plain(votes, alive, stage: int, threshold: float, exit_stage) -> torch.Tensor:
    """The exit test in plain torch: records ``alive`` whose top-1 minus top-2
    votes exceed ``threshold`` get ``exit_stage`` ``stage``; returns the (n,)
    bool mask of the survivors that stay."""
    top2 = votes.index_select(0, alive).topk(2, dim=1).values
    # numpy compares the int margin with the float64 product; a torch int
    # tensor against a Python float would compare in float32.
    margin = (top2[:, 0] - top2[:, 1]).double()
    decided = margin > threshold
    exit_stage[alive] = torch.where(decided, stage, exit_stage[alive])
    return ~decided


def finish_plain(votes, trees_evaluated, t_total: int):
    """The finish in plain torch: (classes, margin, confidence)."""
    classes = vote_winner(votes)
    top2 = votes.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).to(torch.int32)
    remaining_all = t_total - trees_evaluated
    # float64 as numpy divides int32 arrays, then cast: bit-identical.
    ratio = margin.double() / remaining_all.clamp(min=1).double()
    conf = torch.where(remaining_all <= 0, 1.0, ratio.clamp(0.0, 1.0)).to(torch.float32)
    return classes, margin, conf


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def exit_test(votes, alive, stage: int, threshold: float, exit_stage) -> torch.Tensor:
    """Stage ``stage``'s exit test over the survivors ``alive`` (int64 record
    indices) of the (M, C) int32 tally: a record whose top-1 minus top-2
    votes exceed ``threshold`` (compared in float64) gets ``exit_stage``
    (int32, (M,)) ``stage``.  Returns the (n,) bool mask of the survivors
    that stay, so ``alive[keep]`` keeps their order."""
    if votes.device.type == "cpu":
        return exit_test_plain(votes, alive, stage, threshold, exit_stage)
    m, c = _check_votes(votes)
    dev = votes.device
    n = alive.shape[0] if alive.dim() == 1 else -1
    _check("alive", alive, torch.int64, (n,), dev)
    _check("exit_stage", exit_stage, torch.int32, (m,), dev)
    keep = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _launch("exit_test", dev, votes.data_ptr(), alive.data_ptr(), n, c, int(stage),
                float(threshold), exit_stage.data_ptr(), keep.data_ptr())
    return keep


def finish(votes, trees_evaluated, t_total: int, histogram=None, tracer=NULL_TRACER):
    """The cascade's finish over the (M, C) int32 tally: (classes, margin,
    confidence), (M,) each: the winner (ties to the lowest class), top-1
    minus top-2 votes (int32), and ``margin / max(remaining, 1)`` clamped to
    [0, 1], 1.0 where ``t_total - trees_evaluated`` is 0 (float32).  Given
    ``histogram`` (an ``obs`` histogram), the margins are observed into it;
    handing them over is the span ``cascade.observe``."""
    if votes.device.type == "cpu":
        out = finish_plain(votes, trees_evaluated, t_total)
        if histogram is not None:
            with tracer.span("cascade.observe", cat="cascade"):
                histogram.observe_many(out[1].numpy())
        return out
    m, c = _check_votes(votes)
    dev = votes.device
    _check("trees_evaluated", trees_evaluated, torch.int32, (m,), dev)
    bins, boundaries = None, ()
    if histogram is not None:
        boundaries = histogram.boundaries
        if len(boundaries) > MAX_BOUNDARIES:
            raise ValueError(f"{len(boundaries)} histogram boundaries; the finish takes {MAX_BOUNDARIES}")
        with tracer.span("cascade.observe", cat="cascade"):
            bins = histogram.pending(dev, functools.partial(DeviceBins, device=dev))
    classes = torch.empty((m,), dtype=torch.int32, device=dev)
    margin = torch.empty((m,), dtype=torch.int32, device=dev)
    conf = torch.empty((m,), dtype=torch.float32, device=dev)
    if m:
        with contextlib.nullcontext() if bins is None else bins.adding() as buf:
            _launch("finish", dev, votes.data_ptr(), trees_evaluated.data_ptr(), m, c, int(t_total),
                    classes.data_ptr(), margin.data_ptr(), conf.data_ptr(),
                    None if buf is None else buf.data_ptr(), _host_bounds(boundaries), len(boundaries))
    return classes, margin, conf
