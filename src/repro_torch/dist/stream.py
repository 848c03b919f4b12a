"""Streaming chunker: double-buffer host→device transfer against evaluation.

The paper's t_s(M) = σ·M + γ transmission term is paid *serially* in its
CUDA timings — copy the whole record array in, run, copy assignments out.
For segmentation-scale streams (millions of records) the copy need not
serialize: submitting chunk k+1's copy and evaluation while chunk k is still
running overlaps the σ·M wire time with compute, hiding min(t_s, T_eval) per
chunk.  The chunker submits *before* it drains — chunk k+1 is queued before
the host waits on chunk k — and keeps at most ``inflight`` chunks pending
after each submit settles, so host memory and device queues stay bounded.

On the card each of the ``inflight + 1`` slots owns a pinned host buffer for
its records and one for its output.  A chunk's records are written into its
slot's pinned buffer and copied to the card on the chunker's copy stream
(``non_blocking``); an event orders the evaluation, on the caller's current
stream, after that copy (the device tensor, allocated on the copy stream,
is marked with ``record_stream`` for the evaluation's stream, so the caching
allocator cannot hand its memory out early).  The (T, n) classes are copied
back into the slot's pinned output buffer on the evaluation's stream and an
event is recorded after them.  The drain waits on that event — the only
host wait — and copies the classes out of the pinned buffer.  A slot is
refilled only after its previous chunk has drained, so its copies have
completed.  Off the card the chunker runs the same logic on host tensors,
without pinned memory or streams.

Two per-chunk measurements land in :class:`StreamStats` (and in the caller's
stats via ``on_chunk``):

* ``chunk_ms`` — submit→ready latency, the stream analogue of
  ``TreeServeEngine``'s per-wave accounting;
* ``overlap_ratio`` — the fraction of this chunk's submit→ready window
  during which the *previous* chunk was still in flight, i.e. how much of
  the pipeline actually ran double-buffered (0.0 for the first chunk).

Chunking is only a win while the overlapped transfer outweighs the fixed
per-chunk cost.  With ``auto_coalesce`` (default) the chunker measures its
own throughput per effective chunk size and grows the size — up to
``max_coalesce``× the configured ``chunk_records`` — while bigger chunks
keep winning, retreating to the best size seen when they stop.  The first
``eval()`` always runs at the configured ``chunk_records`` (sizes are only
explored once a baseline throughput exists), so one-shot callers see
exactly the chunk geometry they asked for.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import obs


class StreamStats:
    """Chunker accounting on a :class:`repro_torch.obs.Registry`.

    Scalars are read properties over locked instruments, the per-chunk
    sequences (``chunk_ms``, ``overlap_ratio``) plain lists next to their
    histogram twins — benches take medians over the lists, dashboards read
    the histograms.
    """

    def __init__(self, registry: obs.Registry | None = None):
        self.registry = registry if registry is not None else obs.Registry()
        r = self.registry
        self.m_chunks = r.counter("stream.chunks", "chunks drained")
        self.m_records = r.counter("stream.records", "records streamed")
        self.m_wall_s = r.counter(
            "stream.wall_s", "submit-first → drain-last seconds, per eval()")
        self.m_chunk_ms = r.histogram(
            "stream.chunk_ms", "submit→ready latency per chunk")
        self.m_overlap = r.histogram(
            "stream.overlap_ratio",
            "fraction of each chunk's submit→ready window shared with the "
            "previous in-flight chunk",
            boundaries=obs.DEFAULT_RATIO_BOUNDARIES)
        self.g_coalesced = r.gauge(
            "stream.coalesced_chunk_records",
            "effective chunk size after throughput-feedback adaptation")
        self.m_coalesce = r.counter(
            "stream.coalesce_decisions",
            "throughput-feedback coalescing decisions", ("decision",))
        self.chunk_ms: list = []        # submit→ready per chunk
        # fraction of each chunk's submit→ready window shared with the
        # previous in-flight chunk (0.0 for the first chunk of an eval)
        self.overlap_ratio: list = []

    @property
    def chunks(self) -> int:
        return int(self.m_chunks.value)

    @property
    def records(self) -> int:
        return int(self.m_records.value)

    @property
    def wall_s(self) -> float:
        return self.m_wall_s.value

    @property
    def coalesced_chunk_records(self) -> int:
        return int(self.g_coalesced.value)


@dataclasses.dataclass
class _Slot:
    """One in-flight chunk's pinned buffers and the events of its copies."""

    rec: torch.Tensor            # flat pinned float32 records
    out: torch.Tensor            # flat pinned int32 classes
    copied: torch.cuda.Event     # its records reached the card
    ready: torch.cuda.Event      # its classes reached the pinned buffer


@dataclasses.dataclass
class _Pending:
    out: object                  # (T, n) host tensor, or the slot's pinned view
    slot: _Slot | None
    t_submit: float
    start: int
    n: int


class StreamingChunker:
    """Chunked, overlap-friendly runner for a (sharded) forest evaluator.

    ``evaluator`` is any callable records → (T, m) that does *not* wait on
    the device (:class:`repro_torch.dist.ShardedForestEvaluator` by
    contract); the chunker owns synchronization.  It stages through pinned
    memory when the evaluator's ``device`` attribute names a card, and runs
    on the host otherwise.
    """

    def __init__(self, evaluator, *, chunk_records: int = 65536, inflight: int = 2,
                 stats: StreamStats | None = None, auto_coalesce: bool = True,
                 max_coalesce: int = 8,
                 registry: obs.Registry | None = None,
                 tracer: obs.Tracer | None = None):
        if chunk_records < 1:
            raise ValueError("chunk_records must be >= 1")
        self.evaluator = evaluator
        self.chunk_records = chunk_records
        self.inflight = max(1, inflight)
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.stats = stats if stats is not None else StreamStats(registry)
        self.auto_coalesce = auto_coalesce
        self.max_coalesce = max(1, int(max_coalesce))
        self.device = torch.device(getattr(evaluator, "device", "cpu"))
        self._effective = chunk_records      # current adapted chunk size
        self._evals = 0
        self._tput: dict[int, float] = {}    # effective size → records/s (EMA)
        self._seen: set[int] = set()         # sizes whose first eval is spent
        self._prev_ready: float | None = None
        self._slots: list[_Slot] = []        # pinned buffers, one per in-flight chunk
        self._next_slot = 0
        self._copy_stream = None

    @property
    def effective_chunk_records(self) -> int:
        """The chunk size the next ``eval()`` runs at."""
        return self._effective if (self.auto_coalesce and self._evals > 0) else self.chunk_records

    # -- one chunk ----------------------------------------------------------

    def _slot(self, n_floats: int, n_ints: int) -> _Slot:
        """The next slot, its buffers grown to hold a chunk; refilled only
        once its previous copies have completed."""
        if len(self._slots) < self.inflight + 1:
            slot = _Slot(torch.empty(0, pin_memory=True), torch.empty(0, dtype=torch.int32, pin_memory=True),
                         torch.cuda.Event(), torch.cuda.Event())
            self._slots.append(slot)
        slot = self._slots[self._next_slot % len(self._slots)]
        self._next_slot += 1
        slot.copied.synchronize()   # drained already: both have completed
        slot.ready.synchronize()
        if slot.rec.numel() < n_floats:
            slot.rec = torch.empty(n_floats, dtype=torch.float32, pin_memory=True)
        if slot.out.numel() < n_ints:
            slot.out = torch.empty(n_ints, dtype=torch.int32, pin_memory=True)
        return slot

    def _submit(self, chunk: np.ndarray, start: int) -> _Pending:
        n, a = chunk.shape
        if self.device.type != "cuda":
            out = self.evaluator(torch.from_numpy(chunk))
            return _Pending(out, None, time.perf_counter(), start, n)
        n_trees = getattr(getattr(self.evaluator, "forest", None), "n_trees", 0)
        slot = self._slot(n * a, n * n_trees)
        host_in = slot.rec[: n * a].view(n, a)
        host_in.numpy()[...] = chunk
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                rec = torch.empty((n, a), dtype=torch.float32, device=self.device)
                rec.copy_(host_in, non_blocking=True)
                slot.copied.record(self._copy_stream)
            compute.wait_event(slot.copied)
            rec.record_stream(compute)
            out = self.evaluator(rec)
            t = out.shape[0]
            if slot.out.numel() < t * n:   # an evaluator without a forest attribute
                slot.ready.synchronize()
                slot.out = torch.empty(t * n, dtype=torch.int32, pin_memory=True)
            host_out = slot.out[: t * n].view(t, n)
            host_out.copy_(out, non_blocking=True)
            slot.ready.record(compute)
        return _Pending(host_out, slot, time.perf_counter(), start, n)

    def _drain_one(self, pending: deque, result: list, on_chunk) -> None:
        p = pending.popleft()
        with self.tracer.span("stream.drain", cat="stream", records=p.n) as dspan:
            if p.slot is not None:
                p.slot.ready.synchronize()   # the drain's wait: the only host wait
            arr = p.out.numpy()
            if not result:
                result.append(np.empty((arr.shape[0], self._m), np.int32))
            result[0][:, p.start:p.start + p.n] = arr
        t_ready = time.perf_counter()
        latency_ms = (t_ready - p.t_submit) * 1e3
        window = max(t_ready - p.t_submit, 1e-9)
        if self._prev_ready is None:
            overlap = 0.0
        else:
            overlap = min(max((self._prev_ready - p.t_submit) / window, 0.0), 1.0)
        self._prev_ready = t_ready
        dspan.set(chunk_ms=round(latency_ms, 3), overlap=round(overlap, 3))
        self.stats.m_chunks.inc()
        self.stats.m_records.inc(p.n)
        self.stats.m_chunk_ms.observe(latency_ms)
        self.stats.m_overlap.observe(overlap)
        self.stats.chunk_ms.append(latency_ms)
        self.stats.overlap_ratio.append(overlap)
        if on_chunk is not None:
            on_chunk(latency_ms, p.n)

    def _note_eval(self, size: int, n_chunks: int, records: int, wall: float) -> None:
        """Throughput-feedback coalescing: grow the effective chunk size while
        bigger chunks keep winning, retreat to the best size seen when not."""
        if not self.auto_coalesce or records == 0 or wall <= 0.0:
            return
        if size not in self._seen:
            # the first eval at a new size pays its one-time costs (resolution,
            # pinned buffers); stay here one more eval and measure without them
            self._seen.add(size)
            self.stats.g_coalesced.set(self._effective)
            return
        tput = records / wall
        prev = self._tput.get(size)
        self._tput[size] = tput if prev is None else 0.5 * prev + 0.5 * tput
        best = max(self._tput, key=self._tput.get)
        if best != size:
            self._effective = best       # the explored size lost; go back
            decision = "retreat"
        else:
            cap = self.chunk_records * self.max_coalesce
            nxt = min(size * 2, cap)
            if n_chunks > 1 and nxt > size and nxt not in self._tput:
                self._effective = nxt    # current best; explore one size up
                decision = "grow"
            else:
                decision = "hold"
        self.stats.m_coalesce.labels(decision=decision).inc()
        self.tracer.instant("stream.coalesce", cat="stream", decision=decision,
                            size=size, effective=self._effective)
        self.stats.g_coalesced.set(self._effective)

    def eval(self, records, *, on_chunk=None) -> np.ndarray:
        """Evaluate a (possibly huge) record batch; returns host (T, M).

        ``on_chunk(latency_ms, n_records)`` fires as each chunk completes —
        serve engines feed their own stats through it.
        """
        if isinstance(records, torch.Tensor):
            records = records.cpu().numpy()
        rec = np.ascontiguousarray(records, np.float32)
        m = self._m = rec.shape[0]
        t0 = time.perf_counter()
        pending: deque = deque()
        result: list = []
        self._prev_ready = None
        # the first eval honours the configured chunk size exactly; adapted
        # sizes only apply once a baseline throughput has been measured
        size = self.effective_chunk_records
        n_chunks = 0
        with self.tracer.span("stream.eval", cat="stream", records=m,
                              chunk_records=size) as espan:
            for start in range(0, m, size):
                chunk = rec[start:start + size]
                with self.tracer.span("stream.chunk.submit", cat="stream",
                                      chunk=n_chunks, records=chunk.shape[0]):
                    pending.append(self._submit(chunk, start))
                n_chunks += 1
                # submit-before-drain: the new chunk is already queued when
                # the host waits on the oldest one, so device work never gaps
                # on the drain; at most ``inflight`` stay pending after it
                while len(pending) > self.inflight:
                    self._drain_one(pending, result, on_chunk)
            while pending:
                self._drain_one(pending, result, on_chunk)
            espan.set(chunks=n_chunks)
        wall = time.perf_counter() - t0
        self.stats.m_wall_s.inc(wall)
        self._evals += 1
        self._note_eval(size, n_chunks, m, wall)
        if not result:
            n_trees = getattr(getattr(self.evaluator, "forest", None), "n_trees", 0)
            return np.zeros((n_trees, 0), np.int32)
        return result[0]


def stream_eval_forest(forest, records, *, chunk_records: int = 65536, inflight: int = 2,
                       stats: StreamStats | None = None, **evaluator_kw) -> np.ndarray:
    """One-shot convenience: sharded + chunked forest evaluation.

    Args:
      forest: an ``EncodedForest`` (or list of encoded trees).
      records: (M, A) float batch, arbitrarily large — chunks of
        ``chunk_records`` stream through the sharded executor with at most
        ``inflight`` pending (double buffering at the default of 2).
      stats: optional :class:`StreamStats` to accumulate into.
      **evaluator_kw: forwarded to :class:`ShardedForestEvaluator`
        (``mesh``/``plan``/``decomposition``/``devices``/``cache``/…).

    Returns:
      Host (T, M) int32 per-tree class assignments, bit-identical to the
      monolithic ``eval_forest_tuned`` call.
    """
    from repro_torch.dist.executor import ShardedForestEvaluator

    ev = ShardedForestEvaluator(forest, **evaluator_kw)
    return StreamingChunker(ev, chunk_records=chunk_records, inflight=inflight,
                            stats=stats).eval(records)
