"""Span tracer: ring-buffered timed spans with a Chrome/Perfetto exporter.

The port's own copy of the JAX package's ``obs/trace.py``; only the
profiler bridge differs.

``Tracer.span("cascade.stage", cat="cascade", stage=s)`` is a context
manager that records one complete ("X") trace event — wall-clock start +
duration, thread id, free-form args.  Events land in a bounded ring buffer
(a ``deque(maxlen=...)`` appended under a lock), so tracing from several
threads at once is safe and memory stays bounded however long a process
runs.

Nesting is positional: spans opened inside other spans on the same thread
are contained in time, which is exactly how the Chrome trace-event format
(and Perfetto's UI) reconstructs the stack — the exporter does not need
explicit parent ids for nested spans to render nested.  Cross-thread work
shows up on its own track, named via thread-name metadata events.

Span naming convention: dotted lowercase ``layer.operation[.phase]`` — e.g.
``cascade.eval``, ``cascade.stage``, ``cascade.compact`` — with the layer
repeated in ``cat`` so Perfetto can filter by subsystem.

Profiler bridging: while a ``torch.profiler`` session records, every span
of every tracer, a disabled one (``NULL_TRACER``) included, also enters a
profiler range of the same name, so the host-side spans are events of the
same session as the device kernels, on its clock.  A disabled tracer's span
then writes nothing to its ring; with no session recording it is the
shared no-op span.  Whether a session records is one read of the
profiler's module flag; without torch imported none can.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

__all__ = ["NULL_TRACER", "SpanEvent", "Tracer", "write_chrome_trace"]


class SpanEvent(NamedTuple):
    """One completed span (times in µs relative to the tracer's epoch)."""

    name: str
    cat: str
    ts_us: float
    dur_us: float
    thread: int          # thread ident (raw)
    thread_name: str
    args: dict
    ph: str = "X"        # trace phase: "X" complete span, "C" counter sample


class _Span:
    """Active span: context manager recording one SpanEvent on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_profiler_cm")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0
        self._profiler_cm = None

    def set(self, **kw) -> None:
        """Attach args discovered mid-span (chunk counts, winners, ...)."""
        self._args.update(kw)

    def __enter__(self) -> "_Span":
        if _profiling():
            self._profiler_cm = _profiler_range(self._name)
            self._profiler_cm.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        if self._profiler_cm is not None:
            self._profiler_cm.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            self._args.setdefault("error", exc_type.__name__)
        self._tracer._record(self._name, self._cat, self._t0, t1, self._args)


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **kw) -> None:
        return None


_NULL_SPAN = _NullSpan()

_profiler_flags = None   # torch.autograd.profiler, once torch is imported


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording (its module flag)."""
    global _profiler_flags
    if _profiler_flags is None:
        _profiler_flags = sys.modules.get("torch.autograd.profiler")
        if _profiler_flags is None:
            return False
    return _profiler_flags._is_profiler_enabled


def _profiler_range(name: str):
    """A profiler range of ``name``: a host event of the recording session.

    torch's C++ range, the one its compiled code opens: on an H100 host it
    costs 1.4 µs a span under a session, where ``record_function`` costs
    15.1 µs and adds a device-side annotation.
    """
    return sys.modules["torch"]._C._profiler._RecordFunctionFast(name)


class _RangeSpan:
    """A disabled tracer's span while a profiler records: the range alone."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _profiler_range(name)

    def __enter__(self) -> "_RangeSpan":
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._range.__exit__(exc_type, exc, tb)

    def set(self, **kw) -> None:
        return None


class Tracer:
    """Bounded in-memory span recorder with Chrome trace-event export.

    Args:
      capacity: ring-buffer size in spans; the oldest spans fall off first
        (steady-state serving keeps the most recent window).
      enabled: a disabled tracer's :meth:`span` returns a shared no-op
        context manager — two branches, zero allocation — unless a
        ``torch.profiler`` session records (see the module docstring).
    """

    def __init__(self, *, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._events: deque[SpanEvent] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._dropped = 0

    # -- recording ----------------------------------------------------------

    def span(self, name: str, *, cat: str = "repro", **args):
        """A context manager timing one span; when disabled, a profiler range
        while a ``torch.profiler`` session records, else a no-op."""
        if not self.enabled:
            return _RangeSpan(name) if _profiling() else _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, *, cat: str = "repro", **args) -> None:
        """Record a zero-duration marker event (coalescing decisions, swaps)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, cat, t, t, args)

    def counter(self, name: str, value: float, *, cat: str = "prof",
                series: str = "value") -> None:
        """Record one sample on a Perfetto counter track (``"C"`` phase).

        Successive samples with the same ``name`` render as a stepped
        timeline in Perfetto — e.g. per-bucket measured d_µ or waste ratio
        over the lifetime of a serving engine.  ``series`` names the counter
        track's value series (one arg key = one line on the track).
        """
        if not self.enabled:
            return
        t = time.perf_counter()
        self._record(name, cat, t, t, {series: float(value)}, ph="C")

    def _record(self, name: str, cat: str, t0: float, t1: float, args: dict,
                *, ph: str = "X") -> None:
        th = threading.current_thread()
        ev = SpanEvent(
            name=name,
            cat=cat,
            ts_us=(t0 - self._epoch) * 1e6,
            dur_us=(t1 - t0) * 1e6,
            thread=th.ident or 0,
            thread_name=th.name,
            args=args,
            ph=ph,
        )
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    # -- introspection / export ---------------------------------------------

    def events(self) -> list[SpanEvent]:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring bound since construction."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (load in Perfetto / about:tracing).

        Complete ("X") events carry µs timestamps relative to the tracer
        epoch; counter ("C") samples from :meth:`counter` carry numeric args
        and no duration (Perfetto draws them as counter tracks); per-thread
        metadata ("M") events name the tracks.  Args are emitted as-is, so
        bucket keys, chunk sizes and winners are inspectable per-span in
        the UI.
        """
        pid = os.getpid()
        events = self.events()
        tids: dict[int, str] = {}
        out = []
        for e in events:
            tids.setdefault(e.thread, e.thread_name)
            ev = {
                "name": e.name,
                "cat": e.cat,
                "ph": e.ph,
                "ts": round(e.ts_us, 3),
                "pid": pid,
                "tid": e.thread,
                "args": {k: _jsonable(v) for k, v in e.args.items()},
            }
            if e.ph != "C":  # counter samples are point values, no duration
                ev["dur"] = round(e.dur_us, 3)
            out.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(tids.items())
        ]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        write_chrome_trace(self, path)


def _jsonable(v):
    """Span args must survive json.dump whatever the caller attached."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_chrome_trace(tracer: Tracer, path) -> None:
    """Serialise ``tracer``'s ring buffer as Chrome trace-event JSON."""
    with open(path, "w") as f:
        json.dump(tracer.chrome_trace(), f)


#: Shared disabled tracer: components default to this so tracing is strictly
#: opt-in and the untraced hot path costs one branch per span site.
NULL_TRACER = Tracer(capacity=1, enabled=False)
