"""The program's own spans in the traced stretch, and the idle time under them.

The port's tracer turns every span into a ``torch.profiler`` range while a
session records, so its spans are host events of the session that times the
device, on one clock.  This module takes the host events whose names start
with one of ``PROGRAM_SPANS`` and gives, for each span name, its count, its
total seconds, its self seconds (less the program spans nested in it on the
same thread), how many of its events are outermost (a *call*: no program
span around it) and their seconds, and the device-idle seconds whose gap
midpoint falls in its self time.  Idle time under no program span is
credited to ``"caller"``, the loop around the program.  The gaps are those
``trace_reader.idle_gaps`` names, from the same events.

Per-layer readers call :func:`of` with the ``TraceData`` they are given.
Until the harness hands them the spans (``TraceData.spans`` and
``.idle_s``), :func:`of` finds the session's ``trace_reader.Profiler`` in
the calling frames, the harness's ``run_cell``, and reads it once.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys

import torch

from perfbench import trace_reader

# Span-name prefixes of the program's layers: the tuned entry, the kernels'
# wrappers and launch, the vote and the cascade.  Frozen, as the tree
# kernels' names are: a span renamed out of them reads as the caller's.
PROGRAM_SPANS = ("tune.", "kernel.", "forest.", "cascade.")
CALLER = "caller"


@dataclasses.dataclass
class Spans:
    """The stretch's program spans by name, and its idle seconds.

    by_name: name → {"count", "total_s", "self_s", "outer", "outer_s",
      "idle_s"}; ``"caller"`` holds only the idle seconds under no span.
    idle_s: the gaps' sum, attributed to a span or to the caller.
    """

    by_name: dict
    idle_s: float

    @property
    def calls(self) -> int:
        """Outermost program spans: one a call into the program."""
        return sum(s["outer"] for s in self.by_name.values())

    def call_us(self) -> float:
        """Mean µs of a call."""
        return 1e6 * sum(s["outer_s"] for s in self.by_name.values()) / self.calls

    def self_us(self, prefixes: tuple, exclude: tuple = ()) -> float:
        """Self µs a call of the spans whose names start with ``prefixes``,
        less those named in ``exclude``: self times do not overlap, so such
        parts add up to :meth:`call_us`."""
        total = sum(s["self_s"] for name, s in self.by_name.items()
                    if name.startswith(prefixes) and name not in exclude)
        return 1e6 * total / self.calls

    def idle_in_program_share(self) -> float:
        """Share of the idle seconds under any program span."""
        return 1.0 - self.by_name.get(CALLER, {}).get("idle_s", 0.0) / self.idle_s


def is_program_span(name: str) -> bool:
    return name.startswith(PROGRAM_SPANS)


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches between ``lo`` and ``hi`` outside the merged ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _entry() -> dict:
    return {"count": 0, "total_s": 0.0, "self_s": 0.0, "outer": 0, "outer_s": 0.0, "idle_s": 0.0}


def collect(spans, busy, lo: float, hi: float) -> Spans:
    """Aggregate ``spans``, (name, thread, start µs, end µs) host events of
    the program, against the device's merged ``busy`` intervals (µs) between
    ``lo`` and ``hi``."""
    by_name: dict = {}
    threads: dict = {}
    for name, thread, a, b in spans:
        threads.setdefault(thread, []).append((a, -b, name))
    idle = gaps(busy, lo, hi)
    owners = [CALLER] * len(idle)
    latest = [-float("inf")] * len(idle)
    mids = [(a + b) / 2 for a, b in idle]
    for events in threads.values():
        events.sort()
        starts = [a for a, _, _ in events]
        ends = [-nb for _, nb, _ in events]
        parent = [-1] * len(events)
        child_s = [0.0] * len(events)
        stack: list[int] = []
        for i, (a, nb, _) in enumerate(events):
            while stack and not (starts[stack[-1]] <= a and -nb <= ends[stack[-1]]):
                stack.pop()
            if stack:
                parent[i] = stack[-1]
                child_s[stack[-1]] += ends[i] - a
            stack.append(i)
        for i, (a, nb, name) in enumerate(events):
            s = by_name.setdefault(name, _entry())
            dur = (-nb - a) / 1e6
            s["count"] += 1
            s["total_s"] += dur
            s["self_s"] += dur - child_s[i] / 1e6
            if parent[i] < 0:
                s["outer"] += 1
                s["outer_s"] += dur
        # each gap to the innermost span around its midpoint: an ancestor of
        # the last span to start before it (spans on one thread nest)
        for g, mid in enumerate(mids):
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and ends[i] < mid:
                i = parent[i]
            if i >= 0 and starts[i] > latest[g]:
                owners[g], latest[g] = events[i][2], starts[i]
    by_name.setdefault(CALLER, _entry())
    total = 0.0
    for (a, b), owner in zip(idle, owners):
        by_name[owner]["idle_s"] += (b - a) / 1e6
        total += (b - a) / 1e6
    return Spans(by_name=by_name, idle_s=total)


def read(profiler: trace_reader.Profiler) -> Spans:
    """The program spans of ``profiler``'s session, with the device's busy
    intervals and the stretch's ends taken as ``Profiler.read`` takes them."""
    device, host, program = [], [], []
    for e in profiler.prof.events():
        if getattr(e, "is_user_annotation", False) and e.device_type != torch.autograd.DeviceType.CPU:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(span)
            if is_program_span(e.name):
                program.append((e.name, e.thread, *span))
    lo = min((a for a, _ in host + device), default=0.0)
    hi = max((b for _, b in host + device), default=0.0)
    return collect(program, trace_reader.merged(device), lo, hi)


def _session() -> trace_reader.Profiler | None:
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, trace_reader.Profiler):
                return value
        frame = frame.f_back
    return None


def of(t) -> Spans | None:
    """The program spans of the traced stretch ``t`` (a ``TraceData``), or
    ``None`` without device time or without a call into the program."""
    if t.busy_s <= 0:
        return None
    if getattr(t, "spans", None) is not None:
        found = Spans(by_name=t.spans, idle_s=t.idle_s)
    else:
        profiler = _session()
        if profiler is None:
            return None
        found = getattr(profiler, "_program_spans", None)
        if found is None:
            found = profiler._program_spans = read(profiler)
    return found if found.calls else None
