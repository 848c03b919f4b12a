"""The traced stretch: one ``torch.profiler`` session and what it saw.

A traced run profiles the first ``trace_seconds`` of its window, host and
device, in one session (a process's later sessions can lose kernels); a
traffic mix with ``"trace_host": false`` has the device and the CUDA runtime's
calls traced without the host's operations, so that a step of thousands of
small launches is not slowed by the host's record of each operation, and
idle gaps outside a runtime call go unnamed.  From
the device events it takes the time the card was busy (the union of every
kernel, copy and fill), the time inside the tree kernels (K1–K8, by the
names frozen in ``TREE_KERNELS``), the time inside NCCL's kernels (the
collectives between cards, by their ``nccl`` prefix), the device
operations that took most
time, how many kernels it ran, and the longest idle gaps named by the innermost host operation
running across their middle.  Per-layer readers (``metrics/<name>.py``)
take a :class:`TraceData` and return a number or ``None``.
"""

from __future__ import annotations

import dataclasses
import heapq
import re

import torch

# The tree kernels, K1-K8, by the names of their ``__global__`` functions in
# the port's ``csrc/tree_eval.cu``.  Frozen here so that the kernels' layer
# means the same to every later run: a kernel renamed, or work moved into a
# new one, reads as time outside these until a benchmark PR names it.
TREE_KERNELS = {
    "K1": "speculative_kernel",
    "K2": "data_parallel_kernel",
    "K3": "fused_speculative_kernel",
    "K4": "fused_data_parallel_kernel",
    "K5": "fused_votes_speculative_kernel",
    "K6": "fused_votes_data_parallel_kernel",
    "K7": "fused_speculative_q_kernel",
    "K8": "fused_data_parallel_q_kernel",
}
KERNEL_RE = re.compile(r"\b(" + "|".join(sorted(TREE_KERNELS.values())) + r")\b")
# NCCL's device kernels (``ncclDevKernel_AllGather_RING_LL``, ``ncclKernel_…``):
# the collectives between cards, a class of their own
COLLECTIVE_RE = re.compile(r"\bnccl", re.IGNORECASE)
TOP = 10


@dataclasses.dataclass
class TraceData:
    """What per-layer readers read.

    window_s: host-clock length of the traced stretch.
    busy_s: union of the device's events in it.
    kernel_s: union of the tree kernels' events in it.
    bound_s: the least time the stretch's calls need (``perfbench/cost.py``;
      a model cell's decode steps: ``perfbench/cost_decode.py``).
    records, frames: real records and frames the stretch classified (a
      model cell: tokens decoded, no frames).
    collective_s: union of NCCL's kernels in it.
    kernel_bound_s: the least time of the stretch's tree-kernel work (a tree
      cell's: ``bound_s``; a model cell's: its router launches on one rank).
    launches: the device's kernels in it (copies and fills not counted).
    steps: the driver's steps in it (a tree cell's calls, a model cell's
      decode steps).

    On several cards the device times and launches are each card's, averaged.
    """

    window_s: float
    busy_s: float
    kernel_s: float
    bound_s: float
    records: int
    frames: float
    collective_s: float = 0.0
    kernel_bound_s: float = 0.0
    launches: float = 0.0
    steps: int = 0


def is_tree_kernel(name: str) -> bool:
    """Whether a device event's name is one of K1-K8's."""
    return KERNEL_RE.search(name) is not None


def is_kernel(name: str) -> bool:
    """Whether a device event is a kernel: not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def is_collective(name: str) -> bool:
    """Whether a device event is one of NCCL's kernels."""
    return COLLECTIVE_RE.search(name) is not None


def union_length(spans) -> float:
    """Length covered by a set of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


HOST_UNNAMED = "host outside any profiled op"
HOST_UNTRACED = "host outside any CUDA call (host ops not traced)"


class Profiler:
    def __init__(self, device: torch.device, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        host = host or device.type != "cuda"
        acts = [ProfilerActivity.CPU] if host else []
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device, self.host = device, host
        self.prof = profile(activities=acts, acc_events=True)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def read(self) -> dict:
        device, host = [], []
        for e in self.prof.events():
            if getattr(e, "is_user_annotation", False) and e.device_type != torch.autograd.DeviceType.CPU:
                continue
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append((e.name, *span))
            elif e.device_type == torch.autograd.DeviceType.CPU:
                host.append((e.name, *span))
        busy = merged([(a, b) for _, a, b in device])
        kern = [(a, b) for n, a, b in device if is_tree_kernel(n)]
        coll = [(a, b) for n, a, b in device if is_collective(n)]
        by_op: dict = {}
        for n, a, b in device:
            key = n.replace("(anonymous namespace)::", "").split("(")[0].strip()[:120]
            by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e6
        lo = min((a for _, a, _ in host + device), default=0.0)
        hi = max((b for _, _, b in host + device), default=0.0)
        return {
            "busy_s": union_length(busy) / 1e6,
            "kernel_s": union_length(kern) / 1e6,
            "collective_s": union_length(coll) / 1e6,
            "launches": sum(is_kernel(n) for n, _, _ in device),
            "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": idle_gaps(busy, host, lo, hi,
                                   HOST_UNNAMED if self.host else HOST_UNTRACED),
        }


def idle_gaps(busy, host, lo: float, hi: float, unnamed: str = HOST_UNNAMED) -> list:
    """Idle time between ``lo`` and ``hi`` (µs) by the innermost host operation
    that spans each gap's middle (``unnamed`` where none does); the ``TOP``
    names with most idle seconds."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    events = sorted(host, key=lambda e: e[1])
    live: list = []
    j = 0
    totals: dict = {}
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while j < len(events) and events[j][1] <= mid:
            name, s, e = events[j]
            heapq.heappush(live, (-s, e, name))
            j += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        name = live[0][2] if live else unnamed
        totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
