"""Resident frames: the pool already on the card, one caller, one batch in flight.

Each step classifies a contiguous run of frames of the pool through the
program's tuned entry, ``TunedEvaluator.__call__`` for one tree and
``ForestTunedEvaluator.predict`` for a forest, each with its default
resolution, and waits on an event until the classes are on the card.  The
batch sizes come in blocks that hold every size of the traffic's range once,
in an order drawn from the seed; offsets, and which answers are kept for the
check, are drawn from the seed too, a few thousand calls ahead, so that the
loop between calls does little but call.  An answer
that does not hold one class for each record it was asked for is counted
missing, and only the records it answered are credited.  The window's first
batch and a seeded one in ``check_every`` are copied aside, as int8, for the
check.
"""

from __future__ import annotations

import numpy as np
import torch


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.cell.traffic
        lo, hi = tr["batch_frames"]
        self.sizes = np.arange(int(lo), int(hi) + 1)
        self.pool_frames = int(tr["pool_frames"])
        self.rows = ctx.frame_records
        self.rng = ctx.rng(1)
        self.check_every = int(tr["check_every"])
        self.plan = []
        self.kept = []
        self.check = torch.empty(int(tr["check_bytes"]), dtype=torch.int8, device=ctx.device)
        self.check_used = 0
        self.check_full = 0
        self.missing = 0
        self.event = torch.cuda.Event() if ctx.device.type == "cuda" else None
        self.classify = self._system()

    def _system(self):
        ctx = self.ctx
        if ctx.control:
            from perfbench.reference.descend_torch import Bf16Reference

            return Bf16Reference(ctx.tables, ctx.n_classes, ctx.device)
        from repro_torch.core.forest import EncodedForest
        from repro_torch.core.tree import EncodedTree
        from repro_torch.tune import ForestTunedEvaluator, TunedEvaluator, TuneCache

        cache = TuneCache()
        if ctx.tables[0].shape[0] == 1:
            ev = TunedEvaluator(EncodedTree.from_arrays(*(t[0] for t in ctx.tables)),
                                cache=cache, device=ctx.device)
            return ev.__call__
        ev = ForestTunedEvaluator(EncodedForest.from_arrays(*ctx.tables), cache=cache,
                                  device=ctx.device)
        n_classes = ctx.n_classes
        return lambda records: ev.predict(records, n_classes)

    PLAN = 4096   # calls drawn at a time

    def _next(self) -> tuple[int, int, bool]:
        """The next call's (frames, first frame, kept for the check)."""
        if not self.plan:
            blocks = -(-self.PLAN // self.sizes.size)
            sizes = np.concatenate([self.rng.permutation(self.sizes) for _ in range(blocks)])
            offs = self.rng.integers(0, self.pool_frames - sizes + 1)
            keep = self.rng.integers(0, self.check_every, sizes.size) == 0
            self.plan = list(zip(sizes.tolist(), offs.tolist(), keep.tolist()))[::-1]
        return self.plan.pop()

    def _run(self, n: int, off: int) -> torch.Tensor:
        start = off * self.rows
        out = self.classify(self.ctx.pool[start:start + n * self.rows])
        if self.event is not None:
            self.event.record()
            self.event.synchronize()
        return out

    def warm(self) -> None:
        """Every batch size once, from the pool's first frame (the same in
        every run), then twice more so the allocator settles; the copy aside
        for the check once."""
        for _ in range(3):
            for n in self.sizes:
                out = self._run(int(n), 0)
        self.check[:out.shape[0]].copy_(out.clamp(-1, 127))

    def step(self) -> list[tuple[int, int]]:
        n, off, keep = self._next()
        out = self._run(n, off)
        start = off * self.rows
        asked = n * self.rows
        answered = int(out.shape[0]) if out.dim() == 1 else 0
        if answered != asked:
            self.missing += 1
        if keep or not self.kept:
            self._keep(start, out)
        return [(start, min(answered, asked))]

    def _keep(self, start: int, out: torch.Tensor) -> None:
        if out.dim() != 1:
            return
        n = int(out.shape[0])
        if self.check_used + n > self.check.shape[0]:
            self.check_full += 1
            return
        dst = self.check[self.check_used:self.check_used + n]
        dst.copy_(out.clamp(-1, 127))
        self.kept.append((start, dst))
        self.check_used += n

    def finish(self) -> tuple[list, int]:
        return self.kept, self.missing

    def counters(self) -> dict:
        return {"kept_batches": len(self.kept), "unkept_buffer_full": self.check_full,
                "short_answers": self.missing}

    def close(self) -> None:
        pass
