"""Fault-tolerant training loop: checkpoint/restart, a straggler watchdog
and the elastic re-mesh.

The port's counterpart of the JAX package's ``train/loop.py``:

  * **checkpoint/restart** — async atomic checkpoints every ``ckpt_every``
    steps; on a restartable step failure the loop restores the latest
    checkpoint and replays (at-least-once step semantics; the data pipeline
    is keyed by step, so replays see the same batches);
  * **straggler mitigation** — a step-time watchdog flags steps slower
    than ``factor`` × the running median and calls a hook;
  * **simulated failures** — ``failure_injector`` lets tests kill
    arbitrary steps to exercise the restart path;
  * **elastic re-mesh** — :func:`resize_mesh` re-places a state tree on
    another mesh over the same ranks (4×1 → 2×2).

Only :class:`SimulatedFailure` is restartable, as in JAX: a CUDA error or an
out-of-memory error ends the run.  The loop reads one number a step back
to the host, ``float(metrics["loss"])``.  A sharded model trains through
the same loop: every rank runs it, and its checkpoints are written by
rank 0 (``ckpt.checkpoint``).  A restartable failure must reach every rank
at the same step: the ranks then agree on the step to restore (rank 0's,
after its last save has been written) before any of them reads it.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Callable, Optional

from torch.distributed.tensor import DTensor

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.parallel import sharding as shd

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopState:
    model: Any          # the parameters live in the model, updated in place
    opt_state: Any
    step: int = 0


@dataclasses.dataclass
class LoopReport:
    final_step: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)


class StragglerWatchdog:
    """Flags steps slower than ``factor`` × running median of recent steps."""

    def __init__(self, factor: float = 3.0, window: int = 32, warmup: int = 3):
        self.factor = factor
        self.window = window
        self.warmup = warmup
        self.times: list[float] = []
        self.events = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times[-self.window:])
            slow = dt > self.factor * med
        self.times.append(dt)
        if slow:
            self.events += 1
        return slow


def train_loop(
    state: LoopState,
    train_step: Callable,
    batches: Callable[[int], Any],
    tcfg: TrainConfig,
    *,
    max_steps: Optional[int] = None,
    failure_injector: Optional[Callable[[int], None]] = None,
    straggler_hook: Optional[Callable[[int, float], None]] = None,
    restore_fn: Optional[Callable[[int], LoopState]] = None,
    max_restarts: int = 3,
) -> tuple[LoopState, LoopReport]:
    """Run the fault-tolerant loop.

    ``batches(step) -> batch`` must be a pure function of the step, for
    exact replay after a restart.  A step's time is the host clock from
    before the step to after its loss is read back.
    """
    total = max_steps if max_steps is not None else tcfg.total_steps
    saver = ckpt.AsyncSaver()
    watchdog = StragglerWatchdog()
    report = LoopReport()
    restarts = 0

    step = state.step
    while step < total:
        batch = batches(step)
        t0 = time.perf_counter()
        try:
            if failure_injector is not None:
                failure_injector(step)
            model, opt_state, metrics = train_step(state.model, state.opt_state, batch)
            loss = float(metrics["loss"])
            state = LoopState(model=model, opt_state=opt_state, step=step + 1)
        except ckpt_restartable_errors() as e:
            restarts += 1
            report.restarts = restarts
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts") from e
            log.warning("step %d failed (%s); restoring latest checkpoint", step, e)
            saver.wait()            # rank 0's last checkpoint is written before its step is shared
            last = ckpt.agreed_latest_step(tcfg.ckpt_dir)
            if last is None or restore_fn is None:
                log.warning("no checkpoint found; replaying step %d in place", step)
                continue
            state = restore_fn(last)
            step = state.step
            continue
        dt = time.perf_counter() - t0
        report.losses.append(loss)
        report.step_times.append(dt)
        if watchdog.observe(dt):
            report.stragglers = watchdog.events
            log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt,
                        statistics.median(watchdog.times[-watchdog.window:]))
            if straggler_hook is not None:
                straggler_hook(step, dt)
        step += 1
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
            saver.submit(tcfg.ckpt_dir, step,
                         {"params": state.model, "opt": state.opt_state},
                         extra={"loss": loss})
    saver.wait()
    report.final_step = step
    return state, report


class SimulatedFailure(RuntimeError):
    """Raised by tests' failure injectors to exercise the restart path."""


def ckpt_restartable_errors():
    return (SimulatedFailure,)


def resize_mesh(state_tree, target_shardings):
    """Elastic re-mesh: every leaf re-placed by ``target_shardings``.

    ``state_tree`` is a nested dict of DTensors (or plain tensors, the same on
    every rank); ``target_shardings`` a tree beside it of ``(mesh, spec)``.
    DTensor's ``redistribute`` stays within one mesh, so each leaf goes
    through its whole value, gathered on every rank, and each rank keeps its
    block on the target mesh.  Both meshes span the same ranks.
    """
    if isinstance(state_tree, dict):
        return {k: resize_mesh(v, target_shardings[k]) for k, v in state_tree.items()}
    mesh, spec = target_shardings
    full = state_tree.full_tensor() if isinstance(state_tree, DTensor) else state_tree
    return shd.place(full.detach(), mesh, spec)
