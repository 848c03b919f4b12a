"""A cell on several cards: one process a card on this host, and the launcher
that starts them.

``run.py`` starts one rank process a card (``launch``); each joins the
default process group (NCCL on cards, gloo on the CPU) at a ``tcp://``
address on this host, and a gloo group beside it that carries the
benchmark's own messages on the host, so that none of them queues behind
the program's work on the card: rank 0's decision, once a step, whether
the window (and the traced stretch) has ended (:meth:`Ranks.agree`), and,
after the window, what each rank kept for the check (:meth:`Ranks.gather`).
Only rank 0 prints a result.  The launcher waits for every rank; if one
fails, or the run outlives its deadline, it ends the others, and the run
exits nonzero with no result line.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

RESULT_PREFIX = "perfbench-rank0-result "
RANK_TIMEOUT_S = 240          # the process groups' timeout on any one collective


def free_port() -> int:
    """A TCP port on this host that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Ranks:
    """This process's place among the ranks of one run."""

    rank: int
    world: int
    side: object                 # the gloo group of the benchmark's messages
    agree_s: float = 0.0         # seconds spent in agree (rank 0's cost of the message)
    agree_calls: int = 0
    cache: dict = dataclasses.field(default_factory=dict)   # what outlives one run (a mesh)

    def agree(self, *flags: bool) -> tuple:
        """Rank 0's ``flags``, on every rank: one broadcast on the host."""
        t = time.perf_counter()
        msg = torch.tensor([int(f) for f in flags], dtype=torch.int32)
        dist.broadcast(msg, src=0, group=self.side)
        self.agree_s += time.perf_counter() - t
        self.agree_calls += 1
        return tuple(bool(v) for v in msg.tolist())

    def message_cost(self, n: int = 20) -> float:
        """Seconds one :meth:`agree` takes when no rank lags: ``n`` back to
        back after a barrier (the window's own also wait for the slowest rank)."""
        self.barrier()
        t = time.perf_counter()
        for _ in range(n):
            dist.broadcast(torch.zeros(2, dtype=torch.int32), src=0, group=self.side)
        return (time.perf_counter() - t) / n

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` on rank 0, in rank order; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.side)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.side)


def join(rank: int, world: int, init_method: str, device_type: str) -> Ranks:
    """Join the run's process groups: NCCL on card ``rank`` (or gloo on the CPU),
    and the benchmark's gloo group."""
    timeout = datetime.timedelta(seconds=RANK_TIMEOUT_S)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world,
                                timeout=timeout, device_id=torch.device("cuda", rank))
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                                timeout=timeout)
    return Ranks(rank=rank, world=world, side=dist.new_group(backend="gloo", timeout=timeout))


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(commands: list[list[str]], deadline_s: float, env: dict | None = None) -> tuple[int, list[str]]:
    """Run one process a rank, ``commands[r]``; their standard error passes
    through, rank 0's result lines (``RESULT_PREFIX``) are collected.

    Returns (exit code, rank 0's result lines).  The code is 0 only if every
    rank exited 0 within ``deadline_s``; else the first failing rank's code
    (or 124 at the deadline), and the other ranks are ended and waited for,
    so that none is left behind and none hangs on a collective."""
    procs = []
    lines: list[str] = []
    try:
        for r, cmd in enumerate(commands):
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                                          stdin=subprocess.DEVNULL, env=env, text=True))

        def read(stream):
            for line in stream:
                if line.startswith(RESULT_PREFIX):
                    lines.append(line[len(RESULT_PREFIX):].strip())
                else:
                    sys.stdout.write(line)

        reader = threading.Thread(target=read, args=(procs[0].stdout,), daemon=True)
        reader.start()
        t_end = time.monotonic() + deadline_s
        code = None
        while code is None:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                failed = next(r for r, c in enumerate(codes) if c not in (None, 0))
                print(f"perfbench: rank {failed} exited with {codes[failed]}; ending the others",
                      file=sys.stderr)
                code = bad[0]
            elif all(c == 0 for c in codes):
                code = 0
            elif time.monotonic() > t_end:
                print(f"perfbench: the ranks outlived the run's {deadline_s:.0f} s; ending them",
                      file=sys.stderr)
                code = 124
            else:
                time.sleep(0.05)
        if code != 0:
            return code, []
        reader.join(timeout=10)            # rank 0 has exited: its output is all there
        return code, lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def emit(line: str) -> None:
    """Rank 0's result line, to the launcher."""
    sys.stdout.write(RESULT_PREFIX + line + "\n")
    sys.stdout.flush()
