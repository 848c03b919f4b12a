"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix and
metrics are read from ``BENCHMARK.json`` and the files it names.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics) and ``device``, then ``breakdown`` in a
traced run, then ``check``: each number compared with its limit, which also
ends standard error.  Without a CUDA device, or with fewer than the cell
asks for, it prints no result and exits 2; if JAX or the JAX package was
loaded, it prints no result and exits 3.

A cell on several cards starts one rank process a card (this script with
``--rank``; ``perfbench/ranks.py``), NCCL among them at a free port on this
host; set-up counts from this process's start, rank 0 hands back its
result, and a rank that fails or a run past ``DEADLINE_S`` ends them all
with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / "cache"
DEADLINE_S = 340.0        # a run on several cards, all of its ranks, ends by then


def prepare_env() -> None:
    """Caches inside the checkout at fixed paths; the tuner's starts empty."""
    CACHE.mkdir(parents=True, exist_ok=True)
    tune = CACHE / "tune-cache.json"
    tune.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tune)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def report(result: dict, info: dict) -> None:
    """The run's info, then each compared number beside its limit, on
    standard error; the result line last on standard output."""
    print("perfbench: " + json.dumps(info), file=sys.stderr)
    for name, item in result["check"].items():
        print(f"check {name}: {item}", file=sys.stderr)
    print(json.dumps(result))


def refuse_forbidden(harness) -> bool:
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark drives the port alone",
              file=sys.stderr)
    return bool(found)


def rank_commands(script: str, argv: list, world: int, t_start: float) -> list:
    """One command a rank: ``script`` with the same arguments, its rank and
    the run's rendezvous."""
    from perfbench.ranks import free_port

    port = free_port()
    return [[sys.executable, script, *argv, "--rank", str(r),
             "--world", str(world), "--init", f"tcp://127.0.0.1:{port}", "--t-start", repr(t_start)]
            for r in range(world)]


def add_rank_args(ap) -> None:
    """The arguments the launcher gives each rank process."""
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, help=argparse.SUPPRESS)


def rank_main(args, cell, harness, seeds: list, control: bool = False) -> int:
    """One rank of a cell on several cards: ``run_cell`` on each seed; rank 0
    hands each result and its info to the launcher.  Exits 2 where the
    rank's card is missing, as the launcher does."""
    from perfbench import ranks as rk

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
        print(f"perfbench: rank {args.rank} finds no card of its own", file=sys.stderr)
        return 2
    ranks = rk.join(args.rank, args.world, args.init, "cuda")
    try:
        for seed in seeds:
            t_start = args.t_start if seed == seeds[0] else time.perf_counter()
            result, info = harness.run_cell(ROOT, cell, seed=seed, seconds=args.seconds,
                                            trace=bool(args.trace), device="cuda",
                                            t_start=t_start, control=control, ranks=ranks)
            if refuse_forbidden(harness):
                return 3
            if ranks.rank == 0:
                rk.emit(json.dumps({"seed": seed, "result": result, "info": info}))
    finally:
        rk.leave()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    add_rank_args(ap)
    args = ap.parse_args(argv)
    prepare_env()
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if args.rank is not None:
        return rank_main(args, cell, harness, [args.seed])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from perfbench import ranks

        code, lines = ranks.launch(rank_commands(__file__, argv, cell.chips, T_START), DEADLINE_S)
        if code != 0 or len(lines) != 1 or refuse_forbidden(harness):
            return code or 1
        out = json.loads(lines[0])
        report(out["result"], out["info"])
        return 0
    result, info = harness.run_cell(ROOT, cell, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), device="cuda", t_start=T_START)
    if refuse_forbidden(harness):
        return 3
    report(result, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
