"""The lower-precision control: the reference in the program's place.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 --seconds 5

Runs the cell as ``run.py`` does, at its own sizes and load, with the
bfloat16 reference (``reference/descend_torch.py``: records rounded to
bfloat16, thresholds in float32) standing in for the program, once per seed
in one process, and prints each run's compared numbers.  The check must find
the control's classes wrong; the benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, prepare_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    prepare_env()
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        result, info = harness.run_cell(ROOT, cell, seed=seed, seconds=args.seconds, trace=False,
                                        device="cuda", t_start=time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bf16-records",
                          "correct": result["correct"], "check": result["check"],
                          "attempted": result["attempted"], "failed": result["failed"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
