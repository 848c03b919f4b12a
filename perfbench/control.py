"""The lower-precision control: the reference in the program's place.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 --seconds 5

Runs the cell as ``run.py`` does, at its own sizes and load, with the
control in the program's place, once per seed in one process (on several
cards, one process a rank), and prints each run's compared numbers.  A
tree cell's control is the bfloat16 reference (``reference/descend_torch.py``:
records rounded to bfloat16, thresholds in float32) classifying the frames;
a model cell's is the plain reference with its residual stream rounded to
float8 e4m3 (``perfbench/model_cell.py``) over the sequences the program
served in the run, whose own compared numbers are printed beside.  The
check must find the control wrong; the benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, add_rank_args, prepare_env, rank_commands, rank_main  # noqa: E402

DEADLINE_S = 3000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    add_rank_args(ap)
    args = ap.parse_args(argv)
    args.trace = 0
    prepare_env()
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if args.rank is not None:
        return rank_main(args, cell, harness, args.seeds, control=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("perfbench control: not enough CUDA devices", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from perfbench import ranks

        code, lines = ranks.launch(rank_commands(__file__, sys.argv[1:] if argv is None else argv,
                                                 cell.chips, T_START), DEADLINE_S)
        for line in lines:
            out = json.loads(line)
            print(json.dumps({"workload": args.workload, "seed": out["seed"], "control": "fp8-e4m3-residual",
                              "correct": out["result"]["correct"], "check": out["result"]["check"],
                              "program_check": out["info"].get("program_check"), "info": out["info"],
                              "attempted": out["result"]["attempted"], "failed": out["result"]["failed"]}))
        return code
    for seed in args.seeds:
        result, info = harness.run_cell(ROOT, cell, seed=seed, seconds=args.seconds, trace=False,
                                        device="cuda", t_start=time.perf_counter(), control=True)
        line = {"workload": args.workload, "seed": seed, "control": info.get("control", "bf16-records"),
                "correct": result["correct"], "check": result["check"],
                "attempted": result["attempted"], "failed": result["failed"]}
        if "program_check" in info:             # a model cell: the program's own numbers beside
            line.update(program_check=info["program_check"], info=info)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
