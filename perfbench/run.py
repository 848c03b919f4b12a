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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result, info = harness.run_cell(ROOT, cell, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark drives the port alone",
              file=sys.stderr)
        return 3
    print("perfbench: " + json.dumps(info), file=sys.stderr)
    for name, item in result["check"].items():
        print(f"check {name}: {item}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
