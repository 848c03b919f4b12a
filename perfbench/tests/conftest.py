"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, the tuner's cache in each test's temporary directory, and a cell cut
to a size the CPU runs in a second."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def small(cell):
    """``cell`` at CPU-test size: 1,024-record frames, a pool of 6, at most 4
    trees, short stretches."""
    cell.config["frame_records"] = 1024
    cell.config["n_trees"] = min(cell.config["n_trees"], 4)
    cell.traffic.update(pool_frames=6, check_every=2, check_bytes=1 << 20, trace_seconds=0.2)
    lo, hi = cell.traffic["batch_frames"]
    cell.traffic["batch_frames"] = [2, 4] if lo != hi else [min(lo, 3)] * 2
    return cell


@pytest.fixture()
def cpu_run(tmp_path, monkeypatch):
    """Run a named cell of the benchmark on the CPU at test size."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    import time

    from perfbench import harness

    def run(name, *, seed=2**31 + 7, seconds=0.4, trace=False, control=False, root=ROOT):
        cell = small(harness.load_cell(root, name))
        return harness.run_cell(root, cell, seed=seed, seconds=seconds, trace=trace,
                                device="cpu", t_start=time.perf_counter(), control=control)

    return run
