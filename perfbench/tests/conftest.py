"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, the tuner's cache in each test's temporary directory, a cell cut to a
size the CPU runs in a second, and the cells kept in ``perfbench/cells/``
(entries not yet in BENCHMARK.json) loaded as BENCHMARK.json would hold
them."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def bench_with_kept() -> dict:
    """BENCHMARK.json with the entries of every kept cell added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "perfbench" / "cells").glob("*.json")):
        kept = json.loads(path.read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + kept[key]
    return bench


def kept_cell(name: str):
    """A kept cell, loaded by the harness as a cell of BENCHMARK.json."""
    from perfbench import harness

    return harness.load_cell(ROOT, name, bench_with_kept())


def checkout_with_kept(dest: Path) -> Path:
    """A checkout at ``dest`` whose BENCHMARK.json holds the kept cells: the
    benchmark's files copied, the port's source linked."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    (dest / "src").symlink_to(ROOT / "src")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench_with_kept()))
    return dest


def small_model(cfg: dict, traffic: dict) -> None:
    """A model cell's configuration and traffic at CPU-test size, in place:
    the port's smoke phi3.5-moe (2 layers, width 64, 4 experts, 512 ids) in
    float32 with its own limits, 8 prompts of 128 tokens (one 512-token MoE
    group a batch shard), turns of 8 tokens, 4 rows checked."""
    cfg.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
               dtype="float32", param_dtype="float32")
    cfg["moe"] = {**cfg["moe"], "n_experts": 4, "d_ff": 128}
    # float32 at this size: the program reads ~1e-6 of the logits' scale, the
    # float8 control ~0.07 over two layers (the full model's limits are for
    # bfloat16 over 32)
    cfg["check"] = {**cfg["check"], "logit_err": 0.01, "token_gap": 0.01}
    traffic.update(batch=8, prompt_tokens=128, turn_tokens=8, prefill_rows=8, warm_steps=2, kept_rows=4,
                   check_every=2, max_kept_steps=256, trace_seconds=0.2)


def small(cell):
    """``cell`` at CPU-test size: a tree cell's 1,024-record frames, a pool of
    6, at most 4 trees, short stretches; a model cell's :func:`small_model`."""
    if cell.config.get("kind", "tree") == "model":
        small_model(cell.config, cell.traffic)
        return cell
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
