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


def with_kept(bench: dict, kept_cells: list) -> dict:
    """``bench`` with the entries of each kept cell added: an end-to-end
    entry that names a metric ``bench`` has (``name`` and ``workloads``
    alone) adds the cell to that metric's ``workloads``, under its bound."""
    out = {**bench, "end_to_end": [dict(m) for m in bench["end_to_end"]]}
    for kept in kept_cells:
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {m["name"]: m for m in out[key]} if key == "end_to_end" else {}
            fresh = [e for e in kept[key] if e["name"] not in have]
            for e in kept[key]:
                if e["name"] in have:
                    have[e["name"]]["workloads"] = have[e["name"]]["workloads"] + e["workloads"]
            out[key] = out[key] + fresh
    return out


def kept_files() -> dict:
    """The kept cells' files by name, parsed."""
    return {p.name: json.loads(p.read_text()) for p in sorted((ROOT / "perfbench" / "cells").glob("*.json"))}


def bench_with_kept() -> dict:
    """BENCHMARK.json with the entries of every kept cell added."""
    return with_kept(json.loads((ROOT / "BENCHMARK.json").read_text()), list(kept_files().values()))


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
    the widths, depth, experts and vocabulary of the port's smoke twin of
    the configuration's registry entry (``get_smoke_config``) in float32 with
    their own limits, 8 prompts of 128 tokens (one 512-token MoE group a
    batch shard), turns of 8 tokens, 4 rows checked with their logits kept
    at every step (a fault that shows from a turn's second step on is seen
    however few steps a loaded machine runs)."""
    from repro_torch.configs import get_smoke_config

    smoke = get_smoke_config(cfg["registry"])
    cfg.update({k: getattr(smoke, k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                                                "vocab_size")})
    cfg["moe"] = {**cfg["moe"], **{k: getattr(smoke.moe, k) for k in ("n_experts", "top_k", "d_ff",
                                                                      "router_tree_depth")}}
    cfg.update(dtype="float32", param_dtype="float32")
    # float32 at this size: the program reads ~1e-6 of the logits' scale, the
    # float8 control ~0.07 over two layers (the full model's limits are for
    # bfloat16 over 32)
    cfg["check"] = {**cfg["check"], "logit_err": 0.01, "token_gap": 0.01}
    traffic.update(batch=8, prompt_tokens=128, turn_tokens=8, prefill_rows=8, warm_steps=2, kept_rows=4,
                   check_every=1, max_kept_steps=256, trace_seconds=0.2)


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
