"""Whole runs of the benchmark's tree cells on the CPU at test size: sound runs
come out correct, and the check catches the control and each planted fault."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KINDS = {c["name"]: json.loads((ROOT / c["file"]).read_text()).get("kind", "tree") for c in BENCH["configs"]}
# tree cells run in this process; model cells on ranks (test_perfbench_model.py)
CELLS = [w["name"] for w in BENCH["workloads"] if KINDS[w["config"]] == "tree"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, cpu_run):
    result, info = cpu_run(name)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["check"]["records_checked"]["value"] > 0
    names = set(result["metrics"])
    assert "setup_s" in names and len(names) >= 2
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_trace(name, cpu_run):
    result, _ = cpu_run(name, trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here, so no device time: every reader finds nothing to read
    assert result["metrics"] == {}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cpu_run):
    result, _ = cpu_run(name, control=True, seconds=0.6)
    assert not result["correct"]
    assert result["check"]["wrong_classes"]["value"] > 0


def _alter_one(out):
    out = out.clone()
    out[out.shape[0] // 3] = (out[out.shape[0] // 3] + 1) % 7
    return out


def _half_left_out(out):
    # half of the batch never classified: its answers copied from the rest
    out = out.clone()
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half]
    return out


def _truncated(out):
    # half of the batch never classified and left out of the answer
    return out[: out.shape[0] // 2].clone()


FAULTS = {"answer_altered": _alter_one, "half_left_out": _half_left_out,
          "truncated": _truncated}


def _plant(monkeypatch, name, fault):
    """Break the timed path underneath the harness: the tuned tree entry's
    classes for the tree cell, ``predict``'s voted classes for the forest."""
    from repro_torch.tune import dispatch

    if name.startswith("cart"):
        real = dispatch.TunedEvaluator.__call__
        monkeypatch.setattr(dispatch.TunedEvaluator, "__call__",
                            lambda self, records: fault(real(self, records)))
    else:
        real = dispatch.ForestTunedEvaluator.predict
        monkeypatch.setattr(dispatch.ForestTunedEvaluator, "predict",
                            lambda self, records, c: fault(real(self, records, c)))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, cpu_run, monkeypatch):
    _plant(monkeypatch, name, FAULTS[fault])
    result, info = cpu_run(name)
    assert not result["correct"] and result["failed"] > 0
    if fault == "truncated":
        # every answer short, and only the records answered are credited
        assert result["check"]["answers_missing"]["value"] == info["units"]
        from perfbench import harness
        from perfbench.tests.conftest import small

        call_rows = small(harness.load_cell(ROOT, name)).traffic["batch_frames"][0] * 1024
        assert info["records"] * 2 == info["units"] * call_rows
    else:
        assert result["check"]["wrong_classes"]["value"] > 0


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cart-streams64", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cart-streams64", "--seed", str(2**31 + 11),
         "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
