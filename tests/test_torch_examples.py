"""The five ``examples/*_torch.py`` scripts, each run as a user runs it, on
the host (``--device cpu``) at small arguments: exit code 0 and the lines
that say what each checked."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

CASES = {
    "quickstart": ([], ["EXACT MATCH"] * 5 + ["all evaluators agree"]),
    "segmentation_service": (["--images", "2"], ["image 0:", "image 1:", "steady-state latency"]),
    "serve_lm": (["--requests", "3", "--new-tokens", "4", "--prompt-len", "8", "--max-batch", "2"],
                 ["req 0:", "req 2:", "2 waves"]),
    "train_lm": (["--steps", "30", "--d-model", "64", "--layers", "1", "--seq", "32", "--batch", "2",
                  "--vocab", "512"], ["trained 30 steps", "restarts: 0"]),
    "tree_router_moe": (["--steps", "20"], ["soft-tree training", "expert load (hard routing)",
                                            "finite=True"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_example_runs_on_the_host(name, tmp_path):
    args, want = CASES[name]
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
               TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}_torch.py"), "--device", "cpu", *args],
                          capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    for line in set(want):
        assert out.count(line) >= want.count(line), (line, out)
    assert "MISMATCH" not in out


def test_torch_examples_refuse_without_a_card_unless_asked_for_the_host(tmp_path):
    """No ``--device``: the card, and a clear error where there is none."""
    code = ("import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['x']; runpy.run_path({str(REPO / 'examples' / 'serve_lm_torch.py')!r}, run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
                          cwd=tmp_path)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
