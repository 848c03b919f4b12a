"""The port's bench trajectory store and noise-aware regression detector
(``repro_torch.obs.perf``): the detector and history tests of the JAX
package's ``tests/test_obs_perf.py`` on the port's copy, on tmp paths, and
the port's environment key, which never equals a JAX run's.
"""

import platform

import pytest
import torch

from repro_torch.obs.perf import (
    ENV_KEYS,
    append_history,
    baseline_pool,
    check_history_dir,
    detect_regressions,
    env_header,
    env_key,
    extract_series,
    load_history,
    skipped_series,
)

ENV = {
    "backend": "cuda",
    "device_kind": "NVIDIA H100 80GB HBM3",
    "device_count": 1,
    "torch": "2.11.0+cu128",
    "cuda": "12.8",
}


def _run(medians, env=ENV):
    """One trajectory record with the given {series: median_ms}."""
    return {
        "bench": "t",
        "ts": "2026-01-01T00:00:00+00:00",
        "source": "test",
        "env": dict(env),
        "series": {k: {"median_ms": float(v)} for k, v in medians.items()},
    }


# ---------------------------------------------------------------------------
# regression detector
# ---------------------------------------------------------------------------


class TestRegressionDetector:
    def test_single_run_history_never_flags(self):
        assert detect_regressions([_run({"w": 1.0})]) == []
        assert detect_regressions([]) == []

    def test_env_mismatch_never_compares(self):
        # 10x slower on a different backend is a different experiment, not a
        # regression — the baseline pool must come up empty.
        hist = [_run({"w": 1.0}) for _ in range(4)]
        cpu = dict(ENV, backend="cpu", device_kind="cpu", cuda=None)
        hist.append(_run({"w": 10.0}, env=cpu))
        assert baseline_pool(hist) == []
        assert detect_regressions(hist) == []
        # same-env latest still compares against same-env predecessors only
        hist.append(_run({"w": 10.0}))
        pool = baseline_pool(hist)
        assert len(pool) == 4 and all(env_key(r["env"]) == env_key(ENV) for r in pool)
        flagged = detect_regressions(hist)
        assert [r.series for r in flagged] == ["w"]

    def test_mad_zero_identical_history(self):
        # All-identical history: MAD = 0, so the relative floor carries the
        # gate alone — an equal latest passes, sub-threshold jitter passes,
        # a 2x latest is flagged.
        hist = [_run({"w": 1.0}) for _ in range(5)]
        assert detect_regressions(hist + [_run({"w": 1.0})]) == []
        assert detect_regressions(hist + [_run({"w": 1.4})]) == []
        flagged = detect_regressions(hist + [_run({"w": 2.0})])
        assert len(flagged) == 1
        r = flagged[0]
        assert r.series == "w" and r.mad_ms == 0.0
        assert r.baseline_ms == pytest.approx(1.0)
        assert r.ratio == pytest.approx(2.0)
        assert r.threshold_ms == pytest.approx(1.5)
        assert "x2.00" in r.describe()

    def test_mad_widens_gate_on_noisy_series(self):
        # baseline median 12, MAD 2: k_mad*MAD = 10 beats the relative floor
        # (6), so a 20 ms latest — over 1.5x baseline — still passes.
        hist = [_run({"w": v}) for v in (10.0, 14.0, 10.0, 14.0, 12.0)]
        assert detect_regressions(hist + [_run({"w": 20.0})]) == []
        flagged = detect_regressions(hist + [_run({"w": 23.0})])
        assert [r.series for r in flagged] == ["w"]

    def test_synthetic_2x_regression_flagged(self):
        hist = [_run({"fast": 1.0, "slow": 8.0}) for _ in range(5)]
        flagged = detect_regressions(hist + [_run({"fast": 2.0, "slow": 8.0})])
        assert [(r.series, round(r.ratio, 2)) for r in flagged] == [("fast", 2.0)]

    def test_new_series_is_not_a_regression(self):
        hist = [_run({"w": 1.0}) for _ in range(3)]
        assert detect_regressions(hist + [_run({"w": 1.0, "brand_new": 99.0})]) == []

    def test_window_bounds_the_pool(self):
        hist = [_run({"w": float(i)}) for i in range(10)]
        pool = baseline_pool(hist, window=3)
        assert [r["series"]["w"]["median_ms"] for r in pool] == [6.0, 7.0, 8.0]


class TestSkippedSeries:
    """Series detect_regressions silently skips must still be reportable."""

    def test_thin_baseline_is_reported_with_its_count(self):
        # seed run only: the series has zero same-env predecessors
        assert skipped_series([_run({"w": 1.0})]) == [("w", 0)]
        # one predecessor: still below the default min_runs=2
        hist = [_run({"w": 1.0}), _run({"w": 1.0, "new": 5.0})]
        assert skipped_series(hist) == [("new", 0), ("w", 1)]
        # enough history: nothing to report
        assert skipped_series([_run({"w": 1.0}) for _ in range(3)]) == []
        assert skipped_series([]) == []

    def test_env_change_orphans_the_baseline(self):
        # same trick as test_env_mismatch_never_compares: a backend switch
        # empties the pool, so every series of the latest run shows up skipped
        cpu = dict(ENV, backend="cpu", device_kind="cpu", cuda=None)
        hist = [_run({"w": 1.0}) for _ in range(4)] + [_run({"w": 1.0}, env=cpu)]
        assert skipped_series(hist) == [("w", 0)]

    def test_min_runs_raises_the_bar(self):
        hist = [_run({"w": 1.0}) for _ in range(4)]
        assert skipped_series(hist, min_runs=3) == []
        assert skipped_series(hist, min_runs=4) == [("w", 3)]


# ---------------------------------------------------------------------------
# history store
# ---------------------------------------------------------------------------


class TestHistoryStore:
    def test_extract_series_names_and_fallbacks(self):
        payload = {
            "entries": [
                {"name": "w", "median_ms": 1.5, "mad_ms": 0.1},
                {"workload": "x", "tuned_ms": 2.0, "tuned_mad_ms": 0.2,
                 "variant": "fused"},
                {"name": "acc_only", "accuracy": 0.9},  # no median -> skipped
                {"name": "w", "median_ms": 9.0},        # collision -> suffixed
            ],
            "forest_entries": [
                {"name": "f", "forest_tuned_ms": 3.0, "stages": 2, "bound": 0.25},
            ],
        }
        series = extract_series(payload)
        assert series["w"] == {"median_ms": 1.5, "mad_ms": 0.1}
        assert series["x/fused"] == {"median_ms": 2.0, "mad_ms": 0.2}
        assert series["w#2"] == {"median_ms": 9.0}
        assert series["f/s2/b0.25"] == {"median_ms": 3.0}
        assert "acc_only" not in series

    def test_append_load_roundtrip(self, tmp_path):
        payload = {"env": dict(ENV),
                   "entries": [{"name": "w", "median_ms": 1.0, "mad_ms": 0.05}]}
        append_history(tmp_path, "toy", payload, ts="2026-01-01T00:00:00+00:00")
        append_history(tmp_path, "toy", payload)
        records = load_history(tmp_path / "toy.jsonl")
        assert len(records) == 2
        assert records[0]["ts"] == "2026-01-01T00:00:00+00:00"
        assert records[0]["series"]["w"]["median_ms"] == 1.0
        assert env_key(records[0]["env"]) == env_key(ENV)
        assert all(k in records[0]["env"] for k in ENV_KEYS)

    def test_corrupt_line_raises_with_location(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text('{"ok": 1}\nnot json at all\n')
        with pytest.raises(ValueError, match="bad.jsonl:2"):
            load_history(path)


# ---------------------------------------------------------------------------
# the port's environment header and key
# ---------------------------------------------------------------------------


class TestEnvHeader:
    def test_cpu_header_names_torch_and_its_device(self):
        env = env_header("cpu")["env"]
        assert env["backend"] == "cpu" and env["device_kind"] == "cpu" and env["device_count"] == 1
        assert env["torch"] == torch.__version__ and env["cuda"] == torch.version.cuda
        assert env["python"] == platform.python_version()
        assert ENV_KEYS == ("backend", "device_kind", "device_count", "torch", "cuda")

    def test_default_is_the_card_and_raises_without_one(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            env_header()

    def test_torch_key_never_equals_a_jax_key(self):
        # the JAX package's header (benchmarks/common.py env_header) on the
        # same host: same backend, kind and count, but no torch/cuda fields
        torch_env = env_header("cpu")["env"]
        jax_env = {"jax": "0.9.0", "backend": "cpu", "device_kind": "cpu", "device_count": 1,
                   "pallas_interpret": True, "python": torch_env["python"], "platform": torch_env["platform"]}
        assert env_key(torch_env) != env_key(jax_env)
        hist = [_run({"w": 1.0}, env=jax_env) for _ in range(4)] + [_run({"w": 10.0}, env=torch_env)]
        assert baseline_pool(hist) == [] and detect_regressions(hist) == []

    def test_check_history_dir_reads_a_torch_trajectory(self, tmp_path):
        payload = {**env_header("cpu"), "entries": [{"name": "k1", "median_ms": 1.0}]}
        for _ in range(4):
            append_history(tmp_path, "torch_toy", payload)
        append_history(tmp_path, "torch_toy", {**payload, "entries": [{"name": "k1", "median_ms": 3.0}]})
        found = check_history_dir(tmp_path)
        assert list(found) == ["torch_toy"]
        assert [(r.series, r.n_baseline) for r in found["torch_toy"]] == [("k1", 4)]
        assert check_history_dir(tmp_path, benches=["other"]) == {}
