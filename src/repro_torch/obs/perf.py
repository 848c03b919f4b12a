"""Bench trajectory store + noise-aware perf-regression detection.

The port's own copy of the JAX package's ``obs/perf.py``, with the port's
environment key and header.  The paper's central claim is a *measured* one
(a 25% speculative-vs-data-parallel speedup on specific hardware), and a
bench snapshot is a point-in-time overwrite — a change that silently
regresses the tuned path would pass with the snapshot files alone.  This
module gives the port a memory of its own performance:

* **history store** — :func:`append_history` turns one bench payload (an
  :func:`env_header` plus the bench's ``entries``) into a single JSONL line
  under a history directory (``results/history/torch_<bench>.jsonl`` for the
  port's benches): the env header, plus per-workload medians and dispersion
  extracted by :func:`extract_series`.  Snapshots keep being overwritten;
  the trajectory only ever appends.
* **regression detector** — :func:`detect_regressions` compares the latest
  run against the median of the last ``window`` runs *from the same
  environment* (same backend / device kind / device count / torch version /
  CUDA version — cross-machine timings must never compare, and a torch run
  never compares against a JAX run) and flags a series when its latest
  median exceeds the baseline by more than
  ``max(rel_threshold · baseline, k_mad · MAD)``.  The MAD term adapts the
  gate to each series' observed run-to-run noise; the relative floor keeps
  an all-identical history (MAD = 0) from flagging sub-noise jitter.

Stdlib-only at import: :func:`env_header` imports torch inside the call.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from datetime import datetime, timezone
from pathlib import Path
from typing import Iterable, Optional

__all__ = [
    "ENV_KEYS",
    "Regression",
    "append_history",
    "check_history_dir",
    "detect_regressions",
    "env_header",
    "env_key",
    "extract_series",
    "history_record",
    "load_history",
    "skipped_series",
]

#: Environment fields two runs must share before their timings may compare.
#: Intentionally excludes ``platform``/``python``: a kernel upgrade on the
#: same machine class should not orphan the whole baseline, but a different
#: backend, device kind, device count, torch or CUDA version is a different
#: experiment.  A JAX header carries no ``torch`` key, so its key never
#: equals a torch run's.
ENV_KEYS = ("backend", "device_kind", "device_count", "torch", "cuda")

# Keys (in priority order) a bench entry may carry its headline median /
# dispersion under — the BENCH_*.json schemas are per-bench, the trajectory
# is not.
_MEDIAN_KEYS = ("median_ms", "tuned_ms", "forest_tuned_ms", "measured_ms")
_DISPERSION_KEYS = ("mad_ms", "tuned_mad_ms", "forest_tuned_mad_ms")


def env_header(device=None) -> dict:
    """The environment stamp every bench payload of the port carries.

    ``device=None`` is the card (raises without one); ``"cpu"`` stamps a
    host run, which never compares with a card run.  A number without its
    environment is unreproducible: this header makes each artifact
    self-describing.
    """
    import platform

    import torch

    from repro_torch import _device

    dev = _device.resolve(None, device)
    cuda = dev.type == "cuda"
    return {
        "env": {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": dev.type,
            "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "python": platform.python_version(),
            "platform": platform.platform(),
        }
    }


def env_key(env: dict) -> tuple:
    """The comparability key of one run's environment header."""
    return tuple(str(env.get(k)) for k in ENV_KEYS)


def _series_name(entry: dict) -> Optional[str]:
    """A stable trajectory id for one bench entry (None = not a timing row)."""
    base = entry.get("name") or entry.get("workload") or entry.get("mix")
    if not base:
        return None
    parts = [str(base)]
    mesh = entry.get("mesh")
    if mesh:
        parts.append("mesh" + "x".join(str(x) for x in mesh))
    for k in ("decomposition", "mode", "variant"):
        if entry.get(k):
            parts.append(str(entry[k]))
    if entry.get("stages") is not None:
        parts.append(f"s{entry['stages']}")
    if "bound" in entry:
        parts.append(f"b{entry['bound']}")
    return "/".join(parts)


def extract_series(payload: dict) -> dict[str, dict]:
    """Normalise one bench payload into ``{series: {median_ms[, mad_ms]}}``.

    Walks ``entries`` and ``forest_entries`` (the two timing lists the
    benches emit), derives a stable series name per row, and picks the
    row's headline median (``median_ms`` / ``tuned_ms`` / ``measured_ms``
    ...) plus its dispersion when recorded.  Rows without a recognisable
    median (accuracy-only or summary rows) are skipped.
    """
    out: dict[str, dict] = {}
    for group in ("entries", "forest_entries"):
        for entry in payload.get(group) or []:
            if not isinstance(entry, dict):
                continue
            name = _series_name(entry)
            if name is None:
                continue
            median = next(
                (entry[k] for k in _MEDIAN_KEYS
                 if isinstance(entry.get(k), (int, float))),
                None,
            )
            if median is None:
                continue
            rec: dict = {"median_ms": float(median)}
            disp = next(
                (entry[k] for k in _DISPERSION_KEYS
                 if isinstance(entry.get(k), (int, float))),
                None,
            )
            if disp is not None:
                rec["mad_ms"] = float(disp)
            key, i = name, 2
            while key in out:                  # defensive: never drop a row
                key, i = f"{name}#{i}", i + 1
            out[key] = rec
    return out


def history_record(bench: str, payload: dict, *, ts: Optional[str] = None,
                   source: str = "bench") -> dict:
    """One trajectory line: env header + normalised series of a bench run."""
    return {
        "bench": bench,
        "ts": ts or datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "source": source,
        "env": payload.get("env") or {},
        "series": extract_series(payload),
    }


def append_history(history_dir, bench: str, payload: dict, *,
                   ts: Optional[str] = None, source: str = "bench") -> Path:
    """Append one run to ``<history_dir>/<bench>.jsonl`` (created on demand)."""
    history_dir = Path(history_dir)
    history_dir.mkdir(parents=True, exist_ok=True)
    path = history_dir / f"{bench}.jsonl"
    line = json.dumps(history_record(bench, payload, ts=ts, source=source),
                      sort_keys=True)
    with open(path, "a") as f:
        f.write(line + "\n")
    return path


def load_history(path) -> list[dict]:
    """All runs of one trajectory file, oldest first (blank lines skipped)."""
    out = []
    text = Path(path).read_text()
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i}: corrupt history line: {e}") from None
    return out


@dataclasses.dataclass(frozen=True)
class Regression:
    """One flagged series: latest median above the noise-aware threshold."""

    bench: str
    series: str
    latest_ms: float
    baseline_ms: float
    threshold_ms: float
    mad_ms: float
    n_baseline: int

    @property
    def ratio(self) -> float:
        return self.latest_ms / self.baseline_ms if self.baseline_ms else float("inf")

    def describe(self) -> str:
        return (
            f"{self.bench}/{self.series}: {self.latest_ms:.3f} ms vs baseline "
            f"{self.baseline_ms:.3f} ms (x{self.ratio:.2f}, threshold "
            f"{self.threshold_ms:.3f} ms over {self.n_baseline} run(s), "
            f"MAD {self.mad_ms:.3f} ms)"
        )


def baseline_pool(records: list[dict], *, window: int = 5) -> list[dict]:
    """The latest run's comparable predecessors: same env, last ``window``."""
    if len(records) < 2:
        return []
    key = env_key(records[-1].get("env") or {})
    pool = [r for r in records[:-1] if env_key(r.get("env") or {}) == key]
    return pool[-window:]


def detect_regressions(
    records: list[dict],
    *,
    bench: str = "?",
    window: int = 5,
    rel_threshold: float = 0.5,
    k_mad: float = 5.0,
) -> list[Regression]:
    """Flag series whose latest median regressed beyond the noise gate.

    Baseline per series = median of that series over the last ``window``
    same-environment runs preceding the latest; a series is flagged when

        latest > baseline + max(rel_threshold * baseline, k_mad * MAD)

    where MAD is the median absolute deviation of the baseline pool's
    medians.  Single-run histories, env-mismatched histories and series
    absent from the baseline contribute nothing (a new workload is not a
    regression).
    """
    latest = records[-1] if records else {}
    pool = baseline_pool(records, window=window)
    if not pool:
        return []
    out: list[Regression] = []
    for name, s in sorted((latest.get("series") or {}).items()):
        base_vals = [
            float(r["series"][name]["median_ms"])
            for r in pool
            if name in (r.get("series") or {})
        ]
        if not base_vals:
            continue
        baseline = statistics.median(base_vals)
        mad = statistics.median([abs(v - baseline) for v in base_vals])
        threshold = baseline + max(rel_threshold * baseline, k_mad * mad)
        latest_ms = float(s["median_ms"])
        if baseline > 0 and latest_ms > threshold:
            out.append(Regression(
                bench=bench, series=name, latest_ms=latest_ms,
                baseline_ms=baseline, threshold_ms=threshold,
                mad_ms=mad, n_baseline=len(base_vals),
            ))
    return out


def skipped_series(
    records: list[dict],
    *,
    window: int = 5,
    min_runs: int = 2,
) -> list[tuple[str, int]]:
    """Series in the latest run whose baseline is too thin to judge.

    Returns ``(series, n_baseline)`` for every series of the latest run
    backed by fewer than ``min_runs`` same-environment predecessor entries
    in the ``window``-run pool — including zero (a brand-new workload, or a
    history whose env just changed).  :func:`detect_regressions` silently
    contributes nothing for these; the CI gate wants them *reported*, so a
    run that checked nothing cannot read as a run that passed.
    """
    latest = records[-1] if records else {}
    pool = baseline_pool(records, window=window)
    out: list[tuple[str, int]] = []
    for name in sorted(latest.get("series") or {}):
        n = sum(1 for r in pool if name in (r.get("series") or {}))
        if n < min_runs:
            out.append((name, n))
    return out


def check_history_dir(
    history_dir,
    *,
    benches: Optional[Iterable[str]] = None,
    window: int = 5,
    rel_threshold: float = 0.5,
    k_mad: float = 5.0,
) -> dict[str, list[Regression]]:
    """Run :func:`detect_regressions` over every trajectory in a directory.

    Returns ``{bench: [Regression, ...]}`` with an entry for every file
    examined (empty list = healthy), so callers can distinguish "checked
    and clean" from "never checked".
    """
    history_dir = Path(history_dir)
    wanted = set(benches) if benches is not None else None
    out: dict[str, list[Regression]] = {}
    for path in sorted(history_dir.glob("*.jsonl")):
        bench = path.stem
        if wanted is not None and bench not in wanted:
            continue
        out[bench] = detect_regressions(
            load_history(path), bench=bench, window=window,
            rel_threshold=rel_threshold, k_mad=k_mad,
        )
    return out
