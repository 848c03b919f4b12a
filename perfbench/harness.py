"""One run of one benchmark cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file found by name:

- ``BENCHMARK.json`` names the cell's configuration, traffic mix and metrics;
- ``configs/<config>.json`` holds the configuration's sizes and its kind:
  a tree cell's CART settings (``"kind"`` absent or ``"tree"``), or a
  model cell's sizes, mesh, reference and check limits (``"model"``,
  ``perfbench/model_cell.py``);
- ``traffic/<traffic>.json`` holds the mix's parameters and names a driver,
  ``drivers/<driver>.py``, that runs the mix;
- ``metrics/<metric>.py`` reads one metric, end-to-end from the window or
  per-layer from the traced run; metrics that differ only by a suffix after
  the first dot (``idle_pct.cart``, ``idle_pct.forest``) share
  ``metrics/<stem>.py`` unless a file of their full name exists.

Tree cells.  The trees are the configuration's weights: the reference trainer
(``reference/cart.py``) trains them from the configuration's data seed, and
they are kept in ``cache/`` inside the checkout, keyed by configuration and
by a hash of the trainer's source, so only a checkout's first run trains.
``--seed`` makes the frames and the order of the traffic.

The program under test is reached only through the driver, which builds it
from the node arrays and records made here; the reference judges the
program's classes record by record.

Model cells make their weights and prompts from ``--seed`` and judge the
served tokens against a plain reference (``perfbench/model_cell.py``); on
several cards each rank runs this module's :func:`run_cell`, and rank 0
ends the window for all of them (``perfbench/ranks.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import trace_reader
from perfbench.cost import call_bound_s
from perfbench.reference import cart as ref_cart
from perfbench.reference import descend as ref_descend
from perfbench.reference import segmentation as ref_seg

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    """Import the file at ``path`` under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def metric_reader(root: Path, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file of
    its stem, the part before the first dot."""
    folder = root / "perfbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.is_file():
        path = folder / f"{name.split('.')[0]}.py"
    return load_module(path, "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def reported(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``metric`` belongs in ``cell``'s result line."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = next((m for m in bench["end_to_end"] if m["name"] == metric.get("moves")), None)
    return moves is None or "workloads" not in moves or cell in moves["workloads"]


def load_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``, a
    dict of the same keys) with its files loaded."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(work["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if reported(m, name, bench)],
        per_layer=[m for m in bench["per_layer"] if reported(m, name, bench)],
    )


TRAINING_KEYS = ("data_seed", "n_classes", "n_trees", "bootstrap", "rng_seed", "cart")


def trainer_hash(config: dict) -> str:
    """Hash of the reference trainer's source and of the training settings."""
    h = hashlib.sha256()
    for mod in (ref_cart, ref_seg):
        h.update(Path(mod.__file__).read_bytes())
    h.update(json.dumps({k: config[k] for k in TRAINING_KEYS}, sort_keys=True).encode())
    return h.hexdigest()[:16]


def trained_tables(config: dict) -> tuple[np.ndarray, ...]:
    """The configuration's trees as four (T, N) tables, trained once a checkout."""
    path = CACHE / f"trees-{config['name']}-{trainer_hash(config)}.npz"
    if path.exists():
        with np.load(path) as z:
            return tuple(z[k] for k in ("attr", "threshold", "child", "cls"))
    x_train, y_train, _, _ = ref_seg.make_segmentation(config["data_seed"])
    tables = ref_cart.train_trees(
        x_train, y_train, config["n_classes"], ref_cart.CartSettings(**config["cart"]),
        n_trees=config["n_trees"], bootstrap=config["bootstrap"], rng_seed=config["rng_seed"])
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, attr=tables[0], threshold=tables[1], child=tables[2], cls=tables[3])
    tmp.replace(path)
    return tables


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one purpose (``stream``) of one ``--seed``."""
    return np.random.default_rng([seed % 2**64, stream])


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the device, the trees and the frames."""

    cell: Cell
    seed: int
    device: torch.device
    tables: tuple            # four (T, N) numpy tables
    base: np.ndarray         # (4409, A) float32 base records
    index: np.ndarray        # (F, R) int32: frame f's rows as base-record indices
    pool: torch.Tensor       # (F·R, A) float32 frames, on the device
    row_compares: np.ndarray  # (F·R + 1,) running sum of the pool rows' compares
    control: bool            # the bfloat16 reference stands in for the program

    @property
    def frame_records(self) -> int:
        return int(self.index.shape[1])

    @property
    def n_classes(self) -> int:
        return int(self.cell.config["n_classes"])

    def rng(self, stream: int) -> np.random.Generator:
        return seed_rng(self.seed, stream)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    agree = None             # one card: no ranks to agree with

    def frames_of(self, records: int) -> float:
        return records / self.frame_records

    def call_bounds(self, start: int, n: int) -> tuple[float, float]:
        """The least seconds of one call of ``n`` records from pool row
        ``start`` (``perfbench/cost.py``): the step's bound and the tree
        kernels' alike."""
        t_count, n_nodes = self.tables[0].shape
        b = call_bound_s(n, int(self.cell.config["n_attrs"]), t_count, n_nodes,
                         float(self.row_compares[start + n] - self.row_compares[start]))
        return b, b

    def judge(self, kept: list, missing: int, device_info: dict):
        check, wrong_answers = judge(self, kept, missing)
        return check, wrong_answers + missing, device_info, {}


@dataclasses.dataclass
class Window:
    """What the window measured; end-to-end readers (``metrics/<name>.py``)
    take it whole."""

    seconds: float
    units: int               # calls made (one `step` each)
    records: int             # real records classified (a model cell: tokens decoded)
    frames: float
    latencies: list          # seconds a step
    stretch: dict | None     # the traced stretch: its seconds, records and bounds
    setup_s: float = 0.0     # process start to the window's first step


def run_window(driver, ctx, seconds: float, trace=None) -> Window:
    """Drive ``driver.step`` back to back for ``seconds``; with ``trace``,
    profile the first ``trace_seconds`` of it.

    A step returns its calls as (start, n): ``n`` units of work credited
    (records, tokens), and what the context's ``call_bounds`` needs to
    bound the call, read only in the traced stretch.  On several ranks
    (``ctx.agree``) rank 0 decides before each step whether the window, or
    the traced stretch, has ended, and every rank follows."""
    trace_s = float(ctx.cell.traffic.get("trace_seconds", 0)) if trace is not None else 0.0
    agree = ctx.agree

    lat, units, records = [], 0, 0
    bound = kernel_bound = 0.0
    stretch = None

    def traced(t_stop: float) -> dict:
        trace.stop()
        return {"seconds": t_stop - t0, "units": units, "records": records, "bound_s": bound,
                "kernel_bound_s": kernel_bound, "frames": ctx.frames_of(records)}

    if trace is not None:
        trace.start()
    t0 = time.perf_counter()
    while True:
        t_a = time.perf_counter()
        done = t_a - t0 >= seconds
        if agree is not None:
            done, end = agree(done, trace is not None and stretch is None and t_a - t0 >= trace_s)
            if end:
                stretch = traced(t_a)
        if done:
            break
        calls = driver.step()
        t_b = time.perf_counter()
        lat.append(t_b - t_a)
        units += 1
        for start, n in calls:
            records += n
            if trace is not None and stretch is None:
                b, k = ctx.call_bounds(start, n)
                bound += b
                kernel_bound += k
        if agree is None and trace is not None and stretch is None and t_b - t0 >= trace_s:
            stretch = traced(t_b)
    t_end = time.perf_counter()
    if trace is not None and stretch is None:
        stretch = traced(t_end)
    return Window(seconds=t_end - t0, units=units, records=records,
                  frames=ctx.frames_of(records), latencies=lat, stretch=stretch)


def judge(ctx: Context, kept: list, missing: int) -> tuple[dict, int]:
    """Hold every kept answer against the reference's classes of its rows.

    ``kept`` is a list of (first pool row, classes): a tensor on the device
    or a numpy array.  Returns the numbers compared, each with its limit,
    and how many kept answers held a wrong class.
    """
    ref_base, _ = ref_descend.classify(ctx.tables, ctx.base, ctx.n_classes)
    flat = ctx.index.reshape(-1)
    dev = ctx.device
    ref_dev = torch.from_numpy(ref_base).to(dev)
    wrong = checked = wrong_answers = 0
    for start, out in kept:
        n = int(out.shape[0])
        rows = torch.from_numpy(flat[start:start + n]).to(dev).long()
        want = ref_dev[rows]
        got = out.to(dev) if isinstance(out, torch.Tensor) else torch.from_numpy(np.asarray(out)).to(dev)
        bad = int((got.to(torch.int64) != want.to(torch.int64)).sum())
        wrong += bad
        checked += n
        wrong_answers += bad > 0
    return {
        "wrong_classes": {"value": wrong, "limit": 0},
        "answers_missing": {"value": missing, "limit": 0},
        "records_checked": {"value": checked, "min": 1},
    }, wrong_answers


def passed(check: dict) -> bool:
    """Every compared number within its limit (at most ``limit``, at least ``min``)."""
    return all(v["value"] <= v["limit"] if "limit" in v else v["value"] >= v["min"]
               for v in check.values())


def make_frames(cell: Cell, seed: int, device: torch.device):
    """Base records, the pool's index (F, R) and the pool itself on ``device``.

    Frame 0, which set-up warms the program with, is the configuration's own,
    drawn from its data seed: the program calibrates its plan on the first
    batch it sees (a sample of its leading records), so this frame is the
    same in every run, and ``seed`` draws the other frames and their order.
    """
    cfg = cell.config
    base = ref_seg.base_records(cfg["data_seed"])
    n_frames, rows = int(cell.traffic["pool_frames"]), int(cfg["frame_records"])
    index = ref_seg.frame_indices(seed_rng(seed, 0), base.shape[0], n_frames, rows)
    index[0] = ref_seg.frame_indices(seed_rng(int(cfg["data_seed"]), 2), base.shape[0], 1, rows)[0]
    base_dev = torch.from_numpy(base).to(device)
    pool = base_dev[torch.from_numpy(index.reshape(-1)).to(device).long()].contiguous()
    return base, index, pool


def tree_context(cell: Cell, seed: int, dev: torch.device, control: bool, marks: list) -> Context:
    """A tree cell's set-up: the trained trees, the frames, each pool row's compares."""
    tables = trained_tables(cell.config)
    marks.append(("trees", time.perf_counter()))
    base, index, pool = make_frames(cell, seed, dev)
    marks.append(("frames", time.perf_counter()))
    compares = ref_descend.classify(tables, base, int(cell.config["n_classes"]))[1]
    row_compares = np.concatenate([[0], np.cumsum(compares[index.reshape(-1)])])
    return Context(cell=cell, seed=seed, device=dev, tables=tables, base=base, index=index,
                   pool=pool, row_compares=row_compares, control=control)


def run_cell(root: Path, cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False, ranks=None):
    """One run of ``cell``: returns (result line, compared numbers), or
    (None, None) on a rank other than 0 of a cell on several cards."""
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    if cell.config.get("kind", "tree") == "tree":
        ctx = tree_context(cell, seed, dev, control, marks)
    else:
        from perfbench import model_cell

        ctx = model_cell.Context(cell=cell, seed=seed, device=dev, control=control, ranks=ranks)
    driver = load_module(root / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py",
                         f"perfbench_driver_{cell.traffic['driver']}").Driver(ctx)
    marks.append(("program", time.perf_counter()))
    try:
        driver.warm()
        ctx.sync()
        marks.append(("warm", time.perf_counter()))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        profiler = None
        if trace:
            profiler = trace_reader.Profiler(dev, host=bool(cell.traffic.get("trace_host", True)))
        if ranks is not None:
            agree_cost_s = ranks.message_cost()
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        before = driver.counters()
        win = run_window(driver, ctx, seconds, profiler)
        ctx.sync()
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        kept, missing = driver.finish()
        counters = {k: v - before.get(k, 0) for k, v in driver.counters().items()}
    finally:
        driver.close()
    device_info = {"peak": peak}
    if trace:
        read = profiler.read()
        device_info.update(busy_s=read["busy_s"], kernel_s=read["kernel_s"],
                           collective_s=read["collective_s"], launches=read["launches"])
    judged = ctx.judge(kept, missing, device_info)
    if judged is None:
        return None, None
    check, failed, device_info, judge_info = judged
    result = {
        "correct": passed(check),
        "attempted": win.units,
        "failed": failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": device_info["peak"],
        },
    }
    metrics = cell.per_layer if trace else cell.end_to_end
    if trace:
        result["device"]["busy_s"] = device_info["busy_s"]
        result["device"]["window_s"] = win.stretch["seconds"]
        source = trace_reader.TraceData(
            window_s=win.stretch["seconds"], busy_s=device_info["busy_s"],
            kernel_s=device_info["kernel_s"], bound_s=win.stretch["bound_s"],
            records=win.stretch["records"], frames=win.stretch["frames"],
            collective_s=device_info["collective_s"], kernel_bound_s=win.stretch["kernel_bound_s"],
            launches=device_info["launches"], steps=win.stretch["units"])
    else:
        source = dataclasses.replace(win, setup_s=setup_s)
    for metric in metrics:
        value = metric_reader(root, metric["name"]).read(source)
        if value is not None:
            result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
    if trace:
        result["breakdown"] = {"device_ops": read["device_ops"], "idle_gaps": read["idle_gaps"]}
    info = {"window_s": win.seconds, "units": win.units, "records": win.records,
            "setup_s": setup_s, "batch_p50_ms": statistics.median(win.latencies) * 1e3
            if win.latencies else None,
            "setup_parts_s": {name: b - a for (_, a), (name, b) in zip(
                [("process", t_start)] + marks, marks)},
            "counters": counters, **judge_info}
    if ranks is not None and ranks.agree_calls:
        info["agree_us_per_step"] = 1e6 * ranks.agree_s / ranks.agree_calls
        info["agree_message_us"] = 1e6 * agree_cost_s
    result["check"] = check
    return result, info


def forbidden_modules() -> list[str]:
    """Modules of the JAX package or JAX itself loaded in this process."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))
