"""BENCHMARK.json against its contract and the files it names, and the cells
kept in ``perfbench/cells/`` against the same rules."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import cost, harness, trace_reader
from perfbench.tests.conftest import kept_files, with_kept

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
KEPT = kept_files()
SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")
# BENCHMARK.json with every kept cell's entries added, as a PR that adds them would
ALL = with_kept(BENCH, list(KEPT.values()))
ALL_CELLS = [w["name"] for w in ALL["workloads"]]
KINDS = {c["name"]: json.loads((ROOT / c["file"]).read_text()).get("kind", "tree") for c in ALL["configs"]}
# the tree cells' entries, as the benchmark's first PR set them: later entries
# are added beside them, never in their place
TREE_CONFIGS = ("seg-cart", "seg-bagged50")
TREE_ENTRIES_SHA256 = "b5f2517c8e23c52b3c26a4fb5ede60f12799ccceb0cb273697d49a29662fc135"


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    # four cards only where the cell measures what exists across cards, and
    # at most a quarter of the cells (rounded down), or one
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", ALL_CELLS)
def test_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(ROOT, name, ALL)
    assert (ROOT / "perfbench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.config["name"] == next(w["config"] for w in ALL["workloads"] if w["name"] == name)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_moves_an_end_to_end_metric_of_each_of_its_cells(metric):
    m = next(x for x in ALL["per_layer"] if x["name"] == metric)
    moves = next(e for e in ALL["end_to_end"] if e["name"] == m["moves"])
    assert m["moves"] != "setup_s"
    for cell in m.get("workloads", ALL_CELLS):
        assert cell in moves.get("workloads", ALL_CELLS)


@pytest.mark.parametrize("file", sorted(KEPT))
def test_a_kept_cell_is_entries_that_benchmark_json_could_take(file):
    # the entries keep BENCHMARK.json's rules, name nothing it already names,
    # and bring their own configuration, cell and end-to-end metric; the bound
    # is the adding PR's to set
    kept = KEPT[file]
    assert set(kept) == {"note", *SECTIONS}
    shared = {m["name"] for m in BENCH["end_to_end"]}
    assert file == f"{kept['workloads'][0]['name']}.json"
    for c in kept["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and not c["reduced"]
    for w in kept["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in ALL["configs"]}
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in kept["end_to_end"]:
        if m["name"] in shared:           # joins a metric of BENCHMARK.json, under its bound
            assert set(m) == {"name", "workloads"}
            assert set(m["workloads"]) <= {w["name"] for w in kept["workloads"]}
        else:
            assert set(m) == {"name", "unit", "better", "bound", "source", "workloads"} and m["bound"] is None
    for m in kept["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [e["name"] for k in SECTIONS for e in ALL[k]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in kept["end_to_end"] + kept["per_layer"] if m["name"] not in shared)


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_benchmark_json():
    names = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in names, m["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["end_to_end"] + ALL["per_layer"]])
def test_every_metric_has_a_reader_file_of_its_name_or_stem(metric):
    folder = ROOT / "perfbench" / "metrics"
    assert (folder / f"{metric}.py").is_file() or (folder / f"{metric.split('.')[0]}.py").is_file()


def test_the_shared_decode_rate_lists_model_cells_alone():
    rate = next(m for m in BENCH["end_to_end"] if m["name"] == "decode_tokens_per_s")
    config = {w["name"]: w["config"] for w in ALL["workloads"]}
    assert rate["workloads"]
    for cell in next(m for m in ALL["end_to_end"] if m["name"] == "decode_tokens_per_s")["workloads"]:
        assert KINDS[config[cell]] == "model", cell
    # every model cell's per-layer metrics move it
    for m in ALL["per_layer"]:
        if any(KINDS[config[c]] == "model" for c in m["workloads"]):
            assert m["moves"] == "decode_tokens_per_s", m["name"]


def test_the_tree_entries_are_unchanged():
    cells = {w["name"] for w in BENCH["workloads"] if w["config"] in TREE_CONFIGS}
    rates = {m["name"] for m in BENCH["end_to_end"]
             if m["name"] == "setup_s" or set(m.get("workloads", ())) <= cells}
    tree = {
        "configs": [c for c in BENCH["configs"] if c["name"] in TREE_CONFIGS],
        "workloads": [w for w in BENCH["workloads"] if w["name"] in cells],
        "end_to_end": [m for m in BENCH["end_to_end"] if m["name"] in rates],
        "per_layer": [m for m in BENCH["per_layer"] if m["moves"] in rates],
    }
    assert hashlib.sha256(json.dumps(tree, sort_keys=True).encode()).hexdigest() == TREE_ENTRIES_SHA256


def test_each_layer_is_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in by_layer:
        assert layer in perf, layer


def test_a_cell_and_a_metric_added_as_files_alone_are_picked_up(tmp_path, cpu_run):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/paper-frame.json").read_text())
    traffic["batch_frames"] = [5, 5]
    (root / "perfbench/traffic/frames-5.json").write_text(json.dumps(traffic))
    (root / "perfbench/metrics/records_per_frame.py").write_text(
        "def read(t):\n    return t.records / max(t.frames, 1e-9)\n")
    bench["workloads"].append({"name": "cart-5", "config": "seg-cart",
                               "traffic": "frames-5", "chips": 1, "why": "added by files"})
    bench["end_to_end"].append({"name": "records_per_s.cart5", "unit": "records/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["cart-5"]})
    # a new reader file, and an existing reader shared by a new metric's stem
    for name in ("records_per_frame.cart5", "idle_pct.cart5"):
        bench["per_layer"].append({"name": name, "unit": "records", "better": "higher",
                                   "source": "program_counter", "layer": "classification step",
                                   "moves": "records_per_s.cart5", "workloads": ["cart-5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root, "cart-5")
    assert cell.traffic["batch_frames"] == [5, 5]
    assert sorted(m["name"] for m in cell.end_to_end) == ["records_per_s.cart5", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["records_per_frame.cart5", "idle_pct.cart5"]
    result, _ = cpu_run("cart-5", root=root)
    assert result["correct"] and set(result["metrics"]) == {"records_per_s.cart5", "setup_s"}
    result, _ = cpu_run("cart-5", root=root, trace=True)
    assert result["correct"]
    # no device time on the CPU: the shared idle reader finds nothing to read
    assert result["metrics"] == {"records_per_frame.cart5": {"value": 1024, "unit": "records"}}


def test_a_metric_file_of_the_full_name_wins_over_its_stem(tmp_path):
    (tmp_path / "perfbench" / "metrics").mkdir(parents=True)
    for name, value in (("idle_pct", 1), ("idle_pct.special", 2)):
        (tmp_path / "perfbench" / "metrics" / f"{name}.py").write_text(
            f"def read(t):\n    return {value}\n")
    assert harness.metric_reader(tmp_path, "idle_pct.special").read(None) == 2
    assert harness.metric_reader(tmp_path, "idle_pct.other").read(None) == 1
    with pytest.raises(FileNotFoundError):
        harness.metric_reader(tmp_path, "missing.cart")


def test_the_eight_tree_kernels_are_frozen_and_named_in_the_ports_source():
    assert sorted(trace_reader.TREE_KERNELS) == [f"K{i}" for i in range(1, 9)]
    src = (ROOT / "src/repro_torch/kernels/tree_eval/csrc/tree_eval.cu").read_text()
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(",
                             src))
    assert set(trace_reader.TREE_KERNELS.values()) == defined - {"empty_kernel"}


@pytest.mark.parametrize("name, tree", [
    ("void (anonymous namespace)::speculative_kernel<true, 0>(float const*, int)", True),
    ("void (anonymous namespace)::fused_speculative_q_kernel<__nv_bfloat16, 2>(float const*)", True),
    ("void (anonymous namespace)::fused_votes_data_parallel_kernel(float const*)", True),
    ("data_parallel_kernel", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >", False),
    ("Memcpy DtoD (Device -> Device)", False),
    ("void at::native::speculative_kernel_helper(float)", False),
])
def test_device_events_are_read_as_tree_kernels_by_their_frozen_names(name, tree):
    assert trace_reader.is_tree_kernel(name) is tree


def test_cost_by_hand_for_the_papers_tree():
    # seg-cart's frame: M 65,536 records of A 19, one tree of N 31, 5 levels each
    s = cost.call_bound_s(65_536, 19, 1, 31, 65_536 * 5.0)
    assert s == pytest.approx((65_536 * 19 * 4 + 31 * 16 + 65_536 * 4) / 3.35e12)
    assert 65_536 * 19 * 4 + 31 * 16 + 65_536 * 4 == 5_243_376


def test_cost_by_hand():
    # the paper's frame: M 65,536 records of A 19, one tree of N 75, 6 levels each
    c = cost.tree_eval_cost(65_536, 19, 1, 75, 65_536 * 6)
    assert c == {"bytes": 65_536 * 19 * 4 + 75 * 16 + 65_536 * 4, "ops": 393_216.0}
    assert c["bytes"] == 5_244_080
    ms, which = cost.bound_ms(c["bytes"], c["ops"])
    assert which == "bytes" and ms == pytest.approx(5_244_080 / 3.35e12 * 1e3)
    assert cost.bound_ms(1.0, 67e9) == (pytest.approx(1.0), "operations")
    # a forest's call: T 16 trees of N 51, final classes once (M int32)
    s = cost.call_bound_s(65_536, 19, 16, 51, 65_536 * 16 * 6.0)
    assert s == pytest.approx((65_536 * 19 * 4 + 16 * 51 * 16 + 65_536 * 4) / 3.35e12)
