"""The model cells on the CPU at test size: the plain reference against the
port (phi3.5-moe's and granite-moe's smoke shapes), whole runs of the kept
phi cell on four gloo ranks (sound, traced, the control, planted faults,
and a sound run on the layout the port's planner gives the smoke model),
whole runs of ``granite-decode`` in this process on one card's path (sound,
traced, the control, planted faults), and the launcher ending a run whose
rank fails."""

import json
import math
import multiprocessing as mp
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import cost, harness, model_cell, ranks, trace_reader
from perfbench.cost_decode import decode_step_bound_s, decode_step_cost
from perfbench.reference import phi_moe
from perfbench.tests import model_worker
from perfbench.tests.conftest import checkout_with_kept, kept_cell, small

ROOT = Path(__file__).resolve().parents[2]
CELL = "phi-moe-decode-2x2"
GRANITE = "granite-decode"
JOIN_TIMEOUT_S = 300
FAULTS = ["logit_perturbed", "short_answer", "route_swapped", "exchange_left_out", "state_unchanged"]
SCENARIOS = ["sound", "traced", "control", *FAULTS, "planner_layout"]
# one card: no exchange between cards to leave out
ONE_CARD_FAULTS = ["logit_perturbed", "short_answer", "route_swapped", "state_unchanged"]


def test_reference_matches_the_port_at_smoke_size():
    _reference_against_the_port(small(kept_cell(CELL)).config)


def test_reference_matches_the_port_at_granite_smoke_size():
    # the port's granite-moe smoke shape: 5 experts, top 3, a depth-3 tree
    # whose 8 leaves wrap onto the 5 experts
    cfg = small(harness.load_cell(ROOT, GRANITE)).config
    assert (cfg["moe"]["n_experts"], cfg["moe"]["top_k"], cfg["moe"]["router_tree_depth"]) == (5, 3, 3)
    _reference_against_the_port(cfg)


def _reference_against_the_port(cfg: dict) -> None:
    # prefill, then greedy decode through the cache, against the reference's
    # full forward over the same tokens: every logit and every route
    from perfbench.drivers.decode import PARAMS, TOP, program_config
    from repro_torch.models import build_model

    model = build_model(program_config(cfg), device="cpu")
    weights = phi_moe.Weights(cfg, 2**31 + 5, "cpu")
    named = dict(model.named_parameters())
    with torch.no_grad():
        for i in range(cfg["n_layers"]):
            for key, t in weights.layer(i).items():
                named[f"layers.{i}.{PARAMS[key]}"].copy_(t)
        for key, t in weights.top().items():
            p = named[TOP[key]]
            p.zero_()
            p[tuple(slice(0, n) for n in t.shape)].copy_(t)
    model.pack_routers()
    routes = [[] for _ in range(cfg["n_layers"])]
    for i, r in enumerate(model.tree_routers()):
        r.register_forward_hook(lambda m, a, out, i=i: routes[i].append(out.reshape(2, -1)))
    prompt = model_cell.prompt_tokens(cfg, {"batch": 2, "prompt_tokens": 128}, 2**31 + 5, "cpu").long()
    steps = 6
    logits, cache = model.prefill({"tokens": prompt}, max_len=128 + steps)
    got, ids = [logits[:, -1]], [prompt]
    for _ in range(steps):
        tok = logits[:, -1, :cfg["vocab_size"]].argmax(-1, keepdim=True)
        ids.append(tok)
        logits, cache = model.decode_step(cache, {"tokens": tok})
        got.append(logits[:, -1])
    seq = torch.cat(ids, dim=1)
    ref = phi_moe.forward(weights, seq)
    want = ref["logits"][:, 127:]
    got = torch.stack(got, dim=1)[..., :cfg["vocab_size"]]
    # float32 on both sides: only the order of the sums differs
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    prog = torch.stack([torch.cat(r, dim=1) for r in routes])
    assert torch.equal(prog, ref["routes"][:, :, :prog.shape[2]])


def _two_way_experts(h, w, e1, n_experts):
    """The reference's expert mixture before it took ``top_k``: expert ``e1``
    and the one after it, each with gate 1/2."""
    flat = h.reshape(-1, h.shape[-1])
    first = e1.reshape(-1)
    y = torch.zeros_like(flat)
    for e in range(n_experts):
        rows = ((first == e) | ((first + 1) % n_experts == e)).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        x = flat[rows]
        wi, wg, wo = (w[k][e].float() for k in ("wi", "wg", "wo_e"))
        y.index_add_(0, rows, 0.5 * ((torch.nn.functional.silu(x @ wg) * (x @ wi)) @ wo))
    return y.view_as(h)


def test_top_k_experts_leave_the_two_way_reference_bit_for_bit(monkeypatch):
    cfg = small(kept_cell(CELL)).config
    assert cfg["moe"]["top_k"] == 2
    weights = phi_moe.Weights(cfg, 2**31 + 21, "cpu")
    tokens = model_cell.prompt_tokens(cfg, {"batch": 3, "prompt_tokens": 40}, 2**31 + 21, "cpu")
    now = phi_moe.forward(weights, tokens)
    monkeypatch.setattr(phi_moe, "experts", lambda h, w, e1, n, k: _two_way_experts(h, w, e1, n))
    before = phi_moe.forward(weights, tokens)
    assert torch.equal(now["logits"], before["logits"]) and torch.equal(now["routes"], before["routes"])


def test_experts_take_the_trees_expert_and_the_next_top_k_minus_one_by_hand():
    # 5 experts of one unit each: expert e's output is e + 1 for a unit input
    e, d = 5, 1
    w = {"wi": torch.ones(e, d, 1), "wg": torch.full((e, d, 1), 50.0),
         "wo_e": torch.arange(1.0, e + 1.0).view(e, 1, d)}
    h = torch.ones(1, 2, d)
    y = phi_moe.experts(h, w, torch.tensor([[3, 0]]), e, 3)
    silu = torch.nn.functional.silu(torch.tensor(50.0))
    # token 0: experts 3, 4, 0 (outputs 4, 5, 1); token 1: experts 0, 1, 2
    assert torch.allclose(y.view(-1), silu * torch.tensor([10.0, 6.0]) / 3)


def test_the_parting_node_of_an_expert_with_two_leaves_by_hand():
    # depth 2 over 3 experts: leaves 0 and 3 both answer expert 0
    dist = torch.tensor([[0.5, 0.1, 0.9]])
    # the reference at leaf 1: leaf 0 parts from it at node 1 (0.1), leaf 3 at node 0 (0.5)
    assert phi_moe.parting_margin(dist, torch.tensor([1]), torch.tensor([0]), 2, 3).tolist() == [0.10000000149011612]
    # at leaf 2: leaf 0 parts at node 0 (0.5), leaf 3 at node 2 (0.9)
    assert phi_moe.parting_margin(dist, torch.tensor([2]), torch.tensor([0]), 2, 3).tolist() == [0.5]
    # one leaf an expert: the parting node of the two leaves alone
    dist = torch.tensor([[0.5, 0.1, 0.9]]).expand(4, 3)
    a, b = torch.tensor([0, 0, 1, 3]), torch.tensor([1, 2, 3, 2])
    want = dist.gather(-1, phi_moe.split_node(a, b, 2)[:, None])[:, 0]
    assert torch.equal(phi_moe.parting_margin(dist, a, b, 2, 4), want)


def test_the_tree_descent_and_the_parting_node_by_hand():
    thr = torch.zeros(3)
    z = torch.tensor([[1.0, 0.0, -1.0], [-1.0, 2.0, 0.5], [0.5, 0.0, 0.0]])
    # node 0 right → node 2, right iff z[2] > 0; left → node 1, right iff z[1] > 0
    assert phi_moe.descend(z, thr, 2).tolist() == [2, 1, 2]
    a, b = torch.tensor([0, 0, 1, 3]), torch.tensor([1, 2, 3, 2])
    assert phi_moe.split_node(a, b, 2).tolist() == [1, 0, 0, 2]


def test_weights_are_the_seeds_alone():
    cfg = small(kept_cell(CELL)).config
    one, two = phi_moe.Weights(cfg, 11, "cpu").layer(1), phi_moe.Weights(cfg, 11, "cpu").layer(1)
    assert all(torch.equal(one[k], two[k]) for k in one)
    other = phi_moe.Weights(cfg, 12, "cpu").layer(1)
    assert not torch.equal(one["wq"], other["wq"])
    assert one["wi"].shape == (cfg["moe"]["n_experts"], cfg["d_model"], cfg["moe"]["d_ff"])


def test_a_model_cell_on_one_card_runs_in_process():
    # a configuration whose mesh is 1x1: no ranks, the model whole
    cell = small(kept_cell(CELL))
    cell.config["mesh"] = {"data": 1, "model": 1}
    cell.traffic["prefill_rows"] = 4                     # one 512-token MoE group a call
    result, info = harness.run_cell(ROOT, cell, seed=2**31 + 3, seconds=0.4, trace=False, device="cpu",
                                    t_start=time.perf_counter())
    assert result["correct"], result["check"]
    assert result["check"]["logit_err"]["value"] < 1e-4 and info["sequences"] >= 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_cell")
    ctx = mp.get_context("spawn")
    init = f"file://{tmp}/store"
    procs = [ctx.Process(target=model_worker.run, args=(r, 4, init, str(tmp), SCENARIOS)) for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return json.loads((tmp / "results.json").read_text())


@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    """``granite-decode`` at test size in this process (no ranks), each
    scenario one ``run_cell``: sound, traced, the control, planted faults."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path_factory.mktemp("one_card") / "tune.json"))
        for name in ["sound", "traced", "control", *ONE_CARD_FAULTS]:
            cell = small(harness.load_cell(ROOT, GRANITE))
            with model_worker.planted(name):
                result, info = harness.run_cell(ROOT, cell, seed=2**31 + 13, seconds=1.0, trace=name == "traced",
                                                device="cpu", t_start=time.perf_counter(),
                                                control=name == "control")
            out[name] = {"result": result, "info": info}
    return out


@pytest.mark.parametrize("name", [CELL, GRANITE])
def test_sound_model_cell_is_correct_on_four_ranks_and_on_one_card(name, request):
    run = request.getfixturevalue("runs" if name == CELL else "one_card")["sound"]
    result, info = run["result"], run["info"]
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["count"] == (4 if name == CELL else 1)
    assert set(result["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    assert result["check"]["logit_err"]["value"] < 1e-4 and result["check"]["tokens_checked"]["value"] > 0
    assert list(result)[-1] == "check"
    assert info["batch_shards"] == (2 if name == CELL else 1) and info["rows_checked"] == 4


def test_traced_run_on_one_card_reports_the_trace(one_card):
    result = one_card["traced"]["result"]
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"] == {}          # no device time on the CPU


def test_control_on_one_card_is_not_correct(one_card):
    result, info = one_card["control"]["result"], one_card["control"]["info"]
    assert not result["correct"]
    assert info["program_check"]["logit_err"]["value"] < result["check"]["logit_err"]["value"]


@pytest.mark.parametrize("fault", ONE_CARD_FAULTS)
def test_planted_fault_on_one_card_is_not_correct(one_card, fault):
    result = one_card[fault]["result"]
    check = result["check"]
    assert not result["correct"] and result["failed"] > 0, check
    if fault == "short_answer":
        assert check["answers_missing"]["value"] > 0
    elif fault == "route_swapped":
        assert check["wrong_routes"]["value"] > 0
    else:
        assert check["logit_err"]["value"] > check["logit_err"]["limit"]


def test_sound_run_on_four_ranks_is_correct(runs):
    result, info = runs["sound"]["result"], runs["sound"]["info"]
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"decode_tokens_per_s", "setup_s"}
    assert result["check"]["tokens_checked"]["value"] > 0
    assert result["check"]["logit_err"]["value"] < 1e-4        # float32 at test size
    assert list(result)[-1] == "check"
    assert info["agree_us_per_step"] > 0 and info["sequences"] >= 2


def test_traced_run_on_four_ranks_reports_the_trace(runs):
    result = runs["traced"]["result"]
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"] == {}          # no device time on the CPU


def test_control_on_four_ranks_is_not_correct(runs):
    result, info = runs["control"]["result"], runs["control"]["info"]
    assert not result["correct"]
    assert info["program_check"]["logit_err"]["value"] < result["check"]["logit_err"]["value"]


def test_sound_run_on_the_planners_smoke_layout_is_correct(runs):
    # below the planner's size thresholds the smoke model is served
    # data-parallel over all four ranks, unsplit: each rank its own batch shard
    result, info = runs["planner_layout"]["result"], runs["planner_layout"]["info"]
    assert result["correct"], result["check"]
    assert info["rows_checked"] == 4 and result["check"]["logit_err"]["value"] < 1e-4
    assert info["batch_shards"] == 4 and runs["sound"]["info"]["batch_shards"] == 2


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_on_four_ranks_is_not_correct(runs, fault):
    result = runs[fault]["result"]
    check = result["check"]
    assert not result["correct"] and result["failed"] > 0, check
    if fault == "short_answer":
        assert check["answers_missing"]["value"] > 0
    elif fault == "route_swapped":
        assert check["wrong_routes"]["value"] > 0
    else:
        assert check["logit_err"]["value"] > check["logit_err"]["limit"]


def _sleeper(code: int, after: float, line: str = "") -> list:
    body = f"import sys, time\nprint({line!r}, flush=True)\ntime.sleep({after})\nsys.exit({code})\n"
    return [sys.executable, "-c", body]


def test_a_rank_that_fails_ends_the_run_with_no_result():
    t0 = time.monotonic()
    cmds = [_sleeper(0, 60, ranks.RESULT_PREFIX + "{}"), _sleeper(1, 0.5), _sleeper(0, 60), _sleeper(0, 60)]
    code, lines = ranks.launch(cmds, deadline_s=120)
    assert code == 1 and lines == []
    assert time.monotonic() - t0 < 30


def test_ranks_past_the_deadline_are_ended():
    t0 = time.monotonic()
    code, lines = ranks.launch([_sleeper(0, 60) for _ in range(4)], deadline_s=1.0)
    assert code == 124 and lines == []
    assert time.monotonic() - t0 < 30


def test_the_model_cell_without_cards_prints_no_result(tmp_path):
    root = checkout_with_kept(tmp_path / "checkout")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 2 and proc.stdout.strip() == "", proc.stderr
    assert "needs 4 CUDA device(s), found 0" in proc.stderr
    # a rank started by hand finds no card of its own either
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0",
         "--rank", "1", "--world", "4", "--init", "tcp://127.0.0.1:1", "--t-start", "0"],
        cwd=root, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 2 and proc.stdout.strip() == "", proc.stderr


def test_decode_step_bound_by_hand():
    # phi3.5-moe, 128 tokens at cache position 1,024, on four H100s
    cfg = kept_cell(CELL).config
    c = decode_step_cost(cfg, 128, 1024)
    d, kv, hd, f, v, l = 4096, 8, 128, 6400, 32064, 32
    attn = d * (32 + 2 * kv) * hd + 32 * hd * d                # 41,943,040
    layer = (attn + 16 * 3 * d * f) * 2 + (d * 15 + 15 + 2 * d) * 4
    kv_token = l * 2 * kv * hd * 2                              # 131,072 bytes a position
    assert attn == 41_943_040 and kv_token == 131_072
    want = l * layer + d * v * 2 + d * 4 + 128 * d * 2 + 128 * 1024 * kv_token + 128 * kv_token
    assert c["bytes"] == want
    assert 1.0e11 < want < 1.06e11                              # ~83.5 GB of weights, ~17 GB of cache
    macs = 128 * (l * (attn + d * 15 + 2 * 3 * d * f + 2 * 32 * hd * 1025) + d * v)
    assert c["ops"] == 2 * macs
    s = decode_step_bound_s(cfg, 128, 1024, 4)
    assert s == pytest.approx(want / (4 * 3.35e12))             # bytes bind: ~7.5 ms
    assert 7.0e-3 < s < 8.0e-3


def test_router_bound_by_hand():
    # K1 at the router: a rank's 64 tokens a layer, 15 features each, a tree of
    # 31 nodes (four 4-byte tables), one int32 expert out, 4 compares a token
    ctx_bound = 32 * cost.call_bound_s(64, 15, 1, 31, 64 * 4)
    assert ctx_bound == pytest.approx(32 * (64 * 15 * 4 + 31 * 16 + 64 * 4) / 3.35e12)
    cell = kept_cell(CELL)
    ctx = model_cell.Context.__new__(model_cell.Context)
    ctx.cell, ctx.batch_shards, ctx.chips = cell, 2, 4
    step, k1 = ctx.call_bounds(1024, 128)
    assert k1 == pytest.approx(ctx_bound)
    assert step == decode_step_bound_s(cell.config, 128, 1024, 4)
    assert math.isclose(k1, 32 * 4592 / 3.35e12)


def test_granite_decode_step_bound_by_hand():
    # granite-moe-3b-a800m, 128 tokens at cache position 1,024, on one H100
    cfg = harness.load_cell(ROOT, GRANITE).config
    c = decode_step_cost(cfg, 128, 1024)
    d, kv, hd, f, v, l = 1536, 8, 64, 512, 49155, 32
    attn = d * (24 + 2 * kv) * hd + 24 * hd * d                 # 6,291,456
    layer = (attn + 40 * 3 * d * f) * 2 + (d * 63 + 63 + 2 * d) * 4
    kv_token = l * 2 * kv * hd * 2                              # 65,536 bytes a position
    want = l * layer + d * v * 2 + d * 4 + 128 * d * 2 + 128 * 1024 * kv_token + 128 * kv_token
    assert c["bytes"] == want
    assert 1.5e10 < want < 1.53e10                              # ~6.6 GB of weights read, ~8.6 GB of cache
    macs = 128 * (l * (attn + d * 63 + 8 * 3 * d * f + 2 * 24 * hd * 1025) + d * v)
    assert c["ops"] == 2 * macs
    s = decode_step_bound_s(cfg, 128, 1024, 1)
    assert s == pytest.approx(want / 3.35e12) and 4.5e-3 < s < 4.6e-3   # bytes bind


def test_granite_router_bound_by_hand():
    # K1 at each of 32 routers: 128 tokens of 63 features, a tree of 127
    # nodes, one int32 expert out, 6 compares a token
    cell = harness.load_cell(ROOT, GRANITE)
    ctx = model_cell.Context.__new__(model_cell.Context)
    ctx.cell, ctx.batch_shards, ctx.chips = cell, 1, 1
    step, k1 = ctx.call_bounds(1024, 128)
    assert k1 == pytest.approx(32 * (128 * 63 * 4 + 127 * 16 + 128 * 4) / 3.35e12)
    assert step == decode_step_bound_s(cell.config, 128, 1024, 1)


def test_launches_a_step_read_by_hand():
    read = harness.metric_reader(ROOT, "launches_per_step.granite").read
    t = trace_reader.TraceData(window_s=2.0, busy_s=0.2, kernel_s=0.001, bound_s=0.07, records=1664, frames=0.0,
                               launches=117_000, steps=13)
    assert read(t) == 9000
    assert read(trace_reader.TraceData(1.0, 0.0, 0.0, 0.0, 0, 0.0)) is None
    assert [trace_reader.is_kernel(n) for n in ("Memcpy DtoH (Device -> Pinned)", "Memset (Device)",
                                                "void at::native::elementwise_kernel<128, 2>")] == [False, False, True]
    # both model cells read K1's share by one rule
    t = trace_reader.TraceData(2.0, 0.2, 0.004, 0.07, 1664, 0.0, kernel_bound_s=2e-6)
    for name in ("router_roofline_pct.phi", "router_roofline_pct.granite"):
        assert harness.metric_reader(ROOT, name).read(t) == pytest.approx(0.05)


def test_idle_gaps_go_unnamed_where_the_host_is_not_traced():
    # granite's traffic traces the device and the runtime's calls: idle outside them goes unnamed
    gaps = trace_reader.idle_gaps([(10.0, 20.0)], [], 0.0, 30.0, trace_reader.HOST_UNTRACED)
    assert gaps == [[trace_reader.HOST_UNTRACED, pytest.approx(2e-5)]]
    assert harness.load_cell(ROOT, GRANITE).traffic["trace_host"] is False
    assert trace_reader.Profiler(torch.device("cpu"), host=False).host     # on the CPU the host is the device
