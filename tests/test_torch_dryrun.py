"""The dry-run (``repro_torch.launch.dryrun``) and the sharded prefill and
decode it plans.

* ``run_cell`` on every architecture's smoke config at small shapes, on a
  fake 2×2 and a fake 16×16 mesh: a row with every key, and no process
  group left behind, also after a cell that fails.
* The plan against JAX: smoke yi-6b's train, prefill and decode cells on a
  2×2 mesh against JAX's ``plan_cell`` + ``hlo_cost.analyze``, in a
  subprocess with four forced host devices (the JAX package unchanged).
  Both packages run the smoke config data-parallel (under
  ``TP_MIN_PARAMS``); the port's FLOPs a card must be within 10%
  (``FLOPS_REL``) of what JAX compiles for one data-parallel card (see
  ``JAX_SCRIPT``'s note on JAX's own 2×2 program), and the numbers are
  printed.
* Sharded prefill and decode on a real 4×1 gloo mesh (four spawned ranks,
  ``tests/torch_dist_worker.py``; a ``model`` axis of 1, so that nothing is
  split over it: ``tests/test_torch_model_axis.py`` holds the split): in
  f32, each rank's rows bit-equal to the single-device prefill and decode
  microbatched by the batch shards, and
  within ``JAX_TOL`` (1e-5) of JAX's single-device ``prefill`` /
  ``decode_step`` on the same rows and weights (carried across by
  ``models.convert.load_jax_params``).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_params
from repro_torch.parallel import sharding as shd

FLOPS_REL = 0.10
JAX_TOL = 1e-5
WORLD = 4
JOIN_TIMEOUT_S = 150
ROW_KEYS = {"arch", "shape", "step", "mesh", "chips", "flops_per_card", "bytes_per_card", "coll_bytes_per_chip",
            "compute_s", "memory_s", "collective_s", "dominant", "model_flops", "useful_ratio",
            "roofline_fraction", "coll_summary", "fit_bytes", "fits", "plan_s", "k1_ops", "ops", "collectives",
            "param_bytes_per_card", "seq_shard", "model_split", "commit", "src_tree"}
MOE = {"granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"}


def _cells(arch: str, mesh: str) -> list[ShapeConfig]:
    """Small cells: the MoE archs' batch shards hold whole 512-token groups
    (4 shards of B 8 on 2×2, 16 of B 16 on 16×16)."""
    if mesh == "2x2":
        s = 256 if arch in MOE else 32
        return [ShapeConfig("train_s", s, 8, "train"), ShapeConfig("prefill_s", s, 8, "prefill"),
                ShapeConfig("decode_s", 64, 8, "decode")]
    s = 512 if arch in MOE else 32
    return [ShapeConfig("prefill_s", s, 16, "prefill"), ShapeConfig("decode_s", 64, 16, "decode")]


@pytest.mark.parametrize("mesh", ["2x2", "16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_gives_a_row_with_every_key_on_a_fake_mesh(arch, mesh):
    for shape in _cells(arch, mesh):
        row = dryrun.run_cell(arch, shape, mesh=mesh, cfg=get_smoke_config(arch), verbose=False)
        assert ROW_KEYS <= set(row), ROW_KEYS - set(row)
        assert row["chips"] == (4 if mesh == "2x2" else 256)
        assert row["flops_per_card"] > 0 and row["bytes_per_card"] > 0 and row["fit_bytes"] > 0
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["k1_ops"] == (get_smoke_config(arch).n_layers if arch in MOE and shape.kind != "train" else 0)
        assert not dist.is_initialized()


def test_no_process_group_is_left_after_a_cell_that_fails():
    bad = ShapeConfig("train_bad", 100, 8, "train")     # granite's shards cannot hold whole groups
    with pytest.raises(ValueError, match="whole groups"):
        dryrun.run_cell("granite-moe-3b-a800m", bad, mesh="2x2", cfg=get_smoke_config("granite-moe"),
                        verbose=False)
    assert not dist.is_initialized()
    assert shd.active_shards() is None


def test_the_dry_run_refuses_a_real_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.run_cell("yi-6b", ShapeConfig("decode_s", 64, 8, "decode"), mesh="2x2",
                            cfg=get_smoke_config("yi"), verbose=False)
    finally:
        dist.destroy_process_group()


def test_the_cli_writes_rows_and_skips(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_smoke_config(arch))
    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k": ShapeConfig("decode_32k", 64, 16, "decode")})
    monkeypatch.setattr(dryrun, "cells_for", lambda cfg: [
        (ShapeConfig("decode_32k", 64, 16, "decode"), True, ""),
        (ShapeConfig("long_500k", 64, 1, "decode"), False, "full-attention arch")])
    out = tmp_path / "rows.json"
    dryrun.main(["--arch", "yi-6b", "--mesh", "both", "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r.get("mesh") for r in rows] == ["16x16", "2x16x16", None]
    assert rows[2]["skip"] == "full-attention arch"
    printed = capsys.readouterr().out
    assert "all 3 cells OK" in printed
    table = [ln for ln in printed.splitlines() if ln.lstrip().startswith("yi-6b") and " | " in ln]
    assert [ln.split(" | ")[3].strip() for ln in table] == ["16x16", "2x16x16"]
    assert not dist.is_initialized()


RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "results", "dryrun_torch.json")


def test_the_committed_plan_leaves_no_row_waiting_and_splits_hymba_by_sequence():
    """``results/dryrun_torch.json``: every planned row records how its step
    splits over 'model' ("seq", "weights" or "none"), none is left
    "waiting", and hymba-1.5b's train_4k, once the only cell past 80 GB
    (its unsplit plan: 1.03e15 FLOPs, 297.3 GiB a card on 16×16), is
    sequence-split with fewer FLOPs a card."""
    rows = json.load(open(RESULTS))
    planned = [r for r in rows if "skip" not in r]
    assert planned and all("error" not in r for r in planned)
    assert {r["model_split"] for r in planned} <= {"seq", "weights", "none"}
    assert not [r for r in rows if r.get("model_split") == "waiting"]
    hymba = [r for r in planned if r["arch"] == "hymba-1.5b" and r["shape"] == "train_4k"]
    assert {r["mesh"] for r in hymba} == {"16x16", "2x16x16"}
    for r in hymba:
        assert r["model_split"] == "seq" and r["flops_per_card"] < 1.03e15, r["mesh"]


def test_the_cli_refuses_no_seq_shard(tmp_path, monkeypatch):
    """JAX's ``--no-seq-shard`` is accepted and turns the sequence split off:
    the residual stays whole on each rank of 'model', so a TP card computes
    more than with the split (the flag is no longer refused)."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_smoke_config(arch))
    monkeypatch.setattr(specs, "TP_MIN_PARAMS", 0)
    monkeypatch.setattr(dryrun, "SHAPES", {"train_s": ShapeConfig("train_s", 32, 8, "train")})
    monkeypatch.setattr(dryrun, "cells_for", lambda cfg: [(ShapeConfig("train_s", 32, 8, "train"), True, "")])
    monkeypatch.setitem(dryrun.MESHES, "16x16", dryrun.MESHES["2x2"])
    rows = {}
    for flag in ([], ["--no-seq-shard"]):
        out = tmp_path / f"rows{len(flag)}.json"
        dryrun.main(["--arch", "yi-6b", "--out", str(out), *flag])
        (rows[bool(flag)],) = json.loads(out.read_text())
    assert rows[True]["flops_per_card"] > rows[False]["flops_per_card"]
    assert "all-to-all" not in rows[True]["collectives"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the plan against JAX's hlo_cost
# ---------------------------------------------------------------------------

JAX_CELLS = [("train", 8, 64), ("prefill", 8, 64), ("decode", 8, 64)]
# What one card of the data-parallel 2×2 computes in JAX: its batch shard (B
# 8 / 4 cards) lowered on one device, equal to the whole batch's count / 4.
# JAX's program compiled for the 2×2 mesh itself is printed beside it but
# is not the reference: XLA's SPMD partitioner replicates the smoke model's
# batch-sharded compute on that mesh ("involuntary full rematerialization"
# at the embedding gather; 2.2× one card's FLOPs in train, 4× in prefill),
# and its decode cell does not lower under jax 0.9.0 (a ShardingTypeError
# at the cache's dynamic_update_slice, the API error of ROADMAP §3 item 6).
JAX_SCRIPT = textwrap.dedent("""
    import json
    import jax
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_smoke_config
    from repro.launch.mesh import make_test_mesh
    from repro.launch.specs import dryrun_config, plan_cell
    from repro.parallel import sharding as shd
    from repro.utils.hlo_cost import analyze

    cfg = dryrun_config(get_smoke_config("yi"))

    def one_card(kind, b, s):
        plan = plan_cell(cfg, ShapeConfig(kind, s, b // 4, kind), shd.single_device_axes())
        return analyze(jax.jit(plan.fn, donate_argnums=plan.donate or ()).lower(*plan.args).compile().as_text()).flops

    def on_mesh(kind, b, s):
        mesh = make_test_mesh(2, 2)
        plan = plan_cell(cfg, ShapeConfig(kind, s, b, kind), shd.from_mesh(mesh))
        try:
            with mesh:
                shardings = jax.tree.map(lambda sp: jax.sharding.NamedSharding(mesh, sp), plan.in_specs,
                                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
                compiled = jax.jit(plan.fn, in_shardings=shardings,
                                   donate_argnums=plan.donate or ()).lower(*plan.args).compile()
        except Exception as e:
            return type(e).__name__
        return analyze(compiled.as_text()).flops

    print("JAX_FLOPS " + json.dumps({kind: {"card": one_card(kind, b, s), "mesh": on_mesh(kind, b, s)}
                                     for kind, b, s in %r}))
""" % (JAX_CELLS,))


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 " + os.environ.get("XLA_FLAGS", ""),
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith("JAX_FLOPS ")]
    return json.loads(line.removeprefix("JAX_FLOPS "))


@pytest.mark.parametrize("kind,batch,seq", JAX_CELLS)
def test_plan_flops_a_card_within_10_percent_of_jax_hlo_cost(jax_flops, kind, batch, seq):
    row = dryrun.run_cell("yi-6b", ShapeConfig(kind, seq, batch, kind), mesh="2x2", cfg=get_smoke_config("yi"),
                          verbose=False)
    port, card, mesh = row["flops_per_card"], jax_flops[kind]["card"], jax_flops[kind]["mesh"]
    print(f"smoke yi-6b {kind}, B {batch} x S {seq} on 2x2: port {port:.6e} FLOPs a card; JAX hlo_cost "
          f"{card:.6e} a data-parallel card ({port / card - 1:+.2%}; bound ±{FLOPS_REL:.0%}); "
          f"JAX's 2x2 program {mesh if isinstance(mesh, str) else f'{mesh:.6e}'}")
    assert abs(port - card) <= FLOPS_REL * card


# ---------------------------------------------------------------------------
# sharded prefill and decode on a 4×1 gloo mesh
# ---------------------------------------------------------------------------


def _jax_model(arch: str):
    from repro.configs import registry as jreg
    from repro.models.api import build_model as jax_build_model
    from repro.parallel import sharding as jshd

    d, m = W.SERVE_MESH
    axes = jshd.MeshAxes(("data",), "model", {"data": d, "model": m})
    cfg = jreg.get_smoke_config(arch).__class__(**{**jreg.get_smoke_config(arch).__dict__, "dtype": "float32"})
    return jax_build_model(cfg, axes)


def _port_reference(arch: str, jax_params) -> torch.nn.Module:
    d, m = W.SERVE_MESH
    axes = shd.MeshAxes(("data",), "model", {"data": d, "model": m})
    model = build_model(W.smoke_cfg(arch), device="cpu", axes=axes)
    load_jax_params(model, jax_params)
    return model


def _serve_rows(prefill, decode, arch, batch, prompt, steps, shards):
    """Prefill and decode of each batch shard's rows on their own (the
    single-device run microbatched by the shards): {shard: (prefill, [decode])}."""
    ids, dec = W.serve_tokens(arch, batch, prompt, steps)
    rows = batch // shards
    out = {}
    for s in range(shards):
        sl = slice(s * rows, (s + 1) * rows)
        logits, cache = prefill(ids[sl], prompt + steps)
        steps_out = []
        for t in range(steps):
            step_logits, cache = decode(cache, dec[t][sl])
            steps_out.append(step_logits)
        out[s] = (logits, steps_out)
    return out


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    import jax

    tmp = str(tmp_path_factory.mktemp("serve"))
    refs, jax_refs = {}, {}
    with jax.default_device(jax.devices("cpu")[0]):
        models = {}
        for arch, batch, prompt, steps in W.SERVE_CASES:
            jm = _jax_model(arch)
            params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
            port = _port_reference(arch, params)
            torch.save(port.state_dict(), W.serve_weights_path(tmp, arch))
            models[arch] = (jm, params, port)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=W.serve, args=(r, WORLD, tmp)) for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            for case in W.SERVE_CASES:
                arch, batch, prompt, steps = case
                jm, params, port = models[arch]
                # single-threaded, as the ranks run: another thread count
                # rounds the matmuls otherwise
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    with torch.no_grad():
                        refs[case] = _serve_rows(
                            lambda ids, n: port.prefill({"tokens": torch.from_numpy(ids)}, max_len=n),
                            lambda cache, tok: port.decode_step(cache, {"tokens": torch.from_numpy(tok)}),
                            *case, shards=W.SERVE_MESH[0])
                finally:
                    torch.set_num_threads(threads)
                jprefill = jax.jit(jm.prefill, static_argnames="max_len")
                jdecode = jax.jit(jm.decode_step)
                jax_refs[case] = _serve_rows(
                    lambda ids, n: jprefill(params, {"tokens": ids}, max_len=n),
                    lambda cache, tok: jdecode(params, cache, {"tokens": tok}),
                    *case, shards=W.SERVE_MESH[0])
        finally:
            for p in procs:
                p.join(JOIN_TIMEOUT_S)
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(5)
        codes = [p.exitcode for p in procs]
        assert not alive and codes == [0] * WORLD, f"ranks exited {codes} ({len(alive)} killed at the timeout)"
    ranks = [torch.load(os.path.join(tmp, f"serve_rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs, "jax": jax_refs}


SERVE_IDS = [c[0] for c in W.SERVE_CASES]


@pytest.mark.parametrize("case", W.SERVE_CASES, ids=SERVE_IDS)
def test_sharded_prefill_and_decode_equal_one_device_microbatched_by_the_shards(serve_run, case):
    for got in (r[case] for r in serve_run["ranks"]):
        assert got["shards"] == W.SERVE_MESH[0]
        assert got["batch_shards_after"] is None
        assert got["cache_rows"] == case[1] // W.SERVE_MESH[0]    # this rank's rows, every head ('model' 1)
        want_prefill, want_decode = serve_run["refs"][case][got["shard"]]
        assert torch.equal(got["prefill"], want_prefill)
        assert len(got["decode"]) == len(want_decode) == case[3]
        for a, b in zip(got["decode"], want_decode):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", W.SERVE_CASES, ids=SERVE_IDS)
def test_sharded_prefill_and_decode_within_1e5_of_jax_single_device(serve_run, case):
    for got in (r[case] for r in serve_run["ranks"]):
        want_prefill, want_decode = serve_run["jax"][case][got["shard"]]
        err = float(np.max(np.abs(got["prefill"].numpy() - np.asarray(want_prefill))))
        assert err <= JAX_TOL, ("prefill", err)
        for t, (a, b) in enumerate(zip(got["decode"], want_decode)):
            err = float(np.max(np.abs(a.numpy() - np.asarray(b))))
            assert err <= JAX_TOL, (f"decode {t}", err)
