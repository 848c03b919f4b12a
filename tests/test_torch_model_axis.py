"""The step split over the ``model`` axis, as the JAX mesh program lays out
its activations, across four spawned gloo processes on the CPU.

Four single-threaded ranks (``tests/torch_dist_worker.py model_axis``) run
smoke yi-6b (dense GQA), smoke granite-moe (the tree router: K1's plain
version on the host) and smoke phi3.5-moe on a 1×4 and a 2×2 mesh with
``tp`` on: the residual sequence-split, the logits and the loss
vocab-sharded, the MoE expert-parallel, the decode cache split by KV heads
(2×2: two KV heads over ``model`` 2) or by sequence (1×4).  This process
holds them against:

  * JAX's single-device program (``value_and_grad`` of the JAX model's loss,
    ``prefill``, ``decode_step``), on the same weights (carried across by
    ``load_jax_params``) and inputs, and the port's own single-device
    program: the loss within ``STEP_TOL`` relative, each gradient within
    ``STEP_TOL`` of its leaf's max-abs, the prefill and decode logits (each
    rank's rows, every column) within ``JAX_TOL``;
  * capacity drops in 512-token groups that span two sequence shards:
    every rank's slots equal JAX's formula (``moe.py:205-216``) on the
    whole batch, drops occur, and the train step on such groups matches
    JAX's;
  * each rank's cache shape: its block of JAX's ``cache_specs``, in the
    heads layout and the sequence layout;
  * ``utils.op_cost``'s FLOPs a card on a fake 1×4 mesh against a fake
    1×1: at most a quarter, plus the remainder that stays whole (the
    sequence layout's decode projections).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.models import build_model
from repro_torch.models.convert import load_jax_params
from repro_torch.parallel import sharding as shd
from repro_torch.train.step import loss_and_grads

WORLD = 4
JOIN_TIMEOUT_S = 150
STEP_TOL = 1e-5
JAX_TOL = 1e-5
CASES = [(arch, mesh) for arch in W.AXIS_ARCHS for mesh in W.AXIS_MESHES]
CASE_IDS = [f"{arch.split('-')[0]}-{d}x{m}" for arch, (d, m) in CASES]


def _jax_axes(mesh):
    from repro.parallel import sharding as jshd

    return jshd.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]})


def _jax_model(arch: str, mesh, capacity=None):
    from repro.configs import registry as jreg
    from repro.models.api import build_model as jax_build_model

    cfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32")
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    return jax_build_model(cfg, _jax_axes(mesh))


def _port_names(tree) -> dict:
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys, arr = [k.key for k in path], np.asarray(leaf)
        if keys[0] == "layers":
            out.update({".".join(["layers", str(i), *keys[1:]]): a for i, a in enumerate(arr)})
        else:
            out[".".join(keys)] = arr
    return out


def _references(arch, mesh, params, capacity=None, batch=W.AXIS_BATCH, seq=W.AXIS_SEQ, serve=True) -> dict:
    """JAX's and the port's single-device step, prefill and decode on the
    case's weights and inputs."""
    import jax

    jm = _jax_model(arch, mesh, capacity)
    inputs = W.axis_inputs(arch, batch, seq)
    jb = {k: v.numpy() for k, v in inputs["train"].items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    out = {"jax": {"loss": float(jl), "nll": float(jaux["nll"]), "aux": float(jaux["aux"]), "grads": _port_names(jg)}}
    d, m = mesh
    port = build_model(W.axis_cfg(arch, capacity), device="cpu",
                       axes=shd.MeshAxes(("data",), "model", {"data": d, "model": m}))
    load_jax_params(port, params)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, aux, grads = loss_and_grads(port, inputs["train"])
        out["port"] = {"loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
                       "grads": {n: g.numpy() for n, g in grads.items()}}
    finally:
        torch.set_num_threads(threads)
    if serve:
        jlog, cache = jax.jit(jm.prefill, static_argnames="max_len")(params, {"tokens": inputs["prompt"]},
                                                                     max_len=seq + W.DECODE_ROOM)
        out["prefill"], out["decode"] = np.asarray(jlog), []
        step = jax.jit(jm.decode_step)
        for t in range(W.AXIS_DECODE):
            jlog, cache = step(params, cache, {"tokens": inputs["decode"][t]})
            out["decode"].append(np.asarray(jlog))
        spec = jm.cache_specs(batch).kv.k
        shape = jax.eval_shape(lambda: jm.init_cache(batch, seq + W.DECODE_ROOM)).kv.k.shape
        sizes = {"data": d, "model": m}
        local = list(shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                local[i] //= sizes[a]
        out["cache_shape"], out["cache_spec"] = tuple(local), tuple(spec)
    return out


@pytest.fixture(scope="module")
def axis_run(tmp_path_factory):
    import jax

    tmp = str(tmp_path_factory.mktemp("axis"))
    weights = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch, mesh in CASES:
            jm = _jax_model(arch, mesh)
            params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
            port = build_model(W.axis_cfg(arch), device="cpu",
                               axes=shd.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]}))
            load_jax_params(port, params)
            torch.save(port.state_dict(), W.axis_weights_path(str(tmp), arch, mesh))
            weights[(arch, mesh)] = params
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=W.model_axis, args=(r, WORLD, tmp)) for r in range(WORLD)]
        for p in procs:
            p.start()
        refs = {}
        try:
            for arch, mesh in CASES:
                refs[(arch, mesh)] = _references(arch, mesh, weights[(arch, mesh)])
            refs["noseq"] = refs[(W.NOSEQ_ARCH, W.NOSEQ_MESH)]
            refs["drop_step"] = _references(W.DROP_ARCH, W.DROP_MESH, weights[(W.DROP_ARCH, W.DROP_MESH)],
                                            capacity=W.DROP_CAPACITY, batch=W.DROP_BATCH, seq=W.DROP_SEQ,
                                            serve=False)
        finally:
            for p in procs:
                p.join(JOIN_TIMEOUT_S)
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(5)
        codes = [p.exitcode for p in procs]
        assert not alive and codes == [0] * WORLD, f"ranks exited {codes} ({len(alive)} killed at the timeout)"
    ranks = [torch.load(os.path.join(tmp, f"axis_rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs}


def _assert_step(got: dict, want: dict, grads: bool) -> None:
    for k in ("loss", "nll", "aux"):
        assert abs(got[k] - want[k]) <= STEP_TOL * max(abs(want[k]), 1e-30), (k, got[k], want[k])
    if not grads:
        return
    assert set(got["grads"]) == set(want["grads"])
    for n, w in want["grads"].items():
        g, w = np.asarray(got["grads"][n], np.float32), np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= STEP_TOL * max(scale, 1e-30), f"{n}: {err} vs max-abs {scale}"


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_split_train_step_equals_jax_and_the_port_on_one_device(axis_run, case):
    ref = axis_run["refs"][case]
    for r, rank in enumerate(axis_run["ranks"]):
        got = rank[case]
        assert got["seq_split"] is True          # free_model_seq names 'model': S 128 divides
        for want in (ref["jax"], ref["port"]):
            _assert_step(got, want, grads=r == 0)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_split_prefill_and_decode_within_1e5_of_jax_single_device(axis_run, case):
    ref = axis_run["refs"][case]
    for got in (rank[case] for rank in axis_run["ranks"]):
        rows = W.AXIS_BATCH // got["shards"]
        sl = slice(got["shard"] * rows, (got["shard"] + 1) * rows)
        err = float(np.max(np.abs(got["prefill"].numpy() - ref["prefill"][sl])))
        assert got["prefill"].shape == ref["prefill"][sl].shape and err <= JAX_TOL, ("prefill", err)
        assert len(got["decode"]) == W.AXIS_DECODE
        for t, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
            err = float(np.max(np.abs(a.numpy() - b[sl])))
            assert err <= JAX_TOL, (f"decode {t}", err)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_each_ranks_cache_is_its_block_of_jax_cache_specs(axis_run, case):
    ref = axis_run["refs"][case]
    heads = ref["cache_spec"][3] == "model"
    assert heads == (case[1][1] == 2)         # the smoke models' 2 KV heads split over model 2, not 4
    for got in (rank[case] for rank in axis_run["ranks"]):
        assert got["cache_shape"] == ref["cache_shape"]
        assert got["cache_layout"] == ("heads" if heads else "seq")


def test_split_without_the_sequence_split_equals_jax(axis_run):
    """``parallel.seq_shard`` off: each rank of 'model' holds every position
    and computes its experts and vocabulary columns; the train step,
    prefill and decode equal JAX's as with the split."""
    ref = axis_run["refs"]["noseq"]
    for r, rank in enumerate(axis_run["ranks"]):
        got = rank["noseq"]
        assert got["seq_split"] is False
        _assert_step(got, ref["jax"], grads=r == 0)
        rows = W.AXIS_BATCH // got["shards"]
        sl = slice(got["shard"] * rows, (got["shard"] + 1) * rows)
        for a, b in zip([got["prefill"], *got["decode"]], [ref["prefill"], *ref["decode"]]):
            assert float(np.max(np.abs(a.numpy() - b[sl]))) <= JAX_TOL


def test_each_collective_over_model_has_its_transpose_as_backward(axis_run):
    """<f(x), y> = <x, f^T(y)> summed over the ranks, in f64, for every
    autograd collective of ``parallel.sharding`` (a tensor the ranks of a
    'model' row hold or consume alike counted once)."""
    names = axis_run["ranks"][0]["adjoints"]
    assert set(names) == {"seq_gather", "seq_scatter", "model_sum", "enter_split", "gather_alike",
                          "model_all_to_all"}
    for name in names:
        fwd = sum(rank["adjoints"][name][0] for rank in axis_run["ranks"])
        bwd = sum(rank["adjoints"][name][1] for rank in axis_run["ranks"])
        assert abs(fwd - bwd) <= 1e-12 * max(abs(fwd), 1.0), (name, fwd, bwd)


def _jax_slots(top: np.ndarray, e_pad: int, g: int) -> np.ndarray:
    """JAX's capacity positions (``moe.py:205-216``) on the whole (B, S, k)
    expert ids, in numpy: class by class over each group of ``g`` flat
    tokens, each class in token order, after the earlier classes' fill."""
    b, s, k = top.shape
    flat = top.reshape(-1, g, k)
    fill = np.zeros((flat.shape[0], e_pad), np.int64)
    out = np.zeros_like(flat)
    for j in range(k):
        onehot = np.eye(e_pad, dtype=np.int64)[flat[..., j]]
        pos = np.cumsum(onehot, axis=1) - 1 + fill[:, None, :]
        fill += onehot.sum(axis=1)
        out[..., j] = np.take_along_axis(pos, flat[..., j, None], axis=-1)[..., 0]
    return out.reshape(b, s, k)


def test_capacity_drops_across_sequence_shards_equal_jax(axis_run):
    from repro_torch.models.layers import moe as lm_moe

    cfg = W.axis_cfg(W.DROP_ARCH, W.DROP_CAPACITY)
    e_pad = lm_moe.padded_experts(cfg.moe, W.DROP_MESH[1])
    want = _jax_slots(W.drop_experts(cfg, e_pad), e_pad, 512)
    drops = 0
    for rank in axis_run["ranks"]:
        got = rank["drop_slots"]
        (r0, rows), (s0, s) = got["rows"], got["seq"]
        assert s == W.DROP_SEQ // W.DROP_MESH[1] < 512          # each group spans two sequence shards
        np.testing.assert_array_equal(got["slots"].numpy().reshape(rows, s, -1), want[r0:r0 + rows, s0:s0 + s])
        drops += int((got["slots"] >= got["cap"]).sum())
    assert drops > 0
    ref = axis_run["refs"]["drop_step"]
    for r, rank in enumerate(axis_run["ranks"]):
        for want_step in (ref["jax"], ref["port"]):
            _assert_step(rank["drop_step"], want_step, grads=r == 0)


def _flops(arch: str, shape: ShapeConfig, mesh: str, monkeypatch) -> float:
    monkeypatch.setattr(specs, "TP_MIN_PARAMS", 0)       # the smoke model placed as a full one: TP on
    return dryrun.run_cell(arch, shape, mesh=mesh, cfg=get_smoke_config(arch), verbose=False)["flops_per_card"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_op_cost_flops_a_rank_at_1x4_at_most_a_quarter_plus_the_unsplit_part(kind, monkeypatch):
    """Smoke yi-6b: on 1×4 its two KV heads do not split over 4, so decode
    keeps the sequence layout, whose q/k/v/o projections stay whole on
    every rank (2·B·D·(H + 2·KV)·hd + 2·B·H·hd·D a layer); everything else
    splits four ways."""
    cfg = get_smoke_config("yi")
    seq = 64 if kind == "decode" else 32
    shape = ShapeConfig(kind, seq, 4, kind)
    one = _flops("yi-6b", shape, "1x1", monkeypatch)
    four = _flops("yi-6b", shape, "1x4", monkeypatch)
    hd, d = cfg.head_dim_, cfg.d_model
    whole = 0.0
    if kind == "decode":
        whole = cfg.n_layers * (2 * 4 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + 2 * 4 * cfg.n_heads * hd * d)
    print(f"smoke yi-6b {kind}: {one:.6e} FLOPs on one card, {four:.6e} a card on 1x4 "
          f"({four / one:.4f} of one; the unsplit part {whole:.6e})")
    assert four <= one / 4 + whole


def test_launch_train_splits_over_model_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train --mesh 1x2`` under ``torchrun``
    (two gloo processes): the step splits over 'model' (sequence-parallel)
    and trains."""
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--arch", "granite-moe", "--smoke", "--device", "cpu", "--mesh", "1x2",
           "--steps", "2", "--seq", "128", "--batch", "4", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 2} (2 processes, cpu) split=seq" in out.stdout
    assert out.stdout.count("2 steps in") == 1 and "restarts=0" in out.stdout
