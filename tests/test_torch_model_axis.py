"""The step split over the ``model`` axis, as the JAX mesh program lays out
its activations, across four spawned gloo processes on the CPU.

Four single-threaded ranks (``tests/torch_dist_worker.py model_axis``) run
smoke yi-6b (dense GQA), smoke granite-moe (the tree router: K1's plain
version on the host), smoke phi3.5-moe, smoke hymba (attention beside an
SSM), smoke xLSTM and smoke whisper (24 encoder frames) on a 1×4 and a 2×2
mesh with ``tp`` on: the residual sequence-split (the xLSTM's and
whisper's encoder's whole), the SSM on the rank's ``d_inner`` channels,
the mLSTM and whisper's encoder on the rank's heads, the logits and the
loss vocab-sharded, the MoE expert-parallel, the decode cache split by KV
heads (2×2: two KV heads over ``model`` 2; whisper's four on both) or by
sequence (1×4), the SSM and mLSTM states by channels and heads.  This
process holds them against:

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
  * each rank's cache shapes, every leaf: its block of JAX's
    ``cache_specs``, in the heads layout and the sequence layout;
  * the mLSTM's "dh" layout (smoke xLSTM with 2 heads on 1×4: each rank a
    quarter of every head's dh), the same way;
  * the mLSTM's gate weight ``w_if`` a rank's block of rows in both layouts,
    as JAX's ``mlstm_schema`` lays it out, and the split xLSTM's prefill and
    decode collectives by kind, every rank's, equal to the fake mesh's plan
    (``launch.dryrun``), which gathers no whole ``w_if``;
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
# The xLSTM's own bounds, from ``tests/torch_f64_probe.py axis xlstm``: at
# these sizes JAX's, the port's and the split port's f32 results all lie
# about as far from the f64 evaluation (gradients: split 3.21e-5 on 1×4
# and 1.87e-5 on 2×2, port 1.65e-5, JAX 1.35e-5, and in the "dh" case JAX
# 2.86e-5; logits: split 4.86e-5, JAX 4.81e-5), the mLSTM's exponential
# gates amplifying the rounding of its contractions (the split sums the
# gate logits and the output projection over 'model').  The gradients'
# bound was set at twice the larger distance when the split's was 2.28e-5
# (JAX's "dh" case then the larger); it is kept, not raised to twice the
# split's 3.21e-5, above the largest split–JAX difference measured
# (4.16e-5; split–port 1.81e-5).  The logits' bound stays above the
# largest split–JAX difference measured (7.15e-5), near twice the larger
# distance (9.71e-5).
XLSTM_STEP_TOL = 5.8e-5
XLSTM_JAX_TOL = 1e-4


def _tols(arch: str) -> tuple[float, float]:
    """(gradient and loss bound, logits bound) of an arch's split cases."""
    return (XLSTM_STEP_TOL, XLSTM_JAX_TOL) if arch == "xlstm" else (STEP_TOL, JAX_TOL)
CASES = [(arch, mesh) for arch in W.AXIS_ARCHS for mesh in W.AXIS_MESHES]
CASE_IDS = [f"{arch.split('-')[0]}-{d}x{m}" for arch, (d, m) in CASES]


def _jax_axes(mesh):
    from repro.parallel import sharding as jshd

    return jshd.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]})


def _jax_model(arch: str, mesh, capacity=None, heads=None):
    from repro.configs import registry as jreg
    from repro.models.api import build_model as jax_build_model

    cfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32")
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    return jax_build_model(cfg, _jax_axes(mesh))


def _port_names(tree, stacks) -> dict:
    """JAX leaves by the port's parameter names: a stacked (L, …) leaf of
    one of ``stacks`` one parameter a layer."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys, arr = [k.key for k in path], np.asarray(leaf)
        if keys[0] in stacks:
            out.update({".".join([keys[0], str(i), *keys[1:]]): a for i, a in enumerate(arr)})
        else:
            out[".".join(keys)] = arr
    return out


def _cache_blocks(jm, batch: int, max_len: int, sizes: dict) -> tuple[dict, tuple | None]:
    """({leaf path: a rank's block shape of JAX's cache_specs}, the attention
    cache's spec or None)."""
    import jax

    specs = jm.cache_specs(batch)
    out = {}
    for path, leaf in W.cache_leaves(jax.eval_shape(lambda: jm.init_cache(batch, max_len))).items():
        spec = specs
        for part in path.split("."):
            spec = spec[int(part)] if part.isdigit() else getattr(spec, part)
        local = list(leaf.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                local[i] //= sizes[a]
        out[path] = tuple(local)
    kv = getattr(specs, "kv", None) or getattr(specs, "self_kv", None)
    return out, (None if kv is None else tuple(kv.k))


def _references(arch, mesh, params, capacity=None, batch=W.AXIS_BATCH, seq=W.AXIS_SEQ, serve=True,
                heads=None) -> dict:
    """JAX's and the port's single-device step, prefill and decode on the
    case's weights and inputs."""
    import jax

    jm = _jax_model(arch, mesh, capacity, heads)
    inputs = W.axis_inputs(arch, batch, seq)
    jb = {k: v.numpy() for k, v in inputs["train"].items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    d, m = mesh
    port = build_model(W.axis_cfg(arch, capacity, heads), device="cpu",
                       axes=shd.MeshAxes(("data",), "model", {"data": d, "model": m}))
    out = {"jax": {"loss": float(jl), "nll": float(jaux["nll"]), "aux": float(jaux["aux"]),
                   "grads": _port_names(jg, port.stacks)}}
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
        jlog, cache = jax.jit(jm.prefill, static_argnames="max_len")(params, inputs["prompt"],
                                                                     max_len=seq + W.DECODE_ROOM)
        out["prefill"], out["decode"] = np.asarray(jlog), []
        step = jax.jit(jm.decode_step)
        for t in range(W.AXIS_DECODE):
            jlog, cache = step(params, cache, {"tokens": inputs["decode"][t]})
            out["decode"].append(np.asarray(jlog))
        out["cache_shapes"], out["cache_spec"] = _cache_blocks(jm, batch, seq + W.DECODE_ROOM, {"data": d, "model": m})
    return out


@pytest.fixture(scope="module")
def axis_run(tmp_path_factory):
    import jax

    tmp = str(tmp_path_factory.mktemp("axis"))
    weights = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch, mesh, heads, tag in [(a, m, None, "") for a, m in CASES] + [(W.DH_ARCH, W.DH_MESH, W.DH_HEADS, "dh")]:
            jm = _jax_model(arch, mesh, heads=heads)
            params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
            port = build_model(W.axis_cfg(arch, heads=heads), device="cpu",
                               axes=shd.MeshAxes(("data",), "model", {"data": mesh[0], "model": mesh[1]}))
            load_jax_params(port, params)
            torch.save(port.state_dict(), W.axis_weights_path(str(tmp), arch, mesh, tag))
            weights[(arch, mesh, tag)] = params
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=W.model_axis, args=(r, WORLD, tmp)) for r in range(WORLD)]
        for p in procs:
            p.start()
        refs = {}
        try:
            for arch, mesh in CASES:
                refs[(arch, mesh)] = _references(arch, mesh, weights[(arch, mesh, "")])
            refs["noseq"] = refs[(W.NOSEQ_ARCH, W.NOSEQ_MESH)]
            refs["drop_step"] = _references(W.DROP_ARCH, W.DROP_MESH, weights[(W.DROP_ARCH, W.DROP_MESH, "")],
                                            capacity=W.DROP_CAPACITY, batch=W.DROP_BATCH, seq=W.DROP_SEQ,
                                            serve=False)
            refs["dh"] = _references(W.DH_ARCH, W.DH_MESH, weights[(W.DH_ARCH, W.DH_MESH, "dh")], heads=W.DH_HEADS)
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


def _assert_step(got: dict, want: dict, grads: bool, tol: float = STEP_TOL) -> None:
    for k in ("loss", "nll", "aux"):
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-30), (k, got[k], want[k])
    if not grads:
        return
    assert set(got["grads"]) == set(want["grads"])
    for n, w in want["grads"].items():
        g, w = np.asarray(got["grads"][n], np.float32), np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * max(scale, 1e-30), f"{n}: {err} vs max-abs {scale}"


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_split_train_step_equals_jax_and_the_port_on_one_device(axis_run, case):
    ref = axis_run["refs"][case]
    for r, rank in enumerate(axis_run["ranks"]):
        got = rank[case]
        # free_model_seq names 'model' (S 128 divides); the xLSTM keeps its residual whole
        assert got["seq_split"] is (case[0] not in W.AXIS_WHOLE_TOKENS)
        for want in (ref["jax"], ref["port"]):
            _assert_step(got, want, grads=r == 0, tol=_tols(case[0])[0])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_split_prefill_and_decode_within_their_bounds_of_jax_single_device(axis_run, case):
    """Each rank's prefill and decode logits against JAX's single-device
    program's rows of its batch shard: within JAX_TOL (1e-5), the xLSTM
    within XLSTM_JAX_TOL (1e-4, set from the f64 measurement above)."""
    ref = axis_run["refs"][case]
    tol = _tols(case[0])[1]
    for got in (rank[case] for rank in axis_run["ranks"]):
        rows = W.AXIS_BATCH // got["shards"]
        sl = slice(got["shard"] * rows, (got["shard"] + 1) * rows)
        err = float(np.max(np.abs(got["prefill"].numpy() - ref["prefill"][sl])))
        assert got["prefill"].shape == ref["prefill"][sl].shape and err <= tol, ("prefill", err)
        assert len(got["decode"]) == W.AXIS_DECODE
        for t, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
            err = float(np.max(np.abs(a.numpy() - b[sl])))
            assert err <= tol, (f"decode {t}", err)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_each_ranks_cache_is_its_block_of_jax_cache_specs(axis_run, case):
    ref = axis_run["refs"][case]
    if ref["cache_spec"] is None:           # the xLSTM: its smoke model's 4 heads split over model 2 and 4
        layout = "heads"
    else:
        heads = ref["cache_spec"][3] == "model"
        # the smoke models' 2 KV heads split over model 2, not 4; whisper's 4 over both
        assert heads == (W.axis_cfg(case[0]).n_kv_heads % case[1][1] == 0)
        layout = "heads" if heads else "seq"
    for got in (rank[case] for rank in axis_run["ranks"]):
        assert got["cache_shapes"] == ref["cache_shapes"]
        assert got["cache_layout"] == layout


def test_mlstm_split_by_head_dim_equals_jax(axis_run):
    """Smoke xLSTM with 2 heads on 1×4: the heads do not divide 'model', so
    each rank holds a quarter of every head's dh (JAX's ``mlstm_state_spec``
    "dh" layout); the train step, prefill, decode and the state's blocks
    equal JAX's as in the heads layout."""
    ref = axis_run["refs"]["dh"]
    for r, rank in enumerate(axis_run["ranks"]):
        got = rank["dh"]
        assert got["seq_split"] is False and got["cache_layout"] == "dh"
        assert got["cache_shapes"] == ref["cache_shapes"]
        for want in (ref["jax"], ref["port"]):
            _assert_step(got, want, grads=r == 0, tol=XLSTM_STEP_TOL)
        rows = W.AXIS_BATCH // got["shards"]
        sl = slice(got["shard"] * rows, (got["shard"] + 1) * rows)
        for a, b in zip([got["prefill"], *got["decode"]], [ref["prefill"], *ref["decode"]]):
            assert float(np.max(np.abs(a.numpy() - b[sl]))) <= XLSTM_JAX_TOL


MLSTM_LAYOUTS = [("heads", 2, None, {"up", "b_if"}), ("heads", 4, None, {"up", "b_if"}),
                 ("dh", 4, W.DH_HEADS, {"up", "wq", "wk", "wv"})]


@pytest.mark.parametrize("layout,model,heads,partial", MLSTM_LAYOUTS, ids=["heads-2", "heads-4", "dh-4"])
def test_mlstm_takes_its_rows_of_the_gate_weight_as_jax_lays_it_out(layout, model, heads, partial):
    """JAX's ``mlstm_schema`` splits ``w_if``'s rows (the conv channels) over
    'model': in either layout a split step takes ``w_if`` as this rank's
    block, every leaf it so takes is one that JAX splits over 'model', and
    the whole leaves it slices are ``partial``."""
    from repro.configs import registry as jreg
    from repro.models.layers import xlstm as jxl
    from repro_torch.models.layers import xlstm as xl

    jcfg = jreg.get_smoke_config("xlstm")
    if heads is not None:
        jcfg = dataclasses.replace(jcfg, n_heads=heads, n_kv_heads=heads)
    jspec = {name: tuple(leaf.spec) for name, leaf in jxl.mlstm_schema(jcfg, _jax_axes((1, model))).items()}
    assert jspec["w_if"] == ("model", None)
    cfg = W.axis_cfg("xlstm", heads=heads)
    assert xl.mlstm_layout(cfg, model) == layout
    block = xl.MLSTM(cfg, "cpu")
    local = block.model_local_names(model)
    assert "w_if" in local and all("model" in jspec[name] for name in local), (local, jspec)
    assert block.model_partial_names(model) == partial


def _gather_recording_cost(seen: list):
    """``OpCost`` that also appends the shape of each all-gather's result to ``seen``."""
    from repro_torch.utils.op_cost import OpCost

    class Recording(OpCost):
        def _charge(self, func, args, kwargs, out, ins, outs):
            if func.namespace in ("_c10d_functional", "c10d_functional", "c10d") and "gather" in func._schema.name:
                seen.extend(tuple(t.shape) for t in outs)
            return super()._charge(func, args, kwargs, out, ins, outs)

    return Recording


PLAN_CASES = [("xlstm", mesh, None, mesh) for mesh in W.AXIS_MESHES] + [(W.DH_ARCH, W.DH_MESH, W.DH_HEADS, "dh")]


@pytest.mark.parametrize("arch,mesh,heads,key", PLAN_CASES,
                         ids=[f"xlstm-{d}x{m}" for d, m in W.AXIS_MESHES] + ["xlstm-dh"])
def test_split_xlstm_collectives_equal_the_fake_meshs_plan(axis_run, arch, mesh, heads, key, monkeypatch):
    """The smoke xLSTM's prefill and decode step planned on a fake mesh
    (``launch.dryrun``, ``TP_MIN_PARAMS`` 0 so that it splits over 'model'):
    no all-gather of a whole ``w_if`` (each rank contracts its rows, the
    logits summed over 'model'), and the collectives by kind those that
    every rank's real prefill and decode step made on the model the plan
    serves (``torch_dist_worker.served_collectives``)."""
    seen = []
    monkeypatch.setattr(specs, "TP_MIN_PARAMS", 0)
    monkeypatch.setattr(dryrun, "OpCost", _gather_recording_cost(seen))
    cfg = W.axis_cfg(arch, heads=heads)
    w_if = (int(cfg.xlstm.proj_factor * cfg.d_model), 2 * cfg.n_heads)
    for kind, seq in (("prefill", W.AXIS_SEQ), ("decode", W.AXIS_SEQ + W.DECODE_ROOM)):
        seen.clear()
        row = dryrun.run_cell("xlstm-125m", ShapeConfig(kind, seq, W.AXIS_BATCH, kind), mesh=f"{mesh[0]}x{mesh[1]}",
                              cfg=cfg, verbose=False)
        planned = {k: v["count"] for k, v in row["collectives"].items()}
        assert row["model_split"] == "weights" and planned.get("all-reduce", 0) > 0, (kind, row["model_split"], planned)
        assert seen and w_if not in seen, (kind, w_if, seen)
        for r, rank in enumerate(axis_run["ranks"]):
            got = rank["served_collectives"][key][kind]
            assert got == planned, (kind, r, got, planned)


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
                          "model_all_to_all", "channel_gather", "whole_tokens", "whole_tokens_seq",
                          "residual_sum", "residual_sum_seq", "shared_sum", "vocab_lookup"}
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


def _unsplit_flops(arch: str, kind: str, cfg, batch: int, seq: int) -> float:
    """The FLOPs a rank of a 1×4 split computes whole (the same on every rank):

      * yi-6b and hymba decode: their two KV heads do not split over 4, so the
        sequence layout's q/k/v/o projections stay whole, 2·B·D·(H + 2·KV)·hd
        + 2·B·H·hd·D a layer;
      * the xLSTM: its sLSTM layers (the input and recurrent gate products
        and the output, 18·D² a token);
      * whisper's train and prefill: the cross-attention's K/V projections of
        every encoder frame, 2·B·F·D·2·KV·hd a layer.

    A train step counts each product four times (forward, its
    rematerialization, two products in the backward)."""
    hd, d = cfg.head_dim_, cfg.d_model
    passes = 4 if kind == "train" else 1
    if arch in ("yi-6b", "hymba-1.5b"):
        if kind != "decode":
            return 0.0
        return cfg.n_layers * (2 * batch * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + 2 * batch * cfg.n_heads * hd * d)
    tokens = batch * (1 if kind == "decode" else seq)
    if arch == "xlstm-125m":
        n_slstm = sum(1 for i in range(cfg.n_layers) if i % cfg.xlstm.slstm_every == cfg.xlstm.slstm_every - 1)
        return passes * n_slstm * tokens * 18 * d * d
    if kind == "decode":
        return 0.0
    return passes * cfg.n_layers * 2 * batch * cfg.encoder.n_frames * d * 2 * cfg.n_kv_heads * hd


FLOPS_CASES = [(arch, kind) for arch in ("yi-6b", "hymba-1.5b", "xlstm-125m", "whisper-medium")
               for kind in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", FLOPS_CASES,
                         ids=[k if a == "yi-6b" else f"{a.split('-')[0]}-{k}" for a, k in FLOPS_CASES])
def test_op_cost_flops_a_rank_at_1x4_at_most_a_quarter_plus_the_unsplit_part(arch, kind, monkeypatch):
    """The smoke models on a fake 1×4 mesh against a fake 1×1: each rank
    computes at most a quarter of one card's FLOPs plus the part that
    stays whole on every rank (``_unsplit_flops``)."""
    cfg = get_smoke_config(arch)
    seq = 64 if kind == "decode" else 32
    shape = ShapeConfig(kind, seq, 4, kind)
    one = _flops(arch, shape, "1x1", monkeypatch)
    four = _flops(arch, shape, "1x4", monkeypatch)
    whole = _unsplit_flops(arch, kind, cfg, 4, seq)
    print(f"smoke {arch} {kind}: {one:.6e} FLOPs on one card, {four:.6e} a card on 1x4 "
          f"({four / one:.4f} of one; the unsplit part {whole:.6e})")
    assert four <= one / 4 + whole


@pytest.mark.parametrize("arch,split", [("granite-moe", "seq"), ("xlstm", "weights")], ids=["granite-moe", "xlstm"])
def test_launch_train_splits_over_model_under_torchrun(tmp_path, arch, split):
    """``python -m repro_torch.launch.train --mesh 1x2`` under ``torchrun``
    (two gloo processes): the step splits over 'model' (sequence-parallel,
    or the xLSTM's heads with the residual whole) and trains."""
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu", "--mesh", "1x2",
           "--steps", "2", "--seq", "128", "--batch", "4", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"mesh={{'data': 1, 'model': 2}} (2 processes, cpu) split={split}" in out.stdout
    assert out.stdout.count("2 steps in") == 1 and "restarts=0" in out.stdout
