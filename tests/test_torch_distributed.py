"""The port's multi-card LM path across spawned processes, on the CPU (gloo).

Four processes (``tests/torch_dist_worker.py``, spawned, joined through a
``FileStore`` in ``tmp_path``: no port, a timeout on every join) run the
sharded train step of smoke granite (MoE, tree router) and smoke yi-6b on a
2×2 and a 4×1 mesh, the int8 cross-pod compression on a (pod 2, data 2)
mesh, the placement of specs, and the elastic re-mesh and sharded restore.
This process holds them against:

  * JAX's single-device step (``jax.value_and_grad`` of the JAX model's
    loss, built with the mesh's axes) on the same weights and batch, and the
    port's own single-device step (the reference's 2×2 step fails, ROADMAP
    §3 item 6): loss within 1e-5 relative, each gradient within 1e-5 of its
    leaf's max-abs;
  * in bf16, the port's single-device step microbatched by the number of
    batch shards (each shard's bf16 gradients round before the f32
    reduction, as each microbatch's do), within the same bounds;
  * an uninterrupted run for the sharded loop's restart: every rank restores
    the step rank 0 wrote last, and the replay ends where that run ends;
  * JAX's ZeRO-1 specs for the moments' per-rank shapes;
  * JAX's ``_compressed_reduce_leaf`` under ``jax.vmap(axis_name="pod")``,
    bit for bit over 30 rounds, with the JAX test's bounds;
  * numpy splits and the array itself for placement, restore and re-mesh.

The card variant (``gpu``) runs the same ranks on four cards over NCCL.
JAX is imported where a test needs it (its step, the ZeRO-1 specs, the
compression): a machine without it skips those comparisons of the card
variant.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro_torch.configs import TrainConfig
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw_apply, adamw_init, default_decay_mask
from repro_torch.parallel import sharding as shd
from repro_torch.train.step import loss_and_grads

WORLD = 4
JOIN_TIMEOUT_S = 150
STEP_TOL = 1e-5


def _spawn(tmp: str, backend: str) -> dict:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, WORLD, tmp, backend)) for r in range(WORLD)]
    for p in procs:
        p.start()
    return {"procs": procs, "tmp": tmp}


def _join(job) -> list[dict]:
    for p in job["procs"]:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in job["procs"] if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    codes = [p.exitcode for p in job["procs"]]
    assert not alive and codes == [0] * WORLD, f"ranks exited {codes} ({len(alive)} killed at the timeout)"
    return [torch.load(os.path.join(job["tmp"], f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def _reference(arch: str, shape, tp: bool, batch: int, seq: int) -> dict:
    """The single-device step on the same weights and batch, its model built
    with the mesh's axes (they set the padded vocabulary and experts).  It
    runs single-threaded, as the ranks do: another thread count rounds the
    matmuls otherwise."""
    sizes = {"data": shape[0], "model": shape[1]}
    axes = shd.MeshAxes(("data",) if tp else ("data", "model"), "model", sizes, tp=tp)
    model = build_model(W.smoke_cfg(arch), device="cpu", axes=axes)
    model.init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, aux, grads = loss_and_grads(model, W.step_batch(arch, batch, seq))
    finally:
        torch.set_num_threads(threads)
    return {"model": model, "loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
            "grads": grads, "before": before}


def _jax_compression() -> tuple[np.ndarray, np.ndarray] | None:
    """JAX's leaf reduction over a vmapped "pod" axis: (30, 2, 64) means and
    errors (None without JAX).  Op by op on JAX's CPU backend, as the
    function is written and as the JAX package's tests run it: under
    ``jax.jit`` XLA fuses the scale's division, and its means differ from
    those by one ulp."""
    try:
        import jax
        import jax.numpy as jnp

        from repro.parallel import compression as jcomp
    except ImportError:
        return None
    with jax.default_device(jax.devices("cpu")[0]):
        g = jnp.asarray(W.compression_grads())
        e = jnp.zeros_like(g)
        fn = jax.vmap(lambda g, e: jcomp._compressed_reduce_leaf(g, e, "pod", 2), axis_name="pod")
        means, errs = [], []
        for _ in range(W.COMPRESSION_ROUNDS):
            m, e = fn(g, e)
            means.append(np.asarray(m))
            errs.append(np.asarray(e))
    return np.stack(means), np.stack(errs)


def _jax_steps(refs: dict) -> dict | None:
    """JAX's single-device loss and gradients for each step case, on the port
    reference's initial weights (the sharded step's, a test holds them
    equal), its model built with the mesh's axes: {case: {"loss", "nll",
    "aux", "grads" by the port's names}} (None without JAX)."""
    try:
        import jax

        from repro.configs import registry as jreg
        from repro.models.api import build_model as jax_build_model
        from repro.parallel import sharding as jshd
    except ImportError:
        return None

    def port_names(tree) -> dict:
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys, arr = [k.key for k in path], np.asarray(leaf)
            if keys[0] == "layers":          # stacked (L, …): one parameter a layer
                out.update({".".join(["layers", str(i), *keys[1:]]): a for i, a in enumerate(arr)})
            else:
                out[".".join(keys)] = arr
        return out

    def jax_params(template, named: dict):
        def leaf(path, spec):
            keys = [k.key for k in path]
            if keys[0] == "layers":
                return np.stack([named[".".join(["layers", str(i), *keys[1:]])].numpy() for i in range(spec.shape[0])])
            return named[".".join(keys)].numpy()
        return jax.tree_util.tree_map_with_path(leaf, template)

    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for arch, (d, m), tp, batch, seq in W.STEP_CASES:
            axes = jshd.MeshAxes(("data",) if tp else ("data", "model"), "model", {"data": d, "model": m}, tp=tp)
            jm = jax_build_model(dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32"), axes)
            params = jax_params(jax.eval_shape(jm.init, jax.random.key(0)), refs[(arch, (d, m), tp)]["before"])
            jb = {k: v.numpy() for k, v in W.step_batch(arch, batch, seq).items()}
            (loss, aux), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
            out[(arch, (d, m), tp)] = {"loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
                                       "grads": port_names(grads)}
    return out


def _run_all(tmp: str, backend: str) -> dict:
    job = _spawn(tmp, backend)
    try:
        refs = {case[:3]: _reference(*case) for case in W.STEP_CASES}
        jax_steps = _jax_steps(refs)
        jax_comp = _jax_compression()
    finally:
        ranks = _join(job)
    return {"ranks": ranks, "refs": refs, "jax_steps": jax_steps, "jax_comp": jax_comp}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    return _run_all(str(tmp_path_factory.mktemp("gloo")), "gloo")


@pytest.fixture(scope="module")
def nccl_run(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices")
    return _run_all(str(tmp_path_factory.mktemp("nccl")), "nccl")


def _run(request, backend: str) -> dict:
    return request.getfixturevalue("gloo_run" if backend == "gloo" else "nccl_run")


def run_ranks(request, backend):
    return _run(request, backend)["ranks"]


BACKENDS = ["gloo", pytest.param("nccl", marks=pytest.mark.gpu)]
CASE_IDS = [f"{a}-{d}x{m}" + ("" if tp else "-dp") for a, (d, m), tp, _, _ in W.STEP_CASES]
CASES = [case[:3] for case in W.STEP_CASES]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_step_loss_and_gradients_equal_single_device(request, backend, case):
    run = _run(request, backend)
    ref, got = run["refs"][case], run["ranks"][0]["steps"][case]
    for r in run["ranks"]:          # the metrics are the same on every rank
        assert r["steps"][case]["loss"] == got["loss"]
    assert abs(got["loss"] - ref["loss"]) <= STEP_TOL * abs(ref["loss"]), (got["loss"], ref["loss"])
    assert abs(got["nll"] - ref["nll"]) <= STEP_TOL * abs(ref["nll"])
    assert abs(got["aux"] - ref["aux"]) <= STEP_TOL * max(abs(ref["aux"]), 1e-30)
    for n, p in ref["before"].items():
        assert torch.equal(got["before"][n], p), f"{n}: the sharded init differs"
    assert set(got["grads"]) == set(ref["grads"])
    for n, g in ref["grads"].items():
        scale = float(g.abs().max())
        err = float((got["grads"][n] - g).abs().max())
        assert err <= STEP_TOL * max(scale, 1e-30), f"{n}: {err} vs max-abs {scale}"


def _assert_step_close(got: dict, want: dict, names) -> None:
    """Loss terms within STEP_TOL relative; ``got``'s gradients (when it has
    them) within STEP_TOL of each leaf's max-abs."""
    for k in ("loss", "nll", "aux"):
        if k in want:
            assert abs(got[k] - want[k]) <= STEP_TOL * max(abs(want[k]), 1e-30), (k, got[k], want[k])
    if "grads" not in got:
        return
    assert set(got["grads"]) == set(names)
    for n in names:
        g, w = np.asarray(got["grads"][n], dtype=np.float32), np.asarray(want["grads"][n], dtype=np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= STEP_TOL * max(scale, 1e-30), f"{n}: {err} vs max-abs {scale}"


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_step_loss_and_gradients_equal_jax_single_device(request, backend, case):
    """Each rank's sharded loss (and rank 0's gathered gradients) against
    JAX's single-device ``value_and_grad`` on the same weights and batch."""
    run = _run(request, backend)
    if run["jax_steps"] is None:
        pytest.skip("JAX is not installed: no reference for the step")
    want = run["jax_steps"][case]
    for r in run["ranks"]:
        _assert_step_close(r["steps"][case], want, want["grads"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_bf16_step_equals_single_device_microbatched_by_its_shards(request, backend):
    """In bf16 each batch shard's weight gradients round to bf16 before the
    f32 reduce-scatter sums them, where one device rounds the whole batch's
    once: the sharded step is the single-device step with ``microbatch``
    equal to the number of batch shards, whose parts' bf16 gradients are
    summed in f32 too.  The reference runs where the ranks ran (the card's
    bf16 products are not the host's)."""
    run = _run(request, backend)
    dev = torch.device("cpu") if backend == "gloo" else torch.device("cuda", 0)
    arch, (d, m), tp, batch, seq = W.BF16_CASE
    axes = shd.MeshAxes(("data",), "model", {"data": d, "model": m}, tp=tp)
    shards = int(np.prod([{"data": d, "model": m}[a] for a in axes.batch_axes_for(batch)]))
    assert shards == 4
    model = build_model(W.smoke_cfg(arch, "bfloat16"), device="cpu", axes=axes)
    model.init(torch.Generator().manual_seed(0))
    got = run["ranks"][0]["bf16"]
    for n, p in model.named_parameters():
        assert torch.equal(got["before"][n], p.detach()), f"{n}: the sharded init differs"
    model.to(dev)
    loss, _, grads = loss_and_grads(model, {k: v.to(dev) for k, v in W.step_batch(arch, batch, seq).items()},
                                    microbatch=shards)
    want = {"loss": float(loss), "grads": {n: g.cpu().numpy() for n, g in grads.items()}}
    for r in run["ranks"]:
        _assert_step_close(r["bf16"], want, want["grads"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_loop_restarts_every_rank_from_rank_0s_last_checkpoint(request, backend):
    """Every rank fails at step 4, just after the step-4 checkpoint was handed
    to rank 0's writer thread: each restores step 4, and the replay gives
    the uninterrupted run's losses and final parameters, bit for bit.  Only
    rank 0 copies the gathered state to the host."""
    ranks = run_ranks(request, backend)
    copies = [r["restart"]["host_copies"] for r in ranks]
    assert copies[0] > 0 and copies[1:] == [0] * (len(ranks) - 1), copies
    for r in ranks:
        x = r["restart"]
        assert x["restored"] == [W.RESTART_FAIL_AT] and x["restarts"] == 1
        assert x["final_step"] == W.RESTART_STEPS
        assert x["losses"] == x["clean_losses"] and len(x["losses"]) == W.RESTART_STEPS
        assert x["params_equal"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_adamw_equals_single_device_adamw_on_the_same_gradients(request, backend, case):
    """ROADMAP §3 item 17's comparison: AdamW applied on one device to the
    sharded step's own gradients gives the sharded step's parameters."""
    run = _run(request, backend)
    ref, got = run["refs"][case], run["ranks"][0]["steps"][case]
    model = ref["model"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(ref["before"][n])
    opt = adamw_init(model)
    _, _, stats = adamw_apply(model, got["grads"], opt, TrainConfig(**W.TCFG), decay_mask=default_decay_mask(model))
    assert abs(float(stats["grad_norm"]) - got["grad_norm"]) <= 1e-6 * got["grad_norm"]
    for n, p in model.named_parameters():
        err = float((got["after"][n] - p.detach()).abs().max())
        assert err <= 1e-6, f"{n}: {err}"


def _block_shape(shape, spec, sizes) -> tuple:
    """The shape of one block of ``shape`` under a JAX spec."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            out[i] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_zero1_moments_are_jax_blocks_on_every_rank(request, backend, case):
    jax = pytest.importorskip("jax")
    from repro.configs import registry as jreg
    from repro.models.api import build_model as jax_build_model
    from repro.optim import adamw as jadamw
    from repro.parallel import sharding as jshd

    run = _run(request, backend)
    arch, (d, m), tp = case
    sizes = {"data": d, "model": m}
    jaxes = jshd.MeshAxes(("data",) if tp else ("data", "model"), "model", sizes, tp=tp)
    jm = jax_build_model(jreg.get_smoke_config(arch), jaxes)
    is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)      # noqa: E731
    flat = lambda tree: {".".join(str(k.key) for k in path): leaf    # noqa: E731
                         for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]}
    want = flat(jadamw.adamw_state_specs(jm.param_specs(), jm.param_shapes(), jm.axes).m)
    pspecs, shapes = flat(jm.param_specs()), flat(jm.param_shapes())
    for r in run["ranks"]:
        got = r["steps"][case]
        assert set(got["m_local"]) == set(want)
        for key, spec in want.items():
            block = _block_shape(shapes[key].shape, spec, sizes)
            assert got["m_local"][key] == block == got["v_local"][key], key
    if d > 1:      # ZeRO-1 slices some moment over 'data' where its parameter is not
        assert any("data" in tuple(want[k]) and "data" not in tuple(pspecs[k]) for k in want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_pod_compressed_mean_equals_jax_bit_for_bit(request, backend):
    run = _run(request, backend)
    if run["jax_comp"] is None:
        pytest.skip("JAX is not installed: no reference for the compression")
    jmeans, jerrs = run["jax_comp"]
    g = W.compression_grads()
    true_mean = g.mean(0)
    scale = np.abs(g).max() / 127
    for r in run["ranks"]:
        c = r["compression"]
        means, errs = c["means"].numpy(), c["errs"].numpy()
        assert means.shape == errs.shape == (W.COMPRESSION_ROUNDS, 64)
        np.testing.assert_array_equal(means, jmeans[:, c["pod"]])
        np.testing.assert_array_equal(errs, jerrs[:, c["pod"]])
        # the JAX test's bounds: each round within 2 quantization steps, the
        # running average within half of one
        assert np.abs(means - true_mean).max(axis=1).max() < 2 * scale + 1e-6
        assert np.abs(means.mean(0) - true_mean).max() < 0.5 * scale + 1e-6


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_compression_arithmetic_equals_jax_on_one_device(device):
    """The leaf arithmetic of the compressed mean (``_div``, ``quantize``,
    ``dequantize``) on one device, the two pods' reductions summed by hand:
    bit-equal to JAX's op-by-op reference over 30 rounds (the card's
    division must not take a reciprocal shortcut)."""
    from repro_torch.parallel import compression as comp

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    want = _jax_compression()
    if want is None:
        pytest.skip("JAX is not installed: no reference for the compression")
    g = torch.from_numpy(W.compression_grads()).to(device)
    e = torch.zeros_like(g)
    for i in range(W.COMPRESSION_ROUNDS):
        gf = g + e
        scale = torch.max(torch.stack([comp._div(torch.max(torch.abs(row)), 127.0) for row in gf]))
        q = comp.quantize(gf, scale)
        mean = comp._div(comp.dequantize(q.to(torch.int32).sum(0), scale), 2)
        e = gf - comp.dequantize(q, scale)
        np.testing.assert_array_equal(mean.cpu().numpy(), want[0][i, 0])
        np.testing.assert_array_equal(e.cpu().numpy(), want[1][i])


@pytest.mark.parametrize("backend", BACKENDS)
def test_placements_split_as_numpy_on_a_2x2_mesh(request, backend):
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r in run_ranks(request, backend):
        p = r["placement"]
        i, j = p["coord"]
        np.testing.assert_array_equal(p["data,model"].numpy(), np.split(np.split(full, 2, 0)[i], 2, 1)[j])
        # one dim over both axes: 'data' the major, as JAX lays it out
        np.testing.assert_array_equal(p["(data,model)"].numpy(), np.split(full, 4, 0)[2 * i + j])
        np.testing.assert_array_equal(p["model"].numpy(), np.split(full, 2, 1)[j])
        assert p["data,model whole"] and p["(data,model) whole"] and p["model whole"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_elastic_remesh_and_sharded_restore_give_back_the_array(request, backend):
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r in run_ranks(request, backend):
        x = r["remesh"]
        assert x["restored_mesh"] == {"data": 2, "model": 2}
        assert x["restored_placements"] == ("S0", "S1")
        np.testing.assert_array_equal(x["restored"].numpy(), full)
        np.testing.assert_array_equal(x["moved"].numpy(), full)
        np.testing.assert_array_equal(x["in_place"].numpy(), full)
        i, j = x["coord_b"]
        np.testing.assert_array_equal(x["restored_local"].numpy(), np.split(np.split(full, 2, 0)[i], 2, 1)[j])
        np.testing.assert_array_equal(x["moved_local"].numpy(), np.split(full, 2, 1)[j])


@pytest.mark.parametrize("backend", BACKENDS)
def test_parameters_are_placed_by_their_specs(request, backend):
    run = _run(request, backend)
    got = run["ranks"][0]["steps"][("yi", (2, 2), True)]["placements"]
    # yi's wq (D, H·hd) is (data × model); its norm scales are replicated
    assert got["layers.0.attn.wq"] == ("S0", "S1")
    assert got["layers.0.ln1.scale"] == ("R", "R")
    assert got["embed.table"] == ("S1", "S0")
    got = run["ranks"][0]["steps"][("granite-moe", (2, 2), True)]["placements"]
    assert got["layers.0.moe.router_thr"] == ("R", "R")
    # smoke granite's 5 experts pad to 6 on model=2 and shard over it
    assert got["layers.0.moe.wi"] == ("S1", "S0")
    # with tp off the model axis stores nothing: yi's wq is sharded on data only
    got = run["ranks"][0]["steps"][("yi", (2, 2), False)]["placements"]
    assert got["layers.0.attn.wq"] == ("S0", "R")


def test_stale_router_raises_after_a_sharded_step_until_packed(tmp_path):
    """A one-rank gloo group: the sharded step moves ``router_thr`` (a
    replicated DTensor) and the hard route refuses its stale tables."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.train.step import make_train_step

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = single_device_mesh("cpu")
        cfg = W.smoke_cfg("granite-moe")
        model = build_model(cfg, device="meta", axes=shd.from_mesh(mesh)).distribute(mesh)
        model.init(torch.Generator().manual_seed(0))
        batch = W.step_batch("granite-moe", 4, 16)
        step = make_train_step(model, TrainConfig(**W.TCFG))
        step(model, adamw_init(model), batch)
        assert all(r.stale for r in model.tree_routers())
        with torch.no_grad(), model.gathered_top(), pytest.raises(RuntimeError, match="changed since"):
            model.hidden({"tokens": batch["tokens"]}, serve_hard_tree=True)
        model.pack_routers()
        with torch.no_grad(), model.gathered_top():
            x, _ = model.hidden({"tokens": batch["tokens"]}, serve_hard_tree=True)
        assert torch.isfinite(x).all()
    finally:
        dist.destroy_process_group()


def test_launch_train_mesh_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2x1`` under ``torchrun``
    (two gloo processes on the host, a port the launcher picks): rank 0
    prints the report line, the checkpoint is written once."""
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(__file__), "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--arch", "yi", "--smoke", "--device", "cpu", "--mesh", "2x1",
           "--steps", "2", "--seq", "16", "--batch", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("arch=yi-smoke") == 1 and "mesh={'data': 2, 'model': 1} (2 processes, cpu) split=none" in out.stdout
    assert out.stdout.count("2 steps in") == 1 and "restarts=0" in out.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["LATEST", "step_000002"]


def test_launch_train_refuses_a_mesh_without_torchrun():
    from repro_torch.launch import train as launch

    with pytest.raises(SystemExit, match="needs 4 processes, 1 are running"):
        launch.main(["--arch", "yi", "--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "1"])
    assert launch.mesh_shape("auto", 4) == (4, 1) and launch.mesh_shape("2x2", 4) == (2, 2)


def test_each_torchrun_process_takes_its_own_card(monkeypatch):
    from repro_torch import _device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert _device.default_card() == "cuda"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert _device.default_card() == "cuda:3"
