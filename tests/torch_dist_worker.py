"""One rank of ``tests/test_torch_distributed.py``: the port's sharded LM path
across processes, with no JAX (each rank imports torch and the port only).

:func:`run` is the spawned process's body.  It joins a process group
through a ``FileStore`` in the test's temporary directory (no port), runs
every scenario in turn and writes what it saw to ``rank{r}.pt`` there for
the test process to compare.  Rank 0 writes the gathered tensors; every
rank writes its own blocks' shapes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# (arch, mesh (data, model), tensor parallel, batch, seq): smoke granite's
# tree-routed MoE needs whole 512-token groups on each batch shard; with tp
# off the model axis carries batch too
STEP_CASES = [
    ("granite-moe", (2, 2), True, 8, 128),
    ("granite-moe", (4, 1), True, 16, 128),
    ("yi", (2, 2), True, 8, 16),
    ("yi", (4, 1), True, 8, 16),
    ("yi", (2, 2), False, 8, 16),
]
# the sharded step in the models' own bf16 activations: smoke yi on 2×2,
# whose batch is split over 'data' alone (2 shards)
BF16_CASE = ("yi", (2, 2), True, 8, 16)
COMPRESSION_ROUNDS = 30
TCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# the restart: checkpoints every 2 steps; every rank fails at step 4, while
# rank 0's thread may still be writing step 4's checkpoint
RESTART_STEPS, RESTART_CKPT_EVERY, RESTART_FAIL_AT = 6, 2, 4


def smoke_cfg(arch: str, dtype: str = "float32"):
    from repro_torch.configs.registry import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def step_batch(arch: str, batch: int, seq: int, step: int = 0) -> dict:
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.train.step import device_batch

    return device_batch(pipeline_for(smoke_cfg(arch), ShapeConfig("t", seq, batch, "train"), seed=0)(step), "cpu")


def compression_grads() -> np.ndarray:
    """The two pods' distinct gradients (the JAX test's)."""
    return np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)


def plc_names(placements) -> tuple[str, ...]:
    """``("S0", "R")`` for (Shard(0), Replicate()): one name a mesh dim."""
    return tuple(f"S{p.dim}" if hasattr(p, "dim") else "R" for p in placements)


def _full(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return (t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()).to("cpu", copy=True)


def sharded_step(arch, shape, tp, batch, seq, device, dtype: str = "float32") -> dict:
    """One sharded train step: its loss, gradients, parameters before and
    after AdamW (gathered) and this rank's moment blocks' shapes.

    Smoke granite on the host is built on ``meta``, placed, and drawn on
    each rank; every other model is drawn whole on the host and placed (the
    reference's weights: a card's generator draws other numbers)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_apply, adamw_init, default_decay_mask
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import loss_and_grads

    mesh = make_test_mesh(*shape, device_type=device.type)
    axes = shd.from_mesh(mesh, tp=tp)
    cfg = smoke_cfg(arch, dtype)
    if arch == "granite-moe" and device.type == "cpu":
        model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
        model.init(torch.Generator(device=device).manual_seed(0))
    else:
        model = build_model(cfg, device="cpu", axes=axes).init(torch.Generator().manual_seed(0))
        model.distribute(mesh)
    before = {n: _full(p) for n, p in model.named_parameters()}
    opt = adamw_init(model)
    loss, aux, grads = loss_and_grads(model, {k: v.to(device) for k, v in step_batch(arch, batch, seq).items()})
    _, opt, stats = adamw_apply(model, grads, opt, TrainConfig(**TCFG), decay_mask=default_decay_mask(model))
    return {
        "loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
        "grad_norm": float(stats["grad_norm"]),
        "grads": {n: _full(g) for n, g in grads.items()},
        "before": before,
        "after": {n: _full(p) for n, p in model.named_parameters()},
        "m_local": {k: tuple(t.to_local().shape) for k, t in opt.m.items()},
        "v_local": {k: tuple(t.to_local().shape) for k, t in opt.v.items()},
        "placements": {n: plc_names(p.placements) for n, p in model.named_parameters()},
    }


def sharded_restart(device, tmp: str) -> dict:
    """Smoke yi on a 2×2 mesh through ``train_loop``: an async checkpoint
    every 2 steps (rank 0 writing), a ``SimulatedFailure`` on every rank at
    step 4 and a restore in place on every rank; then the same loop with no
    failure.  The leaves this rank copied to the host for its checkpoints,
    the steps it restored, both runs' losses, and whether their final
    parameters are equal."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import LoopState, SimulatedFailure, make_train_step, train_loop

    mesh = make_test_mesh(2, 2, device_type=device.type)

    def run_loop(ckpt_dir: str, fail_at: int | None):
        model = build_model(smoke_cfg("yi"), device="cpu", axes=shd.from_mesh(mesh))
        model.init(torch.Generator().manual_seed(0)).distribute(mesh)
        tcfg = TrainConfig(**TCFG, ckpt_every=RESTART_CKPT_EVERY, ckpt_dir=ckpt_dir)
        state = LoopState(model=model, opt_state=adamw_init(model), step=0)
        restored = []

        def injector(i):
            if i == fail_at and not restored:
                raise SimulatedFailure("every rank fails")

        def restore_fn(last):
            restored.append(last)
            ckpt.restore(ckpt_dir, last, {"params": state.model, "opt": state.opt_state})
            return LoopState(model=state.model, opt_state=state.opt_state, step=last)

        state, report = train_loop(state, make_train_step(model, tcfg),
                                   lambda i: {k: v.to(device) for k, v in step_batch("yi", 8, 16, i).items()},
                                   tcfg, max_steps=RESTART_STEPS, failure_injector=injector, restore_fn=restore_fn)
        return report, restored, {n: _full(p) for n, p in state.model.named_parameters()}

    host_copies = []                  # the leaves this rank copied to the host for a checkpoint
    host = ckpt._host
    ckpt._host = lambda leaf: host_copies.append(1) or host(leaf)
    try:
        failed, restored, params = run_loop(os.path.join(tmp, "restart_a"), RESTART_FAIL_AT)
    finally:
        ckpt._host = host
    clean, _, clean_params = run_loop(os.path.join(tmp, "restart_b"), None)
    return {"host_copies": len(host_copies), "restored": restored, "restarts": failed.restarts,
            "losses": failed.losses,
            "clean_losses": clean.losses, "final_step": failed.final_step,
            "params_equal": all(torch.equal(params[n], clean_params[n]) for n in params)}


def compression_rounds(device) -> dict:
    """``cross_pod_compressed_mean`` on a (pod 2, data 2) mesh, 30 rounds of
    error feedback: each pod holds its own gradient row (spec ``P('pod')``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.compression import cross_pod_compressed_mean, init_error_feedback

    mesh = make_mesh((2, 2), ("pod", "data"), device.type)
    spec = {"w": shd.P("pod")}
    g = shd.place(torch.from_numpy(compression_grads()), mesh, spec["w"])
    e = {"w": DTensor.from_local(init_error_feedback((1, 64), shd.mesh_device(mesh)), mesh,
                                 shd.placements(spec["w"], mesh), run_check=False, shape=(2, 64), stride=(64, 1))}
    means, errs = [], []
    for _ in range(COMPRESSION_ROUNDS):
        mean, e = cross_pod_compressed_mean(mesh, {"w": g}, e, spec)
        means.append(mean["w"].to_local().cpu().clone())
        errs.append(e["w"].to_local().cpu().clone())
    return {"pod": mesh.get_coordinate()[0], "means": torch.cat(means), "errs": torch.cat(errs)}


def placement_split(device) -> dict:
    """Each rank's block of an (8, 4) array on a 2×2 mesh, under specs that
    shard one dim, both, and one dim over both axes."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding as shd

    mesh = make_test_mesh(2, 2, device_type=device.type)
    full = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    specs = {"data,model": shd.P("data", "model"), "(data,model)": shd.P(("data", "model"), None),
             "model": shd.P(None, "model")}
    placed = shd.distribute({name: full for name in specs}, mesh, specs)
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, dt in placed.items():
        out[name] = dt.to_local().cpu().clone()
        out[name + " whole"] = bool(torch.equal(dt.full_tensor().cpu(), full))
    return out


def remesh(device, tmp: str) -> dict:
    """The JAX test's elastic re-mesh: an (8, 4) array sharded on a 4×1 mesh,
    saved, restored onto 2×2 with ``shardings=``, and moved by
    ``resize_mesh``; and restored in place into a DTensor placed otherwise."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.loop import resize_mesh

    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    mesh_a = make_test_mesh(4, 1, device_type=device.type)
    mesh_b = make_test_mesh(2, 2, device_type=device.type)
    sharded = {"w": shd.place(tree["w"], mesh_a, shd.P("data", None))}
    d = os.path.join(tmp, "ckpt")
    ckpt.save(d, 0, sharded)
    dist.barrier()
    restored, _ = ckpt.restore(d, 0, tree, shardings={"w": (mesh_b, shd.P("data", "model"))})
    moved = resize_mesh(sharded, {"w": (mesh_b, shd.P(None, "model"))})
    # in place, into a DTensor of another placement
    target = {"w": shd.place(torch.zeros(8, 4), mesh_b, shd.P("model", None))}
    ckpt.restore(d, 0, target)
    return {
        "restored_mesh": shd.mesh_sizes(restored["w"].device_mesh),
        "restored_placements": plc_names(restored["w"].placements),
        "restored": restored["w"].full_tensor().cpu(),
        "restored_local": restored["w"].to_local().cpu().clone(),
        "moved": moved["w"].full_tensor().cpu(),
        "moved_local": moved["w"].to_local().cpu().clone(),
        "in_place": target["w"].full_tensor().cpu(),
        "coord_b": tuple(mesh_b.get_coordinate()),
    }


# sharded prefill and decode (``tests/test_torch_dryrun.py``): (arch, global
# batch, prompt, decode steps) on a 2×2 mesh, batch over 'data' (2 shards);
# smoke granite's shard holds whole 512-token MoE groups at prefill
SERVE_CASES = [("yi", 8, 16, 3), ("granite-moe", 8, 256, 2)]
SERVE_MESH = (2, 2)


def serve_tokens(arch: str, batch: int, prompt: int, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(prompt ids (B, S), each decode step's ids (steps, B, 1)), seeded."""
    rng = np.random.default_rng(len(arch) + prompt)
    vocab = smoke_cfg(arch).vocab_size
    return (rng.integers(0, vocab, (batch, prompt), dtype=np.int32),
            rng.integers(0, vocab, (steps, batch, 1), dtype=np.int32))


def serve_weights_path(tmp: str, arch: str) -> str:
    return os.path.join(tmp, f"serve_{arch}.pt")


def sharded_serve(arch: str, batch: int, prompt: int, steps: int, device, tmp: str) -> dict:
    """Prefill and ``steps`` decode steps of a model placed on a 2×2 mesh, its
    weights the test's (carried from JAX and saved whole): this rank's rows
    of the logits, and which batch shard it computed."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd

    mesh = make_test_mesh(*SERVE_MESH, device_type=device.type)
    axes = shd.from_mesh(mesh)
    model = build_model(smoke_cfg(arch), device="cpu", axes=axes)
    model.load_state_dict(torch.load(serve_weights_path(tmp, arch), weights_only=True))
    model.distribute(mesh)
    ids, dec = serve_tokens(arch, batch, prompt, steps)
    logits, cache = model.prefill({"tokens": torch.from_numpy(ids).to(device)}, max_len=prompt + steps)
    out = {"prefill": logits.cpu(), "decode": []}
    for t in range(steps):
        step_logits, cache = model.decode_step(cache, {"tokens": torch.from_numpy(dec[t]).to(device)})
        out["decode"].append(step_logits.cpu())
    out["batch_shards_after"] = shd.active_shards()      # restored: None
    out["cache_rows"] = int(cache.kv.k.shape[1])
    with shd.batch_shards(mesh, axes, batch) as shards:
        out["shard"], out["shards"] = shards.index, shards.count
    return out


def serve(rank: int, world: int, tmp: str) -> None:
    """The body of one rank of the sharded prefill/decode scenario (gloo)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'serve_store')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = {case: sharded_serve(*case, torch.device("cpu"), tmp) for case in SERVE_CASES}
        torch.save(out, os.path.join(tmp, f"serve_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(rank: int, world: int, tmp: str, backend: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120),
                            device_id=device if backend == "nccl" else None)
    try:
        out = {"steps": {}}
        for arch, shape, tp, batch, seq in STEP_CASES:
            res = sharded_step(arch, shape, tp, batch, seq, device)
            if rank:    # the gathered tensors once, from rank 0
                for k in ("grads", "before", "after"):
                    res.pop(k)
            out["steps"][(arch, shape, tp)] = res
        out["bf16"] = sharded_step(*BF16_CASE, device, dtype="bfloat16")
        if rank:
            for k in ("grads", "before", "after"):
                out["bf16"].pop(k)
        out["compression"] = compression_rounds(device)
        out["placement"] = placement_split(device)
        out["remesh"] = remesh(device, tmp)
        out["restart"] = sharded_restart(device, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
