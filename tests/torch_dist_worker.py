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

from repro_torch.models.schema import cache_leaves  # noqa: F401  (the tests walk caches with it)

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
# the sharded step in the models' own bf16 activations: smoke yi on 4×1,
# whose batch is split over 'data' alone (4 shards) and whose compute is not
# split over 'model' (a 'model' axis of 1: the premise of the comparison
# with one device microbatched by the batch shards)
BF16_CASE = ("yi", (4, 1), True, 8, 16)
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
# batch, prompt, decode steps) on a 4×1 mesh, batch over 'data' (4 shards),
# a 'model' axis of 1, where nothing is split over it and each rank computes
# one device's program on its rows (``tests/test_torch_model_axis.py``
# holds the split); smoke granite's shard holds whole 512-token MoE groups
# at prefill
SERVE_CASES = [("yi", 8, 16, 3), ("granite-moe", 8, 256, 2)]
SERVE_MESH = (4, 1)


def serve_tokens(arch: str, batch: int, prompt: int, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(prompt ids (B, S), each decode step's ids (steps, B, 1)), seeded."""
    rng = np.random.default_rng(len(arch) + prompt)
    vocab = smoke_cfg(arch).vocab_size
    return (rng.integers(0, vocab, (batch, prompt), dtype=np.int32),
            rng.integers(0, vocab, (steps, batch, 1), dtype=np.int32))


def serve_weights_path(tmp: str, arch: str) -> str:
    return os.path.join(tmp, f"serve_{arch}.pt")


def sharded_serve(arch: str, batch: int, prompt: int, steps: int, device, tmp: str) -> dict:
    """Prefill and ``steps`` decode steps of a model placed on SERVE_MESH, its
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


# the step split over 'model' (``tests/test_torch_model_axis.py``): smoke
# models on a 1×4 and a 2×2 mesh, tp on.  The batch and prompt give each
# batch shard whole 512-token MoE groups, each spread over the sequence
# shards of several rows and ranks; the cache holds prompt + DECODE_ROOM
# positions (a multiple of |model|) and takes AXIS_DECODE steps.  Whisper's
# inputs carry its smoke encoder's 24 frames.
AXIS_ARCHS = ["yi", "granite-moe", "phi3.5-moe-42b-a6.6b", "hymba", "xlstm", "whisper"]
# the archs whose ranks of 'model' hold the same tokens (no sequence split)
AXIS_WHOLE_TOKENS = ("xlstm",)
# the mLSTM's "dh" layout: smoke xLSTM with 2 heads on 1×4 (the heads do not
# divide 'model', the head dim does)
DH_ARCH, DH_MESH, DH_HEADS = "xlstm", (1, 4), 2
AXIS_MESHES = [(1, 4), (2, 2)]
AXIS_BATCH, AXIS_SEQ, AXIS_DECODE, DECODE_ROOM = 8, 128, 3, 4
# capacity drops across sequence shards: smoke granite with a capacity
# factor of 1 on 2×2, one row a batch shard, 512 positions, so each group is
# one row whose halves lie on the two ranks of a 'model' row
DROP_ARCH, DROP_MESH, DROP_BATCH, DROP_SEQ, DROP_CAPACITY = "granite-moe", (2, 2), 2, 512, 1.0


# ``parallel.seq_shard`` off (JAX's --no-seq-shard): the ranks of 'model'
# hold the same tokens and split the experts and the vocabulary only
NOSEQ_ARCH, NOSEQ_MESH = "granite-moe", (2, 2)


def axis_cfg(arch: str, capacity: float | None = None, heads: int | None = None):
    cfg = smoke_cfg(arch)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    return cfg


def axis_weights_path(tmp: str, arch: str, mesh, tag: str = "") -> str:
    return os.path.join(tmp, f"axis_{arch}{tag}_{mesh[0]}x{mesh[1]}.pt")


def axis_inputs(arch: str, batch: int = AXIS_BATCH, seq: int = AXIS_SEQ) -> dict:
    """The step's batch, the prompt (ids (B, S), and frame embeddings for an
    encoder-decoder) and each decode step's ids."""
    rng = np.random.default_rng(len(arch) + seq)
    cfg = smoke_cfg(arch)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    if cfg.encoder is not None:
        prompt["embeds"] = (rng.normal(size=(batch, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return {"train": step_batch(arch, batch, seq), "prompt": prompt,
            "decode": rng.integers(0, cfg.vocab_size, (AXIS_DECODE, batch, 1), dtype=np.int32)}


def cache_layout(model) -> str | None:
    """How this rank's decode cache splits over 'model': the attention
    cache's layout ("heads" | "seq"), else the mLSTM's ("heads" | "dh")."""
    if hasattr(model, "cache_split"):
        return model.cache_split()[0]
    from repro_torch.models.layers.xlstm import mlstm_layout

    return mlstm_layout(model.cfg, model.axes.model_size)


def axis_case(arch: str, shape, device, tmp: str, *, capacity=None, batch=AXIS_BATCH, seq=AXIS_SEQ,
              serve: bool = True, seq_shard: bool = True, heads: int | None = None, tag: str = "") -> dict:
    """One model split over 'model': a train step (loss, aux, gradients
    gathered), then prefill and AXIS_DECODE decode steps (this rank's rows,
    every vocabulary column), this rank's cache shape and batch shard."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import loss_and_grads

    mesh = make_test_mesh(*shape, device_type=device.type)
    axes = shd.from_mesh(mesh)
    from repro_torch.configs import ParallelConfig

    model = build_model(axis_cfg(arch, capacity, heads), device="cpu", axes=axes,
                        parallel=ParallelConfig(seq_shard=seq_shard))
    model.load_state_dict(torch.load(axis_weights_path(tmp, arch, shape, tag), weights_only=True))
    model.distribute(mesh)
    inputs = axis_inputs(arch, batch, seq)
    train = {k: v.to(device) for k, v in inputs["train"].items()}
    split = model.model_split(train)
    loss, aux, grads = loss_and_grads(model, train)
    out = {"loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]), "seq_split": split,
           "grads": {n: _full(g) for n, g in grads.items()}}
    with shd.batch_shards(mesh, axes, batch) as shards:
        out["shard"], out["shards"] = shards.index, shards.count
    if not serve:
        return out
    prompt = {k: torch.from_numpy(v).to(device) for k, v in inputs["prompt"].items()}
    logits, cache = model.prefill(prompt, max_len=seq + DECODE_ROOM)
    out["prefill"] = model.gathered_logits(logits, prompt).cpu()
    out["decode"] = []
    for t in range(AXIS_DECODE):
        tok = {"tokens": torch.from_numpy(inputs["decode"][t]).to(device)}
        logits, cache = model.decode_step(cache, tok)
        out["decode"].append(model.gathered_logits(logits, tok).cpu())
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in cache_leaves(cache).items()}
    out["cache_layout"] = cache_layout(model)
    return out


def served_collectives(arch: str, shape, device, heads: int | None = None) -> dict:
    """The collectives by kind of a prefill (AXIS_BATCH x AXIS_SEQ) and of a
    decode step of the model the dry-run serves on this mesh
    (``launch.specs.plan_cell``, its size policy lifted so that the smoke
    model splits over 'model'), seeded weights: what its fake plan counts."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.op_cost import OpCost

    mesh = make_test_mesh(*shape, device_type=device.type)
    floor, specs.TP_MIN_PARAMS = specs.TP_MIN_PARAMS, 0
    try:
        plan = specs.plan_cell(axis_cfg(arch, heads=heads), ShapeConfig("prefill", AXIS_SEQ, AXIS_BATCH, "prefill"),
                               shd.from_mesh(mesh))
    finally:
        specs.TP_MIN_PARAMS = floor
    model = plan.model.distribute(mesh)
    model.init(torch.Generator(device=device).manual_seed(0))
    inputs = axis_inputs(arch)
    prompt = {k: torch.from_numpy(v).to(device) for k, v in inputs["prompt"].items()}
    out = {}
    with torch.no_grad():
        with OpCost() as counted:
            _, cache = model.prefill(prompt, max_len=AXIS_SEQ + DECODE_ROOM)
        out["prefill"] = dict(counted.coll_count)
        tok = {"tokens": torch.from_numpy(inputs["decode"][0]).to(device)}
        with OpCost() as counted:
            model.decode_step(cache, tok)
        out["decode"] = dict(counted.coll_count)
    return out


def collective_adjoints(device) -> dict:
    """Each autograd collective over 'model' on a 2×2 mesh, as <f(x), y>
    and <x, f'(y)> for seeded x and y (f' its backward).  An input or
    output that the ranks of a 'model' row hold alike (a replicated
    tensor, or one consumed alike) is drawn alike on them and counted once:
    this rank's two terms, each divided by |model| where alike, which
    summed over the ranks must agree."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding as shd

    mesh = make_test_mesh(2, 2, device_type=device.type)
    axes = shd.from_mesh(mesh)
    out = {}
    with shd.model_shards(mesh, axes, seq=False) as alike, shd.model_shards(mesh, axes, seq=True) as ms:
        ids = torch.tensor([[0, 5, 9], [15, 3, 12]])       # rows of a (16, 3) table split over model 2
        # name: (f, x alike on the row, y alike on the row)
        fns = {"seq_gather": (lambda x: shd.seq_gather(x, 1, ms), False, False),
               "seq_scatter": (lambda x: shd.seq_scatter(x, 1, ms), False, False),
               "model_all_to_all": (lambda x: shd.model_all_to_all(x, ms), False, False),
               "model_sum": (lambda x: shd.model_sum(x, ms), False, True),
               "gather_alike": (lambda x: shd.gather_alike(x, 1, ms), False, True),
               "enter_split": (lambda x: shd.enter_split(x, ms), True, False),
               "channel_gather": (lambda x: shd.seq_gather(x, -1, ms), False, False),
               "whole_tokens": (lambda x: shd.whole_tokens(x, alike), True, False),
               "whole_tokens_seq": (lambda x: shd.whole_tokens(x, ms), False, False),
               "residual_sum": (lambda x: shd.residual_sum(x, alike), False, True),
               "residual_sum_seq": (lambda x: shd.residual_sum(x, ms), False, False),
               "shared_sum": (lambda x: shd.shared_sum(x, ms), False, False),
               "vocab_lookup": (lambda x: shd.vocab_lookup(x.reshape(8, 3), ids, ms), False, True)}
        row = mesh.get_coordinate()[0]
        for name, (fn, x_alike, y_alike) in fns.items():
            def draw(shape, alike, salt):
                seed = 1000 * salt + (row if alike else dist.get_rank()) + 10 * len(name)
                return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)

            x = draw((2, 4, 3), x_alike, 1).requires_grad_()
            fx = fn(x)
            y = draw(tuple(fx.shape), y_alike, 2)
            (gx,) = torch.autograd.grad(fx, x, y)
            out[name] = (float((fx.detach() * y).sum()) / (ms.size if y_alike else 1),
                         float((x.detach() * gx).sum()) / (ms.size if x_alike else 1))
    return out


def drop_slots(device) -> dict:
    """``capacity_positions`` of each rank's pieces of seeded expert ids on
    DROP_MESH (one row of DROP_SEQ positions a batch shard, split over the
    'model' row): this rank's slots, and where its tokens lie."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import moe as lm_moe
    from repro_torch.parallel import sharding as shd

    mesh = make_test_mesh(*DROP_MESH, device_type=device.type)
    axes = shd.from_mesh(mesh)
    cfg = axis_cfg(DROP_ARCH, DROP_CAPACITY)
    e_pad = lm_moe.padded_experts(cfg.moe, axes.model_size)
    top = drop_experts(cfg, e_pad)
    with shd.batch_shards(mesh, axes, DROP_BATCH) as shards, shd.model_shards(mesh, axes, seq=True) as ms:
        s = DROP_SEQ // ms.size
        rows = DROP_BATCH // shards.count
        mine = top[shards.index * rows:(shards.index + 1) * rows, ms.index * s:(ms.index + 1) * s]
        slots = lm_moe.capacity_positions(torch.from_numpy(mine).to(device), e_pad, 512, ms)
        return {"slots": slots.cpu(), "rows": (shards.index * rows, rows), "seq": (ms.index * s, s),
                "cap": lm_moe._capacity(512, cfg.moe, e_pad)}


def drop_experts(cfg, e_pad: int) -> np.ndarray:
    """Seeded (B, S, k) expert ids, skewed toward expert 0 so that it overflows."""
    rng = np.random.default_rng(5)
    b, s, k = DROP_BATCH, DROP_SEQ, cfg.moe.top_k
    first = np.where(rng.random((b, s)) < 0.4, 0, rng.integers(0, cfg.moe.n_experts, (b, s)))
    return ((first[..., None] + np.arange(k)) % cfg.moe.n_experts).astype(np.int64)


def model_axis(rank: int, world: int, tmp: str) -> None:
    """The body of one rank of the split-compute scenario (gloo)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'axis_store')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    device = torch.device("cpu")
    try:
        out = {}
        for arch in AXIS_ARCHS:
            for shape in AXIS_MESHES:
                res = axis_case(arch, shape, device, tmp)
                if rank:
                    res.pop("grads")
                out[(arch, shape)] = res
        res = axis_case(DROP_ARCH, DROP_MESH, device, tmp, capacity=DROP_CAPACITY, batch=DROP_BATCH,
                        seq=DROP_SEQ, serve=False)
        if rank:
            res.pop("grads")
        out["drop_step"] = res
        out["drop_slots"] = drop_slots(device)
        res = axis_case(NOSEQ_ARCH, NOSEQ_MESH, device, tmp, seq_shard=False)
        if rank:
            res.pop("grads")
        out["noseq"] = res
        res = axis_case(DH_ARCH, DH_MESH, device, tmp, heads=DH_HEADS, tag="dh")
        if rank:
            res.pop("grads")
        out["dh"] = res
        out["served_collectives"] = {mesh: served_collectives("xlstm", mesh, device) for mesh in AXIS_MESHES}
        out["served_collectives"]["dh"] = served_collectives(DH_ARCH, DH_MESH, device, heads=DH_HEADS)
        out["adjoints"] = collective_adjoints(device)
        torch.save(out, os.path.join(tmp, f"axis_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
