"""Multi-pod dry-run: plan every (arch × shape) cell on the production meshes
and derive its roofline terms at the H100's peaks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 5 --out results/dryrun_torch.json

The port's counterpart of ``python -m repro.launch.dryrun``, with its flags and
``--jobs``.  ``--no-seq-shard`` turns ``ParallelConfig.seq_shard`` off, as
JAX's flag does: the residual stream of a split step then stays whole on
every rank of ``model`` (the logits, the experts and the decode cache are
split all the same).  The split step's collectives over ``model``
(sequence all-gathers and their reduce-scatters, the loss's all-reduces,
the MoE's all-to-alls and the decode all-reduces) are counted by kind in
``collectives`` beside DTensor's.
JAX's lowers and compiles each cell on 256 or 512 forced host devices and
reads the compiled HLO.  The port runs each cell's real step instead:

  * a **fake process group** of 256 or 512 ranks (``FakeStore``; this
    process is rank 0, and every collective returns at once), with the mesh
    of ``launch/mesh.py`` over it;
  * the model built on ``meta`` (``launch.specs.plan_cell``), placed on the
    mesh by ``distribute`` under a ``FakeTensorMode``: every parameter, the
    AdamW state, the cache and the batch are **fake tensors** (shapes,
    dtypes and devices, no storage), and the tree routers are packed by
    shape (K1's operator has a shape rule);
  * the step (train, prefill or decode) run once under
    :class:`repro_torch.utils.op_cost.OpCost`, which counts one card's
    FLOPs, bytes, collectives and peak live bytes;
  * the terms at the H100's peaks (``launch.roofline``).

Nothing is allocated on any device and no card is needed, as JAX's needs
no TPU: that is the point of a dry-run, not a fallback.  It refuses to run
where a process group already exists, and it destroys its own before a
cell returns, whether the cell ran or failed.

The fake device is the card's (``cuda``) where this torch has CUDA, else
the host's (``cpu``): autograd on a CPU-only build refuses fake CUDA leaves
(its gradient accumulator asks for the CUDA device guard).  The mesh takes
the same device type, so that DTensor's collectives hand back tensors on
the fake tensors' device.  No op on the planned paths branches on the
device type (K1 runs its shape rule on either), so both give the same
counts.

**Rows.**  A row keeps JAX's keys where the quantity is the same
(``arch``, ``shape``, ``step``, ``mesh``, ``chips``,
``coll_bytes_per_chip``, ``compute_s``, ``memory_s``, ``collective_s``,
``dominant``, ``model_flops``, ``useful_ratio``, ``roofline_fraction``,
``coll_summary``, ``fit_bytes``, and ``skip`` / ``error``).  The counted
quantities are named for what they are: ``flops_per_card`` and
``bytes_per_card`` (JAX's ``hlo_flops_per_chip`` and ``hlo_bytes_per_chip``
read from HLO), ``fit_bytes`` the peak live bytes a card (JAX's is XLA's
arguments + temporaries), ``fits`` whether that is within one H100 80GB,
``plan_s`` the wall seconds of the plan (JAX's ``compile_s``), ``k1_ops``
the K1 launches the step makes, ``collectives`` the count and bytes by
kind, ``param_bytes_per_card`` a card's parameter bytes, ``bytes_by_op``
the bytes each op moved (the most first), ``microbatch`` the train cells'
accumulation, ``seq_shard`` whether the residual may be sequence-split,
``commit`` and ``src_tree`` the checkout's commit and the git tree of the
``src/`` that planned the row (:func:`source_version`),
``model_split`` how the step splits over ``model`` (``"seq"``: the
sequence-parallel residual; ``"weights"``: the ranks hold the same tokens;
``"none"``: each rank computes its batch shard whole).  JAX's ``mem`` and
``fit_bytes_tpu`` have no counterpart: there is no XLA memory analysis,
and no donation to discount, since the port writes its cache in place.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import logging
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, cells_for
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import dryrun_config, input_specs, plan_cell
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.utils.op_cost import OpCost, tensor_bytes

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def fake_device_type() -> str:
    """The fake tensors' and the mesh's device type (module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_process_group(world: int):
    """A process group of ``world`` fake ranks (this process rank 0), destroyed
    on exit.  Refuses to start where a process group exists already."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run plans on a fake process group of its own; "
                           "a process group is already initialized in this process")
    # FakeStore's module registers the "fake" backend (torch 2.11 and 2.13 alike)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def source_version() -> dict:
    """``{"commit": HEAD, "src_tree": ...}`` of the checkout: the git tree
    hash of ``src/`` as it is on disk (equal to ``git rev-parse
    <commit>:src`` of any commit that holds this code, whether or not it
    is committed yet), read through a temporary index; Nones outside a
    checkout."""
    import os
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    try:
        def git(*args, env=None):
            return subprocess.run(["git", "-C", root, *args], capture_output=True, text=True, timeout=60,
                                  check=True, env=env).stdout.strip()

        head = git("rev-parse", "HEAD")
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, GIT_INDEX_FILE=os.path.join(tmp, "index"))
            git("read-tree", "HEAD", env=env)
            git("add", "-A", "--", "src", env=env)
            tree = git("write-tree", "--prefix=src/", env=env)
    except (OSError, subprocess.SubprocessError):
        return {"commit": None, "src_tree": None}
    return {"commit": head, "src_tree": tree}


def _local_rows(mesh, axes: shd.MeshAxes, global_batch: int) -> int:
    count = math.prod(mesh.size(d) for d in shd.batch_dims(mesh, axes, global_batch))
    return global_batch // count


def plan_counts(plan, mesh, cfg, shape: ShapeConfig) -> tuple[OpCost, int]:
    """Place ``plan.model`` on ``mesh``, make the step's other arguments and
    count one run of ``plan.fn``, under a ``FakeTensorMode``: (the counts,
    a card's parameter bytes)."""
    model = plan.model.distribute(mesh)
    model.pack_routers()
    dev = shd.mesh_device(mesh)
    batch = input_specs(cfg, shape, device=dev)
    if shape.kind == "train":
        state = (adamw_init(model),)
    elif shape.kind == "decode":
        cache = model.init_cache(_local_rows(mesh, model.axes, shape.global_batch), shape.seq_len)
        state = (cache._replace(pos=shape.seq_len - 1),)
    else:
        state = ()
    with OpCost() as cost:
        cost.track(model, *state, batch)
        out = plan.fn(model, *state, batch)
        del out
    cost.model_split = {None: "none", True: "seq", False: "weights"}[model.model_split(batch)]
    return cost, sum(tensor_bytes(p.to_local() if isinstance(p, DTensor) else p) for p in model.parameters())


def run_cell(arch: str, shape: str | ShapeConfig, *, multi_pod: bool = False, mesh: str | None = None,
             cfg=None, verbose: bool = True, parallel: ParallelConfig | None = None,
             microbatch: int = 0, remat: str | None = None) -> dict:
    """Plan one cell on a fake mesh and count it; returns its row.

    ``mesh`` names a mesh of :data:`MESHES` (default: ``multi_pod``'s
    production mesh); ``cfg`` replaces the arch's config (a smoke config)
    and ``shape`` may be a ``ShapeConfig`` of its own.  The process group
    is gone when it returns.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dryrun_config(cfg or get_config(arch))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name = mesh or ("2x16x16" if multi_pod else "16x16")
    dims, names = MESHES[mesh_name]
    chips = math.prod(dims)
    if remat is not None:
        parallel = dataclasses.replace(parallel or ParallelConfig(), remat=remat)

    t0 = time.perf_counter()
    with fake_process_group(chips):
        dmesh = make_mesh(dims, names, device_type=fake_device_type())
        plan = plan_cell(cfg, shape, shd.from_mesh(dmesh), parallel=parallel,
                         tcfg=TrainConfig(microbatch=microbatch))
        with FakeTensorMode():
            cost, param_bytes = plan_counts(plan, dmesh, cfg, shape)
    wall = time.perf_counter() - t0

    terms = rl.terms_from_counts(arch=arch, shape=shape, step=plan.step_name, mesh_name=mesh_name,
                                 chips=chips, cost=cost, cfg=cfg)
    if verbose:
        print(f"[{arch} × {shape.name} × {mesh_name}] {plan.step_name} planned in {wall:.1f}s")
        print(f"  counted: flops/card={terms.flops:.3e}  bytes/card={terms.bytes:.3e}  "
              f"peak/card={terms.peak_bytes / 2**30:.2f} GiB  fits={terms.fits}  K1 ops={cost.k1}")
        print(f"  collectives: {cost.coll_summary()}")
        print(f"  roofline: compute={terms.compute_s:.3e}s memory={terms.memory_s:.3e}s "
              f"collective={terms.collective_s:.3e}s → dominant={terms.dominant} "
              f"useful={terms.useful_ratio:.2f} frac={terms.roofline_fraction:.3f}")
    row = terms.row()
    row.update(plan_s=wall, k1_ops=cost.k1, ops=cost.ops, collectives=cost.summary()["collectives"],
               param_bytes_per_card=param_bytes, seq_shard=(parallel or ParallelConfig()).seq_shard,
               model_split=cost.model_split, **source_version(),
               bytes_by_op=dict(sorted(cost.bytes_by_op.items(), key=lambda kv: -kv[1])))
    if plan.tcfg is not None:
        row["microbatch"] = plan.tcfg.microbatch
    return row


def _cell_job(task) -> tuple[dict, str]:
    """One cell, in this process or a worker of ``--jobs``: (its row, its printout)."""
    import contextlib
    import io

    arch, shape, mp, kw = task
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            row = run_cell(arch, shape, multi_pod=mp, **kw)
        except Exception as e:  # record and continue: failures are bugs
            traceback.print_exc(file=out)
            row = {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16", "error": repr(e)}
    return row, out.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id, or several separated by commas (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all applicable)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all archs × shapes")
    ap.add_argument("--out", default=None, help="write JSON rows here")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="turn the sequence-parallel residual off (ParallelConfig.seq_shard=False)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--merge", default=None, metavar="COMMIT",
                    help="keep the rows of --out for the cells not planned now; a kept row that records no commit "
                         "gets COMMIT (the code that planned it)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells planned at once, each worker a process of its own (the fake process group "
                         "is process-wide)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    kw = dict(microbatch=args.microbatch, remat=args.remat,
              parallel=ParallelConfig(seq_shard=False) if args.no_seq_shard else None)

    slots, tasks = [], []          # a skip row, or the index of a planned cell
    for arch in archs:
        for shape, ok, why in cells_for(get_config(arch)):
            if args.shape and shape.name != args.shape:
                continue
            if not ok:
                slots.append({"arch": arch, "shape": shape.name, "skip": why})
                continue
            for mp in meshes:
                slots.append(len(tasks))
                tasks.append((arch, shape.name, mp, kw))
    rows, failures = [], []
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            import concurrent.futures
            import multiprocessing

            ex = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            done = ex.map(_cell_job, tasks)
        else:
            done = map(_cell_job, tasks)
        for slot in slots:                  # in order, each as soon as it is planned
            if isinstance(slot, dict):
                print(f"[{slot['arch']} × {slot['shape']}] SKIP: {slot['skip']}")
                rows.append(slot)
                continue
            row, printed = next(done)
            print(printed, end="", flush=True)
            rows.append(row)
            if "error" in row:
                failures.append((row["arch"], row["shape"], row["mesh"], row["error"]))
    print(rl.format_table(rows))
    if args.out and args.merge:
        import json
        import os

        planned = {(r["arch"], r["shape"], r.get("mesh")) for r in rows}
        kept = []
        if os.path.exists(args.out):
            for r in json.load(open(args.out)):
                if (r["arch"], r["shape"], r.get("mesh")) not in planned and r["arch"] not in archs:
                    r.setdefault("commit", args.merge)
                    kept.append(r)
        rows = kept + rows
        rows.sort(key=lambda r: ARCH_IDS.index(r["arch"]) if r["arch"] in ARCH_IDS else len(ARCH_IDS))
    if args.out:
        rl.save_rows(args.out, rows)
        print(f"wrote {len(rows)} rows to {args.out}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print(" ", f_)
        sys.exit(1)
    print(f"\nall {len(rows)} cells OK")


if __name__ == "__main__":
    main()
