"""Training launcher: the fault-tolerant loop over the synthetic pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe \\
        --smoke --device cpu --steps 50 --seq 128 --batch 4

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch yi --mesh 2x2 --steps 3 --batch 4

The port's counterpart of ``python -m repro.launch.train``, with its flags
and printout, and ``--device`` (default: the card).  ``--smoke`` selects
the reduced config; without it the assigned architecture trains at full
size.  Weights are random, drawn from a ``torch.Generator`` seeded 0 on
the device.

``--mesh auto|DxM`` is JAX's flag.  Under ``torchrun`` (one process per
card, ``cuda:{LOCAL_RANK}``; gloo with ``--device cpu``) the process group
comes from the environment and the model is placed on a ``(data, model)``
mesh over every rank: ``auto`` is ``(world, 1)``.  Its parameters and
AdamW state are sharded by the JAX specs (ZeRO-1), each rank computes on
its rows of the batch, split over ``model`` where that is above 1 (the
sequence-parallel residual, vocab-sharded loss and expert-parallel MoE of
``parallel.sharding``; printed as ``split=seq``), and rank 0 prints and
writes the checkpoints.
Without ``torchrun`` one process trains on one device, with no process
group, and ``--mesh`` must be ``auto`` or ``1x1``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.train.loop import LoopState, train_loop
from repro_torch.train.step import device_batch, make_train_step


def mesh_shape(spec: str, world: int) -> tuple[int, int]:
    """``auto`` → (world, 1); ``DxM`` → (D, M), which must cover ``world``."""
    if spec == "auto":
        return world, 1
    d, m = (int(x) for x in spec.lower().split("x"))
    if d * m != world:
        raise SystemExit(f"--mesh {spec} needs {d * m} processes, {world} are running")
    return d, m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, help="an id of configs.registry, or its alias")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="auto", help="auto | DxM, e.g. 2x2 (under torchrun)")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card, cuda:LOCAL_RANK under torchrun)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = _device.resolve(None, args.device)
    owns_group = "WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ and not dist.is_initialized()
    if owns_group:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    d, m = mesh_shape(args.mesh, world)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    gen = torch.Generator(device=device).manual_seed(0)
    if dist.is_initialized():
        mesh = make_mesh((d, m), ("data", "model"), device.type)
        axes = shd.from_mesh(mesh)
        model = build_model(cfg, device="meta", axes=axes).distribute(mesh)
        model.init(gen)
        split = model.model_split({"tokens": torch.empty((args.batch, args.seq), device="meta")})
        how = {None: "none", True: "seq", False: "weights"}[split]
        where = f"mesh={shd.mesh_sizes(mesh)} ({world} processes, {device.type}) split={how}"
    else:
        model = build_model(cfg, device=device)
        model.init(gen)
        where = f"device={device}"
    if rank0:
        print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M {where}")

    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir)
    step = make_train_step(model, tcfg)
    pipe = pipeline_for(cfg, ShapeConfig("train", args.seq, args.batch, "train"))
    batches = lambda i: device_batch(pipe(i), device)   # noqa: E731
    state = LoopState(model=model, opt_state=adamw_init(model), step=0)
    t0 = time.perf_counter()
    state, report = train_loop(state, step, batches, tcfg, max_steps=args.steps)
    dt = time.perf_counter() - t0
    if rank0:
        print(f"\n{report.final_step} steps in {dt:.1f}s "
              f"({args.steps * args.seq * args.batch / dt:,.0f} tok/s); "
              f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}; "
              f"restarts={report.restarts} stragglers={report.stragglers}")
    if owns_group:
        dist.destroy_process_group()
    return state, report


if __name__ == "__main__":
    main()
