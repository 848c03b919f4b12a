"""Training launcher: the fault-tolerant loop over the synthetic pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe \\
        --smoke --device cpu --steps 50 --seq 128 --batch 4

The port's counterpart of ``python -m repro.launch.train``, with its flags
and printout, and ``--device`` (default: the card).  There is no
``--mesh``: the port's LM trains on one device.  ``--smoke`` selects the
reduced config; without it the assigned architecture trains at full size
(granite-moe-3b-a800m fits one 80 GB card with its AdamW state).  Weights
are random, drawn from a ``torch.Generator`` seeded 0 on the device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import _device
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.loop import LoopState, train_loop
from repro_torch.train.step import device_batch, make_train_step


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
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card); one device, so no --mesh")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = _device.resolve(None, args.device)
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    print(f"arch={cfg.name} params={cfg.n_params()/1e6:.1f}M device={device}")

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
    print(f"\n{report.final_step} steps in {dt:.1f}s "
          f"({args.steps * args.seq * args.batch / dt:,.0f} tok/s); "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}; "
          f"restarts={report.restarts} stragglers={report.stragglers}")
    return state, report


if __name__ == "__main__":
    main()
