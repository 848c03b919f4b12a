"""End to end on the PyTorch port: train a small LM for a few
hundred steps.

A scaled-down dense config (29.7M params at the default widths and full
vocab) through the real production path: config → model → data pipeline →
fault-tolerant train loop with async checkpointing.  Checkpoints go under
``--ckpt-dir`` (default ``repro_torch_train_lm`` in the temporary directory).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --d-model 256 [--device cpu]

Trains on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import pipeline_for
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.loop import LoopState, train_loop
from repro_torch.train.step import device_batch, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    args = ap.parse_args()
    dev = _device.resolve(None, args.device)

    cfg = ModelConfig(
        name="train-demo", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1), d_ff=args.d_model * 4,
        vocab_size=args.vocab, dtype="float32",
    )
    model = build_model(cfg, device=dev)
    print(f"model: {cfg.n_params()/1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab_size}) on {dev}")

    model.init(torch.Generator(device=dev).manual_seed(0))
    tcfg = TrainConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps,
                       ckpt_every=50, ckpt_dir=args.ckpt_dir)
    step = make_train_step(model, tcfg)
    pipe = pipeline_for(cfg, ShapeConfig("train", args.seq, args.batch, "train"))
    batches = lambda i: device_batch(pipe(i), dev)   # noqa: E731

    state = LoopState(model=model, opt_state=adamw_init(model), step=0)
    t0 = time.perf_counter()
    state, report = train_loop(state, step, batches, tcfg, max_steps=args.steps)
    dt = time.perf_counter() - t0
    tok_s = args.steps * args.seq * args.batch / dt
    print(f"\ntrained {report.final_step} steps in {dt:.1f}s ({tok_s:,.0f} tok/s)")
    print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"(stragglers flagged: {report.stragglers}, restarts: {report.restarts})")
    if not report.losses[-1] < report.losses[0]:
        raise SystemExit("loss should decrease")


if __name__ == "__main__":
    main()
