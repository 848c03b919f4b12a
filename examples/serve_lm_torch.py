"""Serve a small model with batched requests through the wave engine, on
the PyTorch port.

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 6 --new-tokens 12 [--device cpu]

Serves on the card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    args = ap.parse_args()
    dev = _device.resolve(None, args.device)

    cfg = ModelConfig(name="serve-demo", family="dense", n_layers=4, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=1024,
                      dtype="float32")
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, max_batch=args.max_batch,
                         max_len=args.prompt_len + args.new_tokens + 2)

    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    engine.run(reqs, pad_to=args.prompt_len)
    for r in reqs:
        print(f"req {r.uid}: {r.out_tokens}")
    s = engine.stats
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"\n{s.waves} waves, {s.decode_steps} decode steps, "
          f"{total_new} tokens; prefill {s.prefill_s:.2f}s decode {s.decode_s:.2f}s "
          f"({total_new / max(s.decode_s, 1e-9):,.0f} tok/s decode) on {dev}")


if __name__ == "__main__":
    main()
