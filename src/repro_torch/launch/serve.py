"""Serving launcher: batched requests through the LM wave engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe \\
        --smoke --device cpu --requests 8 --new-tokens 16

The port's counterpart of ``python -m repro.launch.serve``, with the same
flags and printout, and ``--device`` (default: the card).  Weights are
random, drawn from a ``torch.Generator`` seeded 0 on the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="where to run (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embeds_input:
        raise SystemExit("vlm archs need precomputed embeddings; see examples/")
    if cfg.family == "audio":
        # as in the JAX package, whose engine passes only {"tokens"}: the
        # encoder-decoder's prefill needs frame embeddings too
        raise SystemExit(f"{cfg.name} is an encoder-decoder: ServeEngine passes only tokens, and its prefill "
                         "needs frame embeddings; drive model.prefill({'embeds', 'tokens'}) and decode_step "
                         "directly (ROADMAP.md §3 item 16)")
    device = _device.resolve(None, args.device)
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    print(f"serving {cfg.name}: {cfg.n_params()/1e6:.1f}M params"
          + (", tree-routed MoE (speculative hard routing)" if cfg.moe and cfg.moe.router == "tree" else ""))

    engine = ServeEngine(model, max_batch=args.max_batch,
                         max_len=args.prompt_len + args.new_tokens + 2,
                         temperature=args.temperature)
    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    engine.run(reqs, pad_to=args.prompt_len)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    s = engine.stats
    print(f"{len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({s.waves} waves; prefill {s.prefill_s:.2f}s, decode {s.decode_s:.2f}s, "
          f"{total / max(s.decode_s, 1e-9):,.0f} tok/s decode)")
    for r in reqs[:4]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}{'...' if len(r.out_tokens) > 10 else ''}")
    return reqs


if __name__ == "__main__":
    main()
