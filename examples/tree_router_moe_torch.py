"""The paper's technique on the LM serving hot path, on the PyTorch port:
tree-routed MoE.

Trains a small phi3.5-family MoE whose router is a SOFT decision tree
(differentiable), then serves it with the router HARDENED into the paper's
breadth-first branchless encoding and evaluated with speculative pointer
jumping (Procedure 4/5; on the card the K1 kernel in its one-hot form) —
per-token classification into E experts, exactly the paper's
image-segmentation problem shape transposed to tokens.

    PYTHONPATH=src python examples/tree_router_moe_torch.py --steps 60 [--device cpu]

Trains and serves on the card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.models.api import build_model
from repro_torch.models.layers import moe as moel
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import device_batch, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    args = ap.parse_args()
    dev = _device.resolve(None, args.device)

    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    if cfg.moe.router != "tree":
        raise SystemExit("the config's router is not a tree")
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"MoE: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, "
          f"router = depth-{cfg.moe.tree_depth()} soft decision tree; on {dev}")

    # --- train with the soft (differentiable) tree router ---
    pipe = pipeline_for(cfg, ShapeConfig("t", 64, 4, "train"))
    step = make_train_step(model, TrainConfig(lr=2e-3, warmup_steps=5, total_steps=args.steps))
    opt = adamw_init(model)
    first = last = None
    for i in range(args.steps):
        model, opt, metrics = step(model, opt, device_batch(pipe(i), dev))
        if i == 0:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
        if i % 20 == 0:
            print(f"  step {i:3d}  loss {last:.4f}  aux {float(metrics['aux']):.5f}")
    print(f"soft-tree training: loss {first:.3f} -> {last:.3f}")

    # --- serve: harden the tree, route with speculative evaluation ---
    batch = device_batch(pipe(999), dev)
    lp0 = model.layers[0].moe.params
    e_pad = lp0["wi"].shape[0]
    x = torch.randn((1, 512, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        experts_hard = moel.hard_tree_route(lp0, x, cfg=cfg, e_pad=e_pad)
        probs_soft = moel.router_probs(lp0, x, cfg=cfg, e_pad=e_pad)
        agree = float((probs_soft.argmax(-1) == experts_hard).float().mean())
        # NOTE: greedy hard descent equals the soft argmax only where gates
        # are saturated (σ far from 0.5); at temperature 1.0 mid-training some
        # tokens sit near decision boundaries.  As τ→0 agreement → 100 %.
        z = x @ lp0["router_proj"] - lp0["router_thr"]
        saturated = float(((torch.sigmoid(z) - 0.5).abs() > 0.4).float().mean())
    print(f"hardened speculative router vs soft argmax agreement: {agree:.1%} "
          f"(gates saturated: {saturated:.1%})")

    counts = np.bincount(experts_hard.cpu().numpy().ravel(), minlength=cfg.moe.n_experts)
    print(f"expert load (hard routing): {counts.tolist()}")

    # full serving forward with the hard router: the trained thresholds are
    # packed again first (a router packed before training refuses to route)
    model.pack_routers()
    with torch.no_grad():
        logits, _ = model(batch, serve_hard_tree=True)
    print(f"served logits: {tuple(logits.shape)}, finite={bool(torch.isfinite(logits).all())}")
    if not agree > 0.5:
        raise SystemExit("hardening should track the learned routing")
    if not len([c for c in counts if c > 0]) >= 2:
        raise SystemExit("router must use several experts")


if __name__ == "__main__":
    main()
