"""One rank of ``test_perfbench_model.py``: the model cell at CPU-test size on
a 2x2 gloo mesh, each scenario one ``run_cell`` in the same process group.

A scenario is a sound run, a traced run, the control, or a fault planted
in the program underneath the harness on every rank, each on the layout
the port's planner gives phi3.5-moe at full size (:func:`full_size_layout`);
``planner_layout`` is a sound run on the layout it gives the smoke model.
Rank 0 writes each scenario's result line and info to ``results.json`` in
the test's temporary directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 9
SECONDS = 0.6


@contextlib.contextmanager
def planted(name: str):
    """The program broken as ``name`` says, on this rank, for the block."""
    from repro_torch.models import schema
    from repro_torch.models.layers import attention, moe
    from repro_torch.parallel import sharding

    saved = []

    def patch(owner, attr, make):
        real = getattr(owner, attr)
        saved.append((owner, attr, real))
        setattr(owner, attr, make(real))

    if name == "logit_perturbed":        # one column of every row's logits moved
        def bump(real):
            def gathered(self, logits, batch):
                out = real(self, logits, batch).clone()
                out[..., 3] += 1.0
                return out
            return gathered
        patch(schema.SchemaModel, "gathered_logits", bump)
    elif name == "short_answer":          # half of the rows' logits never come back
        patch(schema.SchemaModel, "gathered_logits",
              lambda real: lambda self, logits, batch: real(self, logits, batch)[: logits.shape[0] // 2])
    elif name == "route_swapped":         # every token sent to the next expert
        patch(moe.TreeRouter, "forward",
              lambda real: lambda self, x, proj: (real(self, x, proj) + 1) % self.cfg.moe.n_experts)
    elif name == "exchange_left_out":     # the sums over 'model' skipped
        patch(sharding, "model_sum", lambda real: lambda t, *a, **k: t)
    elif name == "state_unchanged":       # decode never writes its new K and V
        def stale(real):
            def decode(params, x, cache, pos, **kw):
                return real(params, x, attention.KVCache(cache.k.clone(), cache.v.clone()), pos, **kw)
            return decode
        patch(attention, "attention_decode", stale)
    try:
        yield
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


@contextlib.contextmanager
def full_size_layout():
    """The planner's layout of phi3.5-moe at full size (tensor parallel over
    'model', the weights split over 'data' too) for the smoke model, which
    its size rules would serve data-parallel and unsplit: the rules' limits
    lowered for the block."""
    from repro_torch.launch import specs

    saved = specs.TP_MIN_PARAMS, specs.serving_axes
    specs.TP_MIN_PARAMS = 0
    specs.serving_axes = lambda cfg, axes: axes
    try:
        yield
    finally:
        specs.TP_MIN_PARAMS, specs.serving_axes = saved


def run(rank: int, world: int, init: str, out: str, scenarios: list[str]) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    from perfbench import harness
    from perfbench import ranks as rk
    from perfbench.tests.conftest import kept_cell, small

    ranks = rk.join(rank, world, init, "cpu")
    results = {}
    try:
        for name in scenarios:
            cell = small(kept_cell("phi-moe-decode-2x2"))
            layout = full_size_layout()
            if name == "planner_layout":           # a 512-token MoE group a batch shard's prefill call
                layout = contextlib.nullcontext()
                cell.traffic.update(batch=16, prefill_rows=16)
            with layout, planted(name):
                result, info = harness.run_cell(ROOT, cell, seed=SEED, seconds=SECONDS, trace=name == "traced",
                                                device="cpu", t_start=time.perf_counter(),
                                                control=name == "control", ranks=ranks)
            results[name] = {"result": result, "info": info}
    finally:
        rk.leave()
    if rank == 0:
        Path(out, "results.json").write_text(json.dumps(results))
