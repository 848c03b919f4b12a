"""Stand-in inputs and specs for every (arch × shape × step) cell of the dry-run.

The port's counterpart of the JAX package's ``launch/specs.py``, with its
names.  ``input_specs(cfg, shape)`` gives the batch a step consumes as
tensors that hold nothing (``meta`` by default; under a ``FakeTensorMode``
on the fake device, fake tensors) with the shapes and dtypes of JAX's
``ShapeDtypeStruct``s; ``batch_pspecs`` the matching specs (batch dims over
the batch axes that divide the global batch).

``plan_cell`` assembles one cell as JAX's does: the size-aware
parallelism policy (:func:`axes_for`), the model built on ``meta`` with the
policy's axes, the step function and the shapes and specs of its
arguments.  Train steps take (parameters, AdamW state, batch) with the
microbatch policy and ZeRO-1; prefill and decode take (parameters[,
cache], batch) on the serving model, whose weights are bf16
(:func:`serving_config`) and replicated over ``data`` where a card's TP
share is small (serving-FSDP off below 6e9 bytes a card).

The port's step functions take the model itself (its parameters are the
model's), so ``CellPlan.fn`` is ``fn(model, *rest)``; ``args`` and
``in_specs`` are the shapes and specs JAX's jitted function would be
lowered with, which ``launch.dryrun`` turns into fake tensors on a fake
mesh.  The cache of ``args`` is JAX's global one; the port's rank holds
its block of it (its batch rows, and where the step splits over ``model``
its KV heads or positions: ``DecoderModel.init_cache``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import adamw_state_shapes, adamw_state_specs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """The batch of one cell as empty tensors on ``device``: the shapes and
    dtypes of JAX's ``ShapeDtypeStruct``s (``tokens``/``labels``/``positions``
    int32, ``embeds`` f32)."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    out: dict[str, Any] = {}
    if cfg.family == "audio":
        out["embeds"] = empty((b, cfg.encoder.n_frames, cfg.d_model), torch.float32)
        out["tokens"] = empty((b, s), torch.int32)
    elif cfg.embeds_input:
        out["embeds"] = empty((b, s, cfg.d_model), torch.float32)
        out["positions"] = empty((b, 3, s), torch.int32)
    else:
        out["tokens"] = empty((b, s), torch.int32)
    if shape.kind == "train":
        out["labels"] = empty((b, s), torch.int32)
    if shape.kind == "decode" and cfg.family == "audio":
        # decode consumes tokens only; the encoder frames live in the cross cache
        out.pop("embeds", None)
    return out


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, axes: shd.MeshAxes) -> dict:
    ba = axes.batch_axes_for(shape.global_batch)
    return {k: P(ba, *([None] * (v.dim() - 1))) for k, v in input_specs(cfg, shape).items()}


@dataclasses.dataclass
class CellPlan:
    """Everything the dry-run needs to run one (arch × shape) cell."""

    step_name: str               # train_step | prefill_step | serve_step
    fn: Any                      # fn(model, *rest) → the step's outputs
    args: tuple                  # JAX's argument shapes: (params, opt | cache, batch)
    in_specs: tuple              # their specs
    model: Any                   # the model on meta with the policy's axes
    donate: tuple = ()
    tcfg: TrainConfig | None = None


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """bf16 weights for serving cells (no f32 master copies at inference):
    the model computes in them directly and needs no working copy."""
    return dataclasses.replace(cfg, param_dtype=cfg.dtype)


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` itself.  JAX's swaps bf16 for f16 because XLA's CPU backend
    does not lower bf16 well (same bytes); fake tensors keep bf16."""
    return cfg


TP_MIN_PARAMS = 1e9    # below this, TP shards are tiny and collectives
                       # dominate: run DP-only (model axis joins batch)


def axes_for(cfg: ModelConfig, axes: shd.MeshAxes) -> shd.MeshAxes:
    """The size-aware parallelism policy: data-parallel only (the model axis
    joins the batch axes) below ``TP_MIN_PARAMS`` parameters."""
    if cfg.n_params() < TP_MIN_PARAMS and axes.tp:
        return dataclasses.replace(axes, tp=False, batch=tuple(axes.batch) + (axes.model,))
    return axes


def microbatches_for(cfg: ModelConfig) -> int:
    """The microbatch policy of the train cells: gradient accumulation only
    where JAX needs it to fit (4 at ≥ 70e9 parameters, 2 at ≥ 60e9, else 1):
    every extra microbatch gathers the weights and reduces the gradients again."""
    n = cfg.n_params()
    return 4 if n >= 70e9 else (2 if n >= 60e9 else 1)


def serving_axes(cfg: ModelConfig, axes: shd.MeshAxes) -> shd.MeshAxes:
    """Serving-FSDP: the weights shard over 'data' too only where a card's
    bf16 share at the model axis's TP would exceed 6e9 bytes."""
    per_chip = cfg.n_params() * 2 / axes.model_size
    return dataclasses.replace(axes, fsdp=None) if per_chip < 6e9 else axes


def plan_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    axes: shd.MeshAxes,
    *,
    parallel: ParallelConfig | None = None,
    tcfg: TrainConfig | None = None,
) -> CellPlan:
    parallel = parallel or ParallelConfig()
    tcfg = tcfg or TrainConfig()
    axes = axes_for(cfg, axes)
    batch = input_specs(cfg, shape)
    bspecs = batch_pspecs(cfg, shape, axes)

    if shape.kind == "train":
        from repro_torch.train.step import make_train_step

        model = build_model(cfg, device="meta", parallel=parallel, axes=axes)
        if tcfg.microbatch == 0:
            tcfg = dataclasses.replace(tcfg, microbatch=microbatches_for(cfg))
        step = make_train_step(model, tcfg)
        pshapes = model.param_shapes()
        pspecs = model.param_specs()
        oshapes = adamw_state_shapes(pshapes)
        ospecs = adamw_state_specs(pspecs, pshapes, axes, zero1=parallel.zero1)
        return CellPlan(step_name="train_step", fn=step, args=(pshapes, oshapes, batch),
                        in_specs=(pspecs, ospecs, bspecs), model=model, donate=(0, 1), tcfg=tcfg)

    model = build_model(serving_config(cfg), device="meta", parallel=parallel, axes=serving_axes(cfg, axes))
    pshapes = model.param_shapes()
    pspecs = model.param_specs()

    if shape.kind == "prefill":
        def prefill_step(model, batch_):
            return model.prefill(batch_)

        return CellPlan(step_name="prefill_step", fn=prefill_step, args=(pshapes, batch),
                        in_specs=(pspecs, bspecs), model=model)

    # decode: one new token against a seq_len-deep cache
    def serve_step(model, cache, batch_):
        return model.decode_step(cache, batch_)

    return CellPlan(step_name="serve_step", fn=serve_step,
                    args=(pshapes, model.cache_shapes(shape.global_batch, shape.seq_len), batch),
                    in_specs=(pspecs, model.cache_specs(shape.global_batch), bspecs), model=model,
                    donate=(1,))


__all__ = ["CellPlan", "TP_MIN_PARAMS", "axes_for", "batch_pspecs", "dryrun_config", "input_specs",
           "microbatches_for", "plan_cell", "serving_axes", "serving_config"]
