"""The four assigned input-shape cells (the port's copy of the JAX package's table).

``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the serving
prefill; ``decode_32k`` / ``long_500k`` lower ``serve_step`` (one new token
against a KV cache of ``seq_len``).  ``long_500k`` requires sub-quadratic
attention and only runs for the hybrid/ssm archs (skips recorded in
EXPERIMENTS.md per cell).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason).  long_500k is skipped for pure full-attention archs:
    a 524 288-token dense KV cache is architecturally quadratic (DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k dense KV cache is quadratic — skipped per assignment"
    return True, ""


def cells_for(cfg: ModelConfig):
    """Applicable (shape, skip-reason) cells for one arch, in canonical order."""
    out = []
    for name in SHAPE_ORDER:
        sh = SHAPES[name]
        ok, why = cell_applicable(cfg, sh)
        out.append((sh, ok, why))
    return out
