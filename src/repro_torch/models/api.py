"""Model construction: one factory for every architecture.

The port's counterpart of the JAX package's ``models/api.py``.  Every
model class has the same protocol (:class:`repro_torch.models.schema.
SchemaModel`):

    schema() / init(generator) / cast_for_compute() / tree_routers()
    forward(batch) -> (logits, aux)
    loss(batch)    -> (loss, metrics)
    prefill(batch, max_len) -> (last_logits, cache)
    decode_step(cache, batch) -> (logits, cache)
    cache_shapes(batch, max_len) / init_cache(batch, max_len)

Family dispatch: ``audio`` → :class:`EncDecModel`, ``ssm`` →
:class:`XLSTMModel`, every other (dense / moe / hybrid / vlm) →
:class:`DecoderModel`.

A built model holds uninitialized f32 master weights on its device; fill
them with ``model.init(generator)`` or carry a JAX parameter tree across
with :func:`repro_torch.models.convert.load_jax_params`.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.lm import DecoderModel
from repro_torch.models.schema import SchemaModel
from repro_torch.models.xlstm_lm import XLSTMModel


def build_model(cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None) -> SchemaModel:
    """The model for ``cfg`` on ``device`` (default: the card, which raises
    without one; ``"meta"`` allocates nothing)."""
    if cfg.family == "audio":
        return EncDecModel(cfg, device=device, parallel=parallel)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device=device, parallel=parallel)
    return DecoderModel(cfg, device=device, parallel=parallel)
