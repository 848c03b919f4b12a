"""Model construction: one factory for the ported architectures.

The port's counterpart of the JAX package's ``models/api.py``.  The
``dense``, ``moe`` and ``vlm`` families build a :class:`DecoderModel`;
``hybrid`` (SSM layers), ``audio`` (encoder-decoder) and ``ssm`` (xLSTM)
are not ported yet and raise.

A built model holds uninitialized f32 master weights on its device; fill
them with ``model.init(generator)`` or carry a JAX parameter tree across
with :func:`repro_torch.models.convert.load_jax_params`.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models.lm import DecoderModel


def build_model(cfg: ModelConfig, device=None, parallel: ParallelConfig | None = None) -> DecoderModel:
    """The model for ``cfg`` on ``device`` (default: the card; ``"meta"``
    allocates nothing).  Raises ``NotImplementedError`` for the families
    not ported yet."""
    return DecoderModel(cfg, device=device, parallel=parallel)
