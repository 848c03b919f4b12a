"""Model configurations: the dataclasses (``base``) and the ten assigned
architectures with their smoke-size twins (``registry``)."""

from repro_torch.configs.base import (
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config, get_smoke_config

__all__ = [
    "ARCH_IDS",
    "EncoderConfig",
    "ModelConfig",
    "MoEConfig",
    "ParallelConfig",
    "SSMConfig",
    "ShapeConfig",
    "TrainConfig",
    "XLSTMConfig",
    "all_configs",
    "get_config",
    "get_smoke_config",
]
