"""Architecture registry: ``--arch <id>`` resolution for every entry point."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "yi-6b": "repro_torch.configs.yi_6b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen_7b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

# short aliases accepted by --arch
_ALIASES = {
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "granite-moe": "granite-moe-3b-a800m",
    "whisper": "whisper-medium",
    "yi": "yi-6b",
    "codeqwen": "codeqwen1.5-7b",
    "hymba": "hymba-1.5b",
    "qwen2-vl": "qwen2-vl-72b",
    "xlstm": "xlstm-125m",
}

ARCH_IDS = list(_MODULES)


def _resolve(name: str) -> str:
    name = name.strip()
    if name in _MODULES:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")


def get_config(name: str) -> ModelConfig:
    """Full (assigned) configuration for ``--arch <name>``."""
    mod = importlib.import_module(_MODULES[_resolve(name)])
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family configuration for CPU smoke tests."""
    mod = importlib.import_module(_MODULES[_resolve(name)])
    return mod.SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {k: get_config(k) for k in ARCH_IDS}
