"""Serving on the card: wave-batched tree classification with background
re-tuning, shadow profiling and a flight recorder."""

from repro_torch.serve.engine import (
    BackgroundRetuner,
    RetunePolicy,
    TreeEngineStats,
    TreeRequest,
    TreeServeEngine,
)

__all__ = [
    "BackgroundRetuner",
    "RetunePolicy",
    "TreeEngineStats",
    "TreeRequest",
    "TreeServeEngine",
]
