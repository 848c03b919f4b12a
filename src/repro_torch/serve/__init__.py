"""Serving on the card: wave-batched LM decoding (``ServeEngine``), and
wave-batched tree and forest classification with
background re-tuning, shadow profiling and a flight recorder; the forest
engine streams waves through the sharded executor or, under an
:class:`AnytimePolicy`, an early-exit cascade with a deadline."""

from repro_torch.serve.engine import (
    AnytimePolicy,
    BackgroundRetuner,
    EngineStats,
    ForestEngineStats,
    ForestServeEngine,
    Request,
    RetunePolicy,
    ServeEngine,
    TreeEngineStats,
    TreeRequest,
    TreeServeEngine,
)

__all__ = [
    "AnytimePolicy",
    "BackgroundRetuner",
    "EngineStats",
    "ForestEngineStats",
    "ForestServeEngine",
    "Request",
    "RetunePolicy",
    "ServeEngine",
    "TreeEngineStats",
    "TreeRequest",
    "TreeServeEngine",
]
