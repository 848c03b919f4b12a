"""Atomic, asynchronous checkpoints of the training state."""

from repro_torch.ckpt.checkpoint import AsyncSaver, latest_step, prune, restore, save

__all__ = ["AsyncSaver", "latest_step", "prune", "restore", "save"]
