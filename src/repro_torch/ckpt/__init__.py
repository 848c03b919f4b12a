"""Atomic, asynchronous checkpoints of the training state."""

from repro_torch.ckpt.checkpoint import AsyncSaver, agreed_latest_step, latest_step, prune, restore, save

__all__ = ["AsyncSaver", "agreed_latest_step", "latest_step", "prune", "restore", "save"]
