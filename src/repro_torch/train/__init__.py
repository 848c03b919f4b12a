"""The LM training path: the train step (loss → gradients → AdamW) and the
fault-tolerant loop around it."""

from repro_torch.train.loop import (
    LoopReport, LoopState, SimulatedFailure, StragglerWatchdog, ckpt_restartable_errors, resize_mesh, train_loop,
)
from repro_torch.train.step import device_batch, loss_and_grads, make_eval_step, make_loss_fn, make_train_step

__all__ = [
    "LoopReport", "LoopState", "SimulatedFailure", "StragglerWatchdog", "ckpt_restartable_errors",
    "device_batch", "loss_and_grads", "make_eval_step", "make_loss_fn", "make_train_step", "resize_mesh",
    "train_loop",
]
