"""Where an entry point of the port runs.

Every entry point takes ``device=None``.  A torch tensor runs where it lies;
anything else (numpy arrays, lists) goes to the card unless the caller names
a device.  With no card and no ``device="cpu"`` the call raises: the port
never moves work to the host behind the caller's back.  Under ``torchrun``
(one process per card) "the card" is the process's own,
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def default_card() -> str:
    """``"cuda"``, or ``"cuda:{LOCAL_RANK}"`` in a process that ``torchrun`` started."""
    rank = os.environ.get("LOCAL_RANK")
    return f"cuda:{int(rank)}" if rank is not None else "cuda"


def resolve(x, device=None) -> torch.device:
    """The device for input ``x``: ``device`` if given, else ``x``'s, else the card."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else default_card()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return device


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a contiguous ``dtype`` tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()
