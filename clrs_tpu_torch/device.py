"""Explicit device resolution for the port.

There is no platform gate that picks a route: every kernel wrapper decides
from the device of the tensors it is given (plain PyTorch for CPU tensors,
the CUDA kernel for CUDA tensors). This module only turns a user's
``device=`` argument into a ``torch.device`` and refuses a CUDA request
when no card is present, so nothing drifts silently to the CPU. The entry
points default to ``DEFAULT_DEVICE``, the card.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:1"`` or a ``torch.device`` -> device.

    Raises RuntimeError for a CUDA device when CUDA is unavailable, and
    ValueError for ``None`` or any other device type (the port computes on
    CPU and CUDA only)."""
    if device is None:
        raise ValueError("device=None: pass 'cuda' (the default of the "
                         "entry points) or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
