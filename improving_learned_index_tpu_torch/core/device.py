"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and asking for CUDA on a machine without a CUDA device is an
error, never a silent move to the CPU (a CPU run measures PyTorch's CPU
kernels, not the system).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` for CUDA without a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def device_scope(device: torch.device):
    """``device`` as the current one while its work is launched (the kernels
    launch on the current device, and an event marks the current stream);
    nothing to do for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()
