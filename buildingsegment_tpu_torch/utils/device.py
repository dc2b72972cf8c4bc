"""Device handling of the port.

Callers name the device explicitly; nothing probes for a GPU or falls
back to the CPU (asking for "cuda" without a card fails in PyTorch).
Which code path runs is decided per tensor: a CUDA tensor goes to the
hand-written CUDA kernels, a CPU tensor to their plain PyTorch versions.
"""

from __future__ import annotations

import torch

__all__ = ["synchronize"]


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock around it measures the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
