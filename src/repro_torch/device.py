"""Device resolution for the port's entry points.

There is no fallback: the default is the card, and a missing card is an
error.  The CPU is a deliberate choice of the caller (the tests make it),
and the kernel wrappers pick their route from the tensor's device alone.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is visible; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU), so a host
    clock read after it measures the device's work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
