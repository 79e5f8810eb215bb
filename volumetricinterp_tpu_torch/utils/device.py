"""Explicit device selection: nothing falls back to the CPU."""

from __future__ import annotations

import torch


def check_device(device):
    """torch.device(device); raises if it is a CUDA device and CUDA is
    unavailable."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run on the CPU")
    return device
