"""Device resolution for the port's entry points.

A caller that asks for CUDA gets CUDA or an error: nothing here drops to
the CPU on its own. The CPU is used only when the caller names it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is a CUDA device and
    no GPU is visible, or if it is neither CUDA nor CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
