"""Device resolution for the port's entry points.

A caller that asks for CUDA gets CUDA or an error: nothing here drops to
the CPU on its own. The CPU is used only when the caller names it, and
the `meta` device (shapes and dtypes, no storage: `registry.param_specs`)
likewise.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is a CUDA device and
    no GPU is visible, or if it is none of CUDA, CPU and meta."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda', "
                         f"'cpu' or 'meta'")
    return dev
