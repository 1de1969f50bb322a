"""The port's device rule, in one place.

Every entry point of the port runs on the card unless its caller names
another device. Without a device and without a CUDA device to run on, an
entry point raises; it never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA card.

    Raises ``RuntimeError`` for ``None`` when no CUDA device exists: a caller
    that wants the CPU asks for it with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
