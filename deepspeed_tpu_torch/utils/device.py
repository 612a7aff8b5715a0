"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any) -> torch.device:
    """The engine's device.  A CUDA device with no card raises: the port
    never drifts to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
