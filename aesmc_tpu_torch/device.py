"""Where the port's entry points put their tensors when the caller does
not say.

The port runs on one NVIDIA card: every default is the card. There is no
quiet fallback to the CPU. Without a card a default raises, and a caller
who wants the CPU (the tests) passes ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device of every default: the current CUDA card."""
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a `torch.device`, or `default_device()` when None.

    Raises RuntimeError for a CUDA device when no card is present, rather
    than letting the caller's work continue on the CPU.
    """
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available, and the port's entry points default "
            "to the card; pass device='cpu' (or CPU tensors) to run on the "
            "CPU")
    return device
