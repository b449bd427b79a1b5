"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  A
caller that wants the CPU (the tests, a reference run) says so with
``device="cpu"``.  There is no silent fallback: asking for CUDA on a
machine without a card raises :class:`NoCudaDeviceError`.
"""
from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """CUDA was asked for (explicitly or by default) but no card exists."""


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise :class:`NoCudaDeviceError` if absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
