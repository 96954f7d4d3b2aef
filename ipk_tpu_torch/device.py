"""The device a build runs on.

A build runs on exactly one ``torch.device``, named by the caller and threaded
down from ``build(..., device=...)``. The default is ``"cuda"``. Asking for
CUDA where there is none raises: nothing falls back to the CPU, because a
CPU run measured as if it were the GPU's is a wrong number. The CPU runs only
when the caller names it (the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve", "synchronize", "DeviceLike"]

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device for ``device`` (default ``"cuda"``); raises when CUDA
    is named and unavailable, or when the device is neither CUDA nor CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is false; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work: the barrier for stage timings."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
