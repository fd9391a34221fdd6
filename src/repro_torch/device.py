"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``:
with no card present and no device asked for they raise, so a run never
quietly falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but no CUDA device "
                           "is available")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(array, device: torch.device) -> torch.Tensor:
    """A host (numpy) array as a tensor on ``device``.  On CUDA the copy is
    queued from pinned memory without waiting on the stream: a plain
    pageable upload would block the host until the stream's queued work
    (a decode macro-step in flight) had finished."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)
