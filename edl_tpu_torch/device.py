"""Device selection for the port's entry points: the CUDA device unless the
caller asks for another, and no quiet fall-back to the CPU."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no CUDA device exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
