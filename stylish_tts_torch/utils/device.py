"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The torch device to run on. Entry points run on ``cuda`` unless the
    caller asks for ``cpu``; asking for CUDA where there is none raises
    instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
